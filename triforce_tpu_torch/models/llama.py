"""Llama forward passes over explicit caches — the port of
``triforce_tpu/models/llama.py``.

Parameters are a plain dict of tensors with the JAX package's layout
(stacked ``[L, ...]`` per-layer weights, ``x @ w`` orientation), and the
forwards are plain functions on tensors. Where JAX scans the layers and
commits the new K/V with one donated ``dynamic_update_slice``, these
forwards loop over layers in Python and write each layer's new K/V into the
cache IN PLACE right after that layer's attention (which reads only slots
``< k_len``, so the write cannot change what it sees). The returned cache
objects share their buffers with the ones passed in.

Weights may be INT8 (``quantize_weights``): each matmul weight is then int8
codes ``[.., in, out]`` beside an fp32 per-output-channel ``<name>_scale``;
``_wmm`` converts the codes to the activation dtype and scales the output.
With ``aq`` (``act_quant`` on the forwards that take it: the
middle verify under ``SpecConfig.mid_act_quant``, the tree grow) an int8
weight meets int8 ACTIVATIONS: ``_wmm`` quantizes x per token and runs an
exact integer product (``_int_matmul``).
Caches may be INT8 (``cache.init_kv(quant=True)``): the forwards quantize
the new K/V per token as they commit them and hand the scales to the
attention.

Each layer's glue between the products (residual add + RMSNorm, RoPE on q
and k, SiLU(gate) * up) goes through ``ops/layer_glue.py``: three kernels
on the card, the plain PyTorch chain on the CPU.

Forward modes:
  forward_append      — prefill chunks / AR decode / full-cache target
                        verify, optionally building the retrieval cache on
                        a 1-token forward, or verifying a speculation
                        tree under its ancestor mask
  forward_spec        — middle-model verify over the retrieval cache
  forward_tree_spec   — middle-model grow step over the tree retrieval
                        cache (one frontier of the speculation tree)
  draft_forward       — drafter prefill into the StreamingLLM cache
  draft_forward_spec  — drafter speculation at the fixed spec slots with
                        un-rotated key storage + whole-window re-rotation

Over a mesh (``mesh=``, ``parallel/mesh.py``; every target forward)
every rank runs the same forward on its own shards
(``parallel/sharding.py``): its heads, its MLP columns and its slice of the
vocabulary. The row-parallel products (``wo``, ``w_down``) are summed over
``tp`` with one ``all_reduce`` each, the vocabulary-split logits gathered
with a zero-padded ``all_reduce``, and with ``aq`` the per-token maximum of
a row-parallel input is taken over ``tp`` first, as GSPMD reduces it over
the whole row in the JAX package. Attention goes through
``ops/sp_attention.append_attention_sharded``; with ``shard_seq`` the full
cache's slots are split over ``sp`` and each rank commits only the slots it
owns. The tree grow's layers over the tree retrieval cache (split by heads
alone) keep their meshless decomposition on the rank's heads; its
self-speculation layers over a split full cache take the partials kernel
over each rank's part of the visible prefix, merged over ``sp``, then the
staged tree window read across the shards. The rows forwards over a split
full cache merge each row's partials over ``sp``
(``append_attention_rows_sharded``).

``forward_append_rows``, ``forward_spec_rows`` and ``draft_forward_spec_rows``
are the same forwards for B rows in ONE pass over the weights, over
row-stacked caches (``[B, L, Hkv, S, D]``, ``seq_len`` [B]; see
``cache.py``): ids [B, T], RoPE at each row's own positions, attention
through ``append_attention_rows`` (the row-batched kernel on the card). They
stand where the JAX package vmaps its batch-1 forwards. The target ones do
not commit: they return the new K/V of every layer, which
``cache.batched_commit_and_refresh`` writes at each row's own length.

Hybrid models (``config.HybridConfig``: sliding-window layers beside full
ones, sparse MLPs) run through ``forward_append`` and ``forward_spec``,
the layer loop taking each layer's kinds from ``cfg.plan`` (resolved
once a configuration). A sliding layer rotates with the local RoPE
tables, attends its ring in the full cache (``KVCache.ring_k``) through
the window kernel and commits its new K/V there at ``(L + j) mod R``; in
the middle verify it reads the target's ring (``forward_spec(ring=)``)
and commits nothing. A full layer reads and writes its plane of the full
cache and of the retrieval cache (its index among the full layers). A
sparse MLP is ``ops/moe.py``. The rows forwards, the tree grow, int8
weights and the mesh take plain models only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..cache import (KVCache, RetrievalCache, StreamingCache, dequantize,
                     device_scalar, int8_scale, quantize_tokens, ring_index,
                     slice_at, slice_sharded, window, write_window_sharded)
from ..config import SLIDING, ModelConfig, SpecConfig, refuse_hybrid
from ..ops import layer_glue
from ..ops import moe
from ..ops import retrieval as retrieval_ops
from ..ops.attention import (append_attention, append_attention_auto,
                             append_attention_rows, attention_partials_auto,
                             finalize, merge_partials, new_block_partials)
from ..ops.sp_attention import (append_attention_rows_sharded,
                                append_attention_sharded,
                                prefix_partials_sharded)
from ..parallel import sharding
from . import rope

_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_LAYER_KEYS = _MATMUL_KEYS + ("ln_attn", "ln_mlp")


def _region(name: str, device):
    from .. import profiling      # profiling imports this module
    return profiling.device_region(name, device)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, *, device, dtype=torch.bfloat16,
                seed: int = 0, shardings=None):
    """Random-init params (normal * 0.02, norms 1) made on ``device`` from
    ``seed``, one layer at a time so no full-size fp32 copy exists.
    ``shardings`` (``parallel.sharding.param_shardings``): keep only this
    rank's slice of each leaf, cut from the same full draws, so a rank
    holds exactly its shard of the unsharded init and at most one full
    layer more."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h, i, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    hq = cfg.num_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim
    if cfg.moe or cfg.windowed:
        if shardings is not None:
            refuse_hybrid(cfg, "sharding")
        return _init_hybrid(cfg, gen, device, dtype)

    def cut(x, name, stacked=False):
        if shardings is None:
            return x
        if stacked:    # one layer of the stacked weight
            sh = sharding.lookup(shardings, "layers." + name).row()
        else:
            sh = sharding.lookup(shardings, name)
        return sh.take(x).contiguous()

    def rnd(shape):
        return (torch.randn(shape, generator=gen, device=device)
                * 0.02).to(dtype)

    def stacked(name, shape):
        out = None
        for li in range(L):
            x = cut(rnd(shape), name, True)
            if out is None:
                out = torch.empty((L,) + tuple(x.shape), dtype=dtype,
                                  device=device)
            out[li] = x
        return out

    params = {
        "embed": cut(rnd((cfg.vocab_size, h)), "embed"),
        "layers": {
            "wq": stacked("wq", (h, hq)),
            "wk": stacked("wk", (h, hkv)),
            "wv": stacked("wv", (h, hkv)),
            "wo": stacked("wo", (hq, h)),
            "w_gate": stacked("w_gate", (h, i)),
            "w_up": stacked("w_up", (h, i)),
            "w_down": stacked("w_down", (i, h)),
            "ln_attn": torch.ones((L, h), dtype=dtype, device=device),
            "ln_mlp": torch.ones((L, h), dtype=dtype, device=device),
        },
        "final_norm": torch.ones((h,), dtype=dtype, device=device),
    }
    if cfg.tie_word_embeddings:
        params["lm_head"] = cut(params["embed"].T, "lm_head")
    else:
        params["lm_head"] = cut(rnd((h, cfg.vocab_size)), "lm_head")
    return params


def _init_hybrid(cfg: ModelConfig, gen, device, dtype):
    """``init_params`` of a hybrid model: attention, norms and the MLP
    stacked over every layer, the MLP an expert layer's (``ops/moe.py``'s
    layout) in a model with experts."""
    h, d, n = cfg.hidden_size, cfg.head_dim, cfg.num_layers

    def rnd(*shape):
        return (torch.randn(shape, generator=gen, device=device)
                * 0.02).to(dtype)

    layers = {"wq": rnd(n, h, cfg.num_heads * d),
              "wk": rnd(n, h, cfg.num_kv_heads * d),
              "wv": rnd(n, h, cfg.num_kv_heads * d),
              "wo": rnd(n, cfg.num_heads * d, h),
              "ln_attn": torch.ones((n, h), dtype=dtype, device=device),
              "ln_mlp": torch.ones((n, h), dtype=dtype, device=device)}
    if cfg.moe:
        e, i = cfg.num_experts, cfg.moe_intermediate_size
        layers.update(w_router=rnd(n, e, h), w_gate_e=rnd(n, e, i, h),
                      w_up_e=rnd(n, e, i, h), w_down_e=rnd(n, e, h, i))
    else:
        i = cfg.intermediate_size
        layers.update(w_gate=rnd(n, h, i), w_up=rnd(n, h, i),
                      w_down=rnd(n, i, h))
    return {"embed": rnd(cfg.vocab_size, h), "layers": layers,
            "final_norm": torch.ones((h,), dtype=dtype, device=device),
            "lm_head": rnd(h, cfg.vocab_size)}


def _to_torch(a, device, dtype) -> torch.Tensor:
    """A numpy array -> a tensor of ``dtype``; int8 codes stay int8 and
    ``_scale`` planes (float32) stay float32."""
    a = np.asarray(a)
    if a.dtype == np.int8:
        dtype = torch.int8
    elif a.dtype.name == "bfloat16":   # ml_dtypes bf16: widen exactly
        a = a.astype(np.float32)
    return torch.tensor(a).to(device=device, dtype=dtype)   # copies


def params_from_numpy(tree, cfg: ModelConfig, device, dtype=torch.float32):
    """The JAX params pytree as numpy arrays (``jax.tree.map(np.asarray,
    params)``) -> this package's params. Both packages keep the same layout
    (stacked [L, in, out] weights used as ``x @ w``), so this only converts
    arrays; any layout change would happen here and nowhere else. int8
    weights (``quantize_weights``) keep their codes and their fp32
    ``_scale`` planes."""
    layers = tree["layers"]
    scales = [k + "_scale" for k in _MATMUL_KEYS]
    missing = [k for k in _LAYER_KEYS if k not in layers]
    unknown = [k for k in layers if k not in _LAYER_KEYS + tuple(scales)]
    if missing or unknown:
        raise ValueError(f"expected layer weights {_LAYER_KEYS} (+ int8 "
                         f"scales); missing {missing}, unknown {unknown}")
    if np.asarray(layers["wq"]).shape[0] != cfg.num_layers:
        raise ValueError("params do not match the config's layer count")

    def conv(name, a):
        return _to_torch(a, device, torch.float32 if name.endswith("_scale")
                         else dtype)

    out = {k: conv(k, tree[k]) for k in ("embed", "final_norm", "lm_head")}
    out["layers"] = {k: conv(k, v) for k, v in layers.items()}
    if "lm_head_scale" in tree:
        out["lm_head_scale"] = conv("lm_head_scale", tree["lm_head_scale"])
    return out


def quantize_weights(params, mesh=None, cfg: Optional[ModelConfig] = None):
    """Symmetric per-output-channel INT8 quantization of every matmul
    weight, layers and lm_head (``llama.py:167-188``): scale = max|w| / 127
    over the input axis (at least 1e-8), codes rounded half to even. The
    embedding and the norms stay as they are. One layer at a time, so no
    fp32 copy of a whole stacked weight exists. Params that already hold
    int8 codes (a native checkpoint saved after quantization) are
    returned as they are.

    ``mesh`` (with ``cfg``): ``params`` are this rank's shards; a
    row-parallel weight's maximum is taken over ``tp`` (its input axis is
    split), so every rank holds the slice of what quantizing the whole
    weights gives."""
    if params["lm_head"].dtype == torch.int8:
        return params
    if cfg is not None:
        refuse_hybrid(cfg, "int8 weights")
    if "w_router" in params["layers"]:
        raise NotImplementedError("int8 weights are not implemented for "
                                  "expert layers")
    rows = ()
    if mesh is not None:
        sh = sharding.param_shardings(mesh, cfg)["layers"]
        rows = tuple(n for n in ("wo", "w_down") if sharding.is_split(sh[n]))

    def q(w, row=False):
        wf = w.float()
        amax = wf.abs().amax(-2)
        if row:
            mesh.all_reduce(amax, "tp", "max")
        s = int8_scale(amax, 1e-8)
        codes = torch.round(wf / s[..., None, :]).clamp(-127, 127)
        return codes.to(torch.int8), s

    def q_stacked(w, row):
        codes = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        s = torch.empty((w.shape[0], w.shape[-1]), dtype=torch.float32,
                        device=w.device)
        for li in range(w.shape[0]):
            codes[li], s[li] = q(w[li], row)
        return codes, s

    layers = dict(params["layers"])
    for name in _MATMUL_KEYS:
        layers[name], layers[name + "_scale"] = q_stacked(layers[name],
                                                          name in rows)
    new = dict(params, layers=layers)
    new["lm_head"], new["lm_head_scale"] = q(params["lm_head"])
    return new


def dequant_weights(params, dtype=torch.bfloat16):
    """Exact pre-conversion of int8 matmul weights to ``dtype``
    (``llama.py:191-211``): the codes convert losslessly and the ``_scale``
    planes stay, still applied on the outputs by ``_wmm``, so forwards over
    the result are bit-identical to the int8 path. Other weights pass
    through unchanged."""
    def conv(w):
        return w.to(dtype) if w.dtype == torch.int8 else w
    new = dict(params)
    new["layers"] = {k: conv(v) for k, v in params["layers"].items()}
    new["lm_head"] = conv(params["lm_head"])
    return new


def _layer(params, li: int):
    return {k: v[li] for k, v in params["layers"].items()}


def _mlp_of(cfg: ModelConfig, li: int, h, lp, aq: bool = False, tp=None):
    """Layer ``li``'s MLP: the sparse layer of ``ops/moe.py`` (a ``moe``
    region) in a model with experts, else the dense SwiGLU."""
    if cfg.moe:
        with _region("moe", h.device):
            return moe.moe_mlp(h, lp, cfg.num_experts_per_tok,
                               cfg.norm_topk_prob)
    return _mlp(h, lp, aq=aq, tp=tp)


def _ring_attention(cfg: ModelConfig, q, k_new, v_new, ring: KVCache,
                    si: int, k_len, positions, commit_idx=None):
    """A sliding layer: q and k rotated with the local tables, attention
    over ring ``si`` of ``ring`` (the sequence ``k_len`` long) and the new
    block through the window kernel, and, with ``commit_idx``, the new K/V
    written at those ring slots. A ``window_attn`` region."""
    with _region("window_attn", q.device):
        cos, sin = rope.cos_sin_tables(cfg, device=q.device, local=True)
        q, k_new = layer_glue.rope((q, k_new), cos, sin, positions)
        ctx = append_attention_auto(q, ring.ring_k[si], ring.ring_v[si],
                                    k_new, v_new, k_len=k_len,
                                    window=cfg.sliding_window)
        if commit_idx is not None:
            ring.ring_k[si].index_copy_(2, commit_idx, k_new)
            ring.ring_v[si].index_copy_(2, commit_idx, v_new)
    return ctx


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _add_norm(x, y, w, cfg: ModelConfig):
    """The residual ``x + y`` (y None: x) and its RMSNorm with gain w, as
    one kernel on the card (``ops/layer_glue.add_rms_norm``). The layer
    loops carry each MLP output as y into the next layer's first norm (or
    into ``_logits``'s final norm), so each add rides with a norm."""
    return layer_glue.add_rms_norm(x, y, w, cfg.rms_norm_eps)


def _int_matmul(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product of codes x8 [..., K] and w8
    [K, N]. The sums pass 2^24 at model widths (127 * 127 * 4096), so fp32
    would not be exact. On the card this is the library's integer GEMM
    (``torch._int_mm``: a plain large matrix product, as the JAX package
    leaves it to XLA), which wants more than 16 rows and K, N in multiples
    of 8: the rows are zero-padded to a multiple of 32. On the CPU it is an
    int32 matmul."""
    lead, k = x8.shape[:-1], x8.shape[-1]
    x2 = x8.reshape(-1, k)
    if x8.device.type == "cpu":
        out = torch.matmul(x2.to(torch.int32), w8.to(torch.int32))
    else:
        if k % 8 or w8.shape[1] % 8:
            raise ValueError(f"int8 x int8 product needs sizes in multiples "
                             f"of 8, got {tuple(x2.shape)} x "
                             f"{tuple(w8.shape)}")
        rows = x2.shape[0]
        pad = -rows % 32
        if pad:
            x2 = F.pad(x2, (0, 0, 0, pad))
        out = torch._int_mm(x2.contiguous(), w8)[:rows]
    return out.reshape(lead + (w8.shape[1],))


def _wmm(x: torch.Tensor, p, name: str, out_dtype=None,
         aq: bool = False, tp=None) -> torch.Tensor:
    """Weight matmul ``x @ p[name]`` in the model dtype (bf16 or fp32); the
    GEMM accumulates in fp32. The weights stay ``torch.matmul``, as the JAX
    package leaves them to XLA. int8 weights (``llama.py:127-132``) are
    converted to x's dtype first (exactly) and, when ``p`` holds
    ``<name>_scale`` (also after ``dequant_weights``), the per-channel scale
    multiplies the output in the output dtype: x's, or ``out_dtype``.

    ``aq`` with an int8 weight (``llama.py:116-126``): x is quantized per
    token (scale ``max(max|x|, 1e-6) / 127``, codes rounded half to even),
    the product runs on the integer codes (``_int_matmul``, exact) and the
    fp32 result is multiplied by the token scale, then the channel scale.
    Activation rounding shifts the output slightly, so this is for
    proposal forwards (tree grow, the middle verify on request); a weight
    that is not int8 ignores ``aq``.

    ``tp``: the mesh of a row-parallel weight (its input axis split over
    ``tp``): the product is summed over ``tp`` before the channel scale,
    and with ``aq`` the token maximum is taken over ``tp`` and the integer
    product summed exactly in int32."""
    w = p[name]
    scale = p.get(name + "_scale")
    if w.dtype == torch.int8 and aq:
        xf = x.float()
        amax = xf.abs().amax(-1, keepdim=True).clamp_min(1e-6)
        if tp is not None:
            tp.all_reduce(amax, "tp", "max")
        s_x = amax / torch.full_like(amax, 127.0)     # IEEE division
        x8 = torch.round(xf / s_x).clamp(-127, 127).to(torch.int8)
        acc = _int_matmul(x8, w)
        if tp is not None:
            acc = tp.all_reduce(acc.contiguous(), "tp")
        out = acc.float() * s_x
        if scale is not None:
            out = out * scale
        return out.to(out_dtype if out_dtype is not None else x.dtype)
    if w.dtype == torch.int8:
        w = w.to(x.dtype)
    out = torch.matmul(x, w)
    if out_dtype is not None:
        out = out.to(out_dtype)
    if tp is not None:
        out = tp.all_reduce(out.contiguous(), "tp")
    if scale is not None:
        out = out * scale.to(out.dtype)
    return out


def _mlp(x, lp, aq: bool = False, tp=None):
    gate = _wmm(x, lp, "w_gate", aq=aq)
    up = _wmm(x, lp, "w_up", aq=aq)
    return _wmm(layer_glue.silu_mul(gate, up), lp, "w_down", aq=aq, tp=tp)


def _qkv(x, lp, cfg: ModelConfig, aq: bool = False):
    """Q, K, V [B, H, T, D] with the head counts of the weights given
    (a rank's own heads over a mesh)."""
    b, t, _ = x.shape
    d = cfg.head_dim
    q = _wmm(x, lp, "wq", aq=aq).reshape(b, t, -1, d).transpose(1, 2)
    k = _wmm(x, lp, "wk", aq=aq).reshape(b, t, -1, d).transpose(1, 2)
    v = _wmm(x, lp, "wv", aq=aq).reshape(b, t, -1, d).transpose(1, 2)
    return q, k, v  # [B, H, T, D]


def _attn_out(ctx, lp, aq: bool = False, tp=None):
    b, hq, t, d = ctx.shape
    return _wmm(ctx.transpose(1, 2).reshape(b, t, hq * d), lp, "wo", aq=aq,
                tp=tp)


def _logits(cfg: ModelConfig, params, x, y=None, aq: bool = False,
            vocab_mesh=None) -> torch.Tensor:
    """fp32 logits of the hidden state ``x + y`` (the last layer's
    residual, added here with the final norm). In bf16 the GEMM output is
    rounded to bf16 before the cast (the reference's
    ``lm_head(h).float()``); the JAX package keeps the fp32 accumulator
    instead. An int8 lm_head's scale multiplies the fp32 logits, as in the
    JAX package. ``vocab_mesh``: the lm_head is split
    over the vocabulary on that mesh's ``tp`` axis, and the logits are
    gathered (``gather_vocab``)."""
    _, h = _add_norm(x, y, params["final_norm"], cfg)
    out = _wmm(h, params, "lm_head", out_dtype=torch.float32, aq=aq)
    if vocab_mesh is not None:
        out = gather_vocab(out, vocab_mesh, cfg.vocab_size)
    return out


def gather_vocab(logits: torch.Tensor, mesh, vocab: int) -> torch.Tensor:
    """This rank's slice of the vocabulary [..., V / tp] -> the whole
    [..., V]: each rank writes its slice into zeros and one
    ``all_reduce(SUM)`` over ``tp`` adds them (adding zeros is exact; gloo
    on CUDA tensors has no ``all_gather``)."""
    n = logits.shape[-1]
    full = logits.new_zeros(logits.shape[:-1] + (vocab,))
    i = mesh.index("tp")
    full[..., i * n:(i + 1) * n] = logits
    return mesh.all_reduce(full, "tp")


@dataclasses.dataclass(frozen=True)
class _Par:
    """What a forward over a mesh reads of it: the mesh, and the mesh again
    for each row-parallel product and for the vocabulary gather (None
    where the sharding rules keep that weight whole)."""
    mesh: object
    wo: object
    w_down: object
    vocab: object


def _par(mesh, cfg: ModelConfig) -> Optional[_Par]:
    if mesh is None:
        return None
    sh = sharding.param_shardings(mesh, cfg)

    def on(s):
        return mesh if sharding.is_split(s) else None
    return _Par(mesh, on(sh["layers"]["wo"]), on(sh["layers"]["w_down"]),
                on(sh["lm_head"]))


def _embed(params, input_ids):
    return F.embedding(input_ids, params["embed"])


def _positions(start, t: int, device) -> torch.Tensor:
    """``start + arange(t)``: filled on the device for a host int start,
    added on the device to a tensor one (capturable either way)."""
    if not torch.is_tensor(start):
        return torch.arange(int(start), int(start) + t, device=device)
    return start.to(device=device, dtype=torch.int64) \
        + torch.arange(t, device=device)


def _commit_layer(cache, li: int, idx, k_new, v_new) -> None:
    """Write one layer's new K/V [B, H, T, D] at slots ``idx`` of a target
    cache, in place; an int8 cache stores their per-token codes and scales
    (``llama.py:223-235``)."""
    if cache.quantized:
        k_new, ks = quantize_tokens(k_new)
        v_new, vs = quantize_tokens(v_new)
        cache.k_scale[li].index_copy_(2, idx, ks)
        cache.v_scale[li].index_copy_(2, idx, vs)
    cache.k[li].index_copy_(2, idx, k_new)
    cache.v[li].index_copy_(2, idx, v_new)


def _commit_layer_sharded(cache, li: int, start, k_new, v_new, mesh) -> None:
    """``_commit_layer`` into a cache whose slots are split over ``sp``:
    the T new tokens belong at global slots ``start ..`` (clamped into the
    global cache as JAX clamps), and this rank writes the ones it owns
    (``cache.write_window_sharded``); a window may straddle two shards."""
    if cache.quantized:
        k_new, ks = quantize_tokens(k_new)
        v_new, vs = quantize_tokens(v_new)
        write_window_sharded(cache.k_scale[li], ks, start, mesh, 2)
        write_window_sharded(cache.v_scale[li], vs, start, mesh, 2)
    write_window_sharded(cache.k[li], k_new, start, mesh, 2)
    write_window_sharded(cache.v[li], v_new, start, mesh, 2)


def _layer_attention(q, cache, li: int, k_new, v_new, k_len, new_mask=None,
                     par: Optional[_Par] = None, shard_seq: bool = False):
    """``append_attention_auto`` over layer ``li`` of a target cache; over
    a mesh, ``append_attention_sharded`` over the whole stacked local cache
    at layer ``li`` (its slots split over ``sp`` with ``shard_seq``)."""
    quant = cache.quantized
    if par is not None:
        return append_attention_sharded(
            par.mesh, q, cache.k, cache.v, k_new, v_new, k_len=k_len,
            new_mask=new_mask, k_scale=cache.k_scale if quant else None,
            v_scale=cache.v_scale if quant else None, shard_seq=shard_seq,
            layer=li)
    return append_attention_auto(
        q, cache.k[li], cache.v[li], k_new, v_new, k_len=k_len,
        new_mask=new_mask,
        k_scale=cache.k_scale[li] if quant else None,
        v_scale=cache.v_scale[li] if quant else None)


# ---------------------------------------------------------------------------
# Target-model forwards
# ---------------------------------------------------------------------------

def forward_append(cfg: ModelConfig, params, input_ids: torch.Tensor,
                   kv: KVCache, *, positions=None,
                   build_rkv: Optional[RetrievalCache] = None,
                   prefill: int = 0, chunk_size: int = 8, budget: int = 0,
                   tree_mask=None, need_logits: bool = True, mesh=None,
                   shard_seq: bool = False,
                   ) -> Tuple[Optional[torch.Tensor], KVCache,
                              Optional[RetrievalCache]]:
    """Append ``T`` tokens to the full cache (in place) and attend causally
    over it. Returns (logits [B, T, V] fp32 or None, kv with ``seq_len``
    advanced by T, retrieval cache or None).

    With ``build_rkv`` (T must be 1) every layer's retrieval budget region
    is also built, in place, from this token's query (the chunk scoring
    runs through ``ops/retrieval_kernel.py``). ``need_logits=False`` skips
    the lm_head projection (prefill chunks).

    ``mesh``: every tensor is this rank's shard (module docstring); with
    ``shard_seq`` the full cache's slots are split over ``sp``, ``kv``
    holds this rank's ``S / sp`` of them and ``kv.seq_len`` stays global.

    With ``tree_mask`` ([T, T] bool ancestor matrix) the T appended tokens
    are a speculation tree: token i attends the committed prefix plus its
    tree ancestors, and ``positions`` [T] must be the node depths offset by
    ``seq_len``. The tokens still land at slots ``seq_len + i``."""
    b, t = input_ids.shape
    building = build_rkv is not None
    if building and t != 1:
        raise ValueError("retrieval build requires a 1-token forward")
    if cfg.rope_on_slots:
        raise ValueError("a rope_on_slots drafter runs draft_forward")
    plan = cfg.plan
    if cfg.windowed:
        if mesh is not None or tree_mask is not None:
            refuse_hybrid(cfg, "the mesh and the tree verify")
        if t > kv.ring_slots - cfg.sliding_window:
            raise ValueError(f"a forward of {t} tokens overwrites ring "
                             f"slots its window still sees (ring "
                             f"{kv.ring_slots}, window {cfg.sliding_window})")
    dev = input_ids.device
    cos, sin = rope.cos_sin_tables(cfg, device=dev)
    seq_len0 = kv.seq_len
    if positions is None:
        positions = _positions(seq_len0, t, dev)
    else:
        positions = torch.as_tensor(positions, device=dev).to(torch.int64)
    new_mask = None if tree_mask is None else torch.as_tensor(
        tree_mask, device=dev).to(torch.bool)
    par = _par(mesh, cfg)
    split_seq = par is not None and shard_seq
    if not split_seq:
        commit_idx = window(seq_len0, t, kv.max_len, dev)  # clamped, like JAX
    if cfg.windowed:
        ring_idx = ring_index(seq_len0, t, kv.ring_slots, dev)

    x, y = _embed(params, input_ids), None
    qs = []
    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        x, h = _add_norm(x, y, lp["ln_attn"], cfg)
        q, k_new, v_new = _qkv(h, lp, cfg)
        fi = plan.slot[li]           # the layer's plane among its kind's
        if plan.attn[li] == SLIDING:
            ctx = _ring_attention(cfg, q, k_new, v_new, kv, fi, seq_len0,
                                  positions, ring_idx)
        else:
            # keys stored rotated
            q, k_new = layer_glue.rope((q, k_new), cos, sin, positions)
            ctx = _layer_attention(q, kv, fi, k_new, v_new, seq_len0,
                                   new_mask, par, split_seq)
            if split_seq:
                _commit_layer_sharded(kv, fi, seq_len0, k_new, v_new, mesh)
            else:
                _commit_layer(kv, fi, commit_idx, k_new, v_new)
            if building:
                qs.append(q)
        x, h = _add_norm(x, _attn_out(ctx, lp, tp=par and par.wo),
                         lp["ln_mlp"], cfg)
        y = _mlp_of(cfg, li, h, lp, tp=par and par.w_down)

    kv_out = dataclasses.replace(kv, seq_len=seq_len0 + t)
    logits = _logits(cfg, params, x, y, vocab_mesh=par and par.vocab) \
        if need_logits else None

    if building:
        quant = kv.quantized
        if build_rkv.quantized != quant:
            raise ValueError("the retrieval cache and the full cache must "
                             "both be int8 or neither")
        planes = ("k", "v", "k_scale", "v_scale") if quant else ("k", "v")
        for fi in range(len(plan.full)):       # the full layers only
            sel = retrieval_ops.build_layer(
                qs[fi], kv_out.k[fi], kv_out.v[fi], prefill, chunk_size,
                budget, k_scale=kv_out.k_scale[fi] if quant else None,
                v_scale=kv_out.v_scale[fi] if quant else None,
                mesh=mesh if split_seq else None)
            for name, x in zip(planes, sel):
                getattr(build_rkv, name)[fi, :, :, :budget] = x
    return logits, kv_out, build_rkv


def forward_spec(cfg: ModelConfig, params, input_ids: torch.Tensor,
                 rkv: RetrievalCache, kv_seq_len, budget: int,
                 commit: bool = True, act_quant: bool = False, mesh=None,
                 ring: Optional[KVCache] = None,
                 ) -> Tuple[torch.Tensor, RetrievalCache]:
    """Middle-model verify: the gamma+1 tokens attend the budget region
    plus themselves (causally) at absolute positions ``kv_seq_len +
    arange(T)``; with ``commit`` their KV lands in the scratch slots from
    ``budget`` (in place). ``kv_seq_len == 0`` gates the retrieval read to
    zero columns (a dead trip). ``act_quant``: int8 weights meet int8
    activations (``_wmm(aq=True)``). ``mesh``: this rank's heads of the
    retrieval cache, whose slots are never split. A hybrid model's
    sliding layers read the rings of the target's full cache ``ring``
    exactly (``kv_seq_len`` long; 0 on a dead trip) and commit nothing;
    its retrieval cache holds the full layers."""
    b, t = input_ids.shape
    plan = cfg.plan
    if cfg.windowed and (ring is None or commit or mesh is not None):
        raise ValueError("a sliding-window model's middle verify reads the "
                         "target's ring (ring=), commits nothing and runs "
                         "without a mesh")
    dev = input_ids.device
    cos, sin = rope.cos_sin_tables(cfg, device=dev)
    kv_seq_len = device_scalar(kv_seq_len, dev, torch.int32)
    positions = _positions(kv_seq_len, t, dev)
    k_len = torch.where(kv_seq_len > 0, budget, 0).to(torch.int32)
    commit_idx = window(budget, t, rkv.real_budget, dev)
    aq = act_quant
    par = _par(mesh, cfg)

    x, y = _embed(params, input_ids), None
    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        x, h = _add_norm(x, y, lp["ln_attn"], cfg)
        q, k_new, v_new = _qkv(h, lp, cfg, aq=aq)
        fi = plan.slot[li]
        if plan.attn[li] == SLIDING:
            ctx = _ring_attention(cfg, q, k_new, v_new, ring, fi,
                                  kv_seq_len, positions)
        else:
            q, k_new = layer_glue.rope((q, k_new), cos, sin, positions)
            ctx = _layer_attention(q, rkv, fi, k_new, v_new, k_len, par=par)
            if commit:
                _commit_layer(rkv, fi, commit_idx, k_new, v_new)
        x, h = _add_norm(x, _attn_out(ctx, lp, aq=aq, tp=par and par.wo),
                         lp["ln_mlp"], cfg)
        y = _mlp_of(cfg, li, h, lp, aq=aq, tp=par and par.w_down)
    return _logits(cfg, params, x, y, aq=aq,
                   vocab_mesh=par and par.vocab), rkv


# ---------------------------------------------------------------------------
# Tree speculation: the middle model's grow forward
# ---------------------------------------------------------------------------

def _slots(buf, start, n: int):
    """``n`` slots of a layer buffer [B, H, S, ...] from ``start``: a view
    for a host int, a clamped gather for a device scalar."""
    if isinstance(start, int):
        return buf[:, :, start:start + n]
    return slice_at(buf, start, n, 2)


def _tree_grow_attention(q, cache, li: int, prefix_len, staged_start,
                         slot_start: int, staged_len: int, amask, k_new,
                         v_new, new_mask, seq_mesh=None):
    """Grow-level attention over layer ``li`` of ``cache``, as three
    partials merged associatively (``llama.py:618-690``):

      prefix — slots [0, prefix_len), fully visible: the partials kernel on
               the card (``flash_decode_partials``), ``attention_partials``
               on the CPU;
      staged — the ``staged_len`` slots from ``staged_start`` (the tree
               region); a column is visible iff it is already written
               (col < slot_start) and an ancestor per ``amask``;
      self   — the frontier block (same-level nodes see only themselves).

    ``seq_mesh``: the cache holds this rank's slots of a cache split over
    that mesh's ``sp`` axis (``prefix_len`` and ``staged_start`` global):
    the prefix is each rank's part of it merged over ``sp``
    (``prefix_partials_sharded``), and the staged window, which may
    straddle two shards, is read whole on every rank (``slice_sharded``).
    This is the decomposition JAX's sharded grow body leaves for one
    masked attention (``llama.py:540-553``); the visible set is the same.
    """
    quant = cache.quantized
    scales = dict(k_scale=cache.k_scale[li] if quant else None,
                  v_scale=cache.v_scale[li] if quant else None)
    if seq_mesh is None:
        p = attention_partials_auto(q, cache.k[li], cache.v[li],
                                    k_len=prefix_len, **scales)
    else:
        p = prefix_partials_sharded(seq_mesh, q, cache.k[li], cache.v[li],
                                    k_len=prefix_len, **scales)
    if staged_len > 0:
        def staged(buf):
            if seq_mesh is None:
                return _slots(buf, staged_start, staged_len)
            return slice_sharded(buf, staged_start, staged_len, seq_mesh, 2)
        ks, vs = staged(cache.k[li]), staged(cache.v[li])
        if quant:
            ks = dequantize(ks, staged(cache.k_scale[li]), q.dtype)
            vs = dequantize(vs, staged(cache.v_scale[li]), q.dtype)
        cols = torch.arange(staged_len, device=q.device)
        staged_mask = amask[:, :staged_len] & (cols < slot_start)
        p = merge_partials(p, new_block_partials(q, ks, vs, staged_mask))
    p_self = new_block_partials(q, k_new, v_new, new_mask)
    return finalize(merge_partials(p, p_self), q.dtype)


def forward_tree_spec(cfg: ModelConfig, params, input_ids: torch.Tensor,
                      rkv: RetrievalCache, kv_seq_len, budget: int, depths,
                      ancestor_mask, slot_start: int,
                      kv: Optional[KVCache] = None, ssl: int = 0, mesh=None,
                      shard_seq: bool = False,
                      staged_len: Optional[int] = None,
                      act_quant: bool = False,
                      ) -> Tuple[torch.Tensor, RetrievalCache,
                                 Optional[KVCache]]:
    """Middle-model forward of one speculation-tree frontier over the tree
    retrieval cache (``llama.py:476-614``).

    ``input_ids`` [1, T] are the frontier tokens (one grow level, padded to
    a fixed width by the caller); their KV lands, in place, at the scratch
    slots ``budget + slot_start .. + T`` (level slots are consecutive in
    BFS order). ``depths`` [T] are the node depths (positions are
    ``kv_seq_len + depth``); ``ancestor_mask`` [T, tree_size] the ancestor
    rows of these nodes: a query sees the whole budget region, its already
    written tree ancestors, and itself. ``staged_len`` is the length of the
    tree window the attention reads (``slot_start`` when not given: the
    whole tree on a level forward, 0 on the root forward).

    ``ssl`` (self-speculation layers): the first ``ssl`` layers attend the
    FULL cache (prefix + their tree ancestors) instead of the retrieval
    cache, and stage their tree-node KV at full-cache slots ``kv_seq_len +
    slot_start ..``; the later verify overwrites the same slots with the
    same values. Needs ``kv``. ``act_quant``: int8 weights meet int8
    activations.

    ``mesh``: every tensor is this rank's shard; the tree retrieval cache
    holds the rank's heads, and with ``shard_seq`` the full cache its
    slots, split over ``sp`` (``_tree_grow_attention``'s ``seq_mesh``; the
    ssl layers then stage their nodes at the slots each rank owns).
    Returns (logits [1, T, V] fp32, rkv, kv)."""
    refuse_hybrid(cfg, "the tree grow")
    if not 0 <= ssl <= cfg.num_layers:
        raise ValueError(f"ssl {ssl} outside [0, {cfg.num_layers}]")
    if ssl > 0 and kv is None:
        raise ValueError("ssl layers need the full cache")
    if staged_len is None:
        staged_len = slot_start
    b, t = input_ids.shape
    dev = input_ids.device
    aq = act_quant
    cos, sin = rope.cos_sin_tables(cfg, device=dev)
    kv_seq_len = device_scalar(kv_seq_len, dev, torch.int32)
    positions = kv_seq_len.to(torch.int64) + torch.as_tensor(
        depths, device=dev).to(torch.int64)
    amask = torch.as_tensor(ancestor_mask, device=dev).to(torch.bool)
    new_mask = torch.eye(t, dtype=torch.bool, device=dev)
    budget_len = torch.full((), budget, dtype=torch.int32, device=dev)
    full_len = kv_seq_len.to(torch.int32)
    # where each kind of layer reads its prefix and stages its nodes; a
    # write that would run over the end slides back (JAX's clamp), which
    # the caller's padding of both caches keeps from happening
    rkv_idx = window(budget + slot_start, t, rkv.real_budget, dev)
    par = _par(mesh, cfg)
    seq_mesh = mesh if par is not None and shard_seq else None
    kv_start = kv_seq_len.to(torch.int64) + slot_start
    if ssl > 0 and seq_mesh is None:
        kv_idx = window(kv_start, t, kv.max_len, dev)

    x, y = _embed(params, input_ids), None
    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        x, h = _add_norm(x, y, lp["ln_attn"], cfg)
        q, k_new, v_new = _qkv(h, lp, cfg, aq=aq)
        q, k_new = layer_glue.rope((q, k_new), cos, sin, positions)
        if li < ssl:
            ctx = _tree_grow_attention(q, kv, li, full_len, full_len,
                                       slot_start, staged_len, amask, k_new,
                                       v_new, new_mask, seq_mesh)
            if seq_mesh is None:
                _commit_layer(kv, li, kv_idx, k_new, v_new)
            else:
                _commit_layer_sharded(kv, li, kv_start, k_new, v_new,
                                      seq_mesh)
        else:
            ctx = _tree_grow_attention(q, rkv, li, budget_len, budget,
                                       slot_start, staged_len, amask, k_new,
                                       v_new, new_mask)
            _commit_layer(rkv, li, rkv_idx, k_new, v_new)
        x, h = _add_norm(x, _attn_out(ctx, lp, aq=aq, tp=par and par.wo),
                         lp["ln_mlp"], cfg)
        y = _mlp(h, lp, aq=aq, tp=par and par.w_down)
    return _logits(cfg, params, x, y, aq=aq, vocab_mesh=par and par.vocab), \
        rkv, kv


# ---------------------------------------------------------------------------
# Drafter forwards (StreamingLLM semantics)
# ---------------------------------------------------------------------------

def _draft_layers(cfg, params, x, dkv, positions, k_len, commit_at,
                  rows: bool = False):
    """Shared drafter layer loop: keys are stored un-rotated, the whole
    window is re-rotated with slot positions, and attention is the plain
    ``append_attention`` (no kernel, as in the JAX package). ``rows``: the
    cache is row-stacked [B, L, ...] (positions and ``k_len`` are the same
    for every row at the fixed spec slots). Returns the last layer's (x,
    MLP output), whose sum ``_logits`` takes."""
    dev = x.device

    def layer(buf, li):
        return buf[:, li] if rows else buf[li]

    cos, sin = rope.cos_sin_tables(cfg, max_len=dkv.real_budget, device=dev)
    slot_pos = torch.arange(dkv.real_budget, device=dev)
    if commit_at is not None:
        commit_idx = window(commit_at, x.shape[1], dkv.real_budget, dev)
    y = None
    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        x, h = _add_norm(x, y, lp["ln_attn"], cfg)
        q, k_new, v_new = _qkv(h, lp, cfg)
        q, k_att = layer_glue.rope((q, k_new), cos, sin, positions)
        (k_cache,) = layer_glue.rope((layer(dkv.k, li),), cos, sin, slot_pos)
        ctx = append_attention(q, k_cache, layer(dkv.v, li), k_att, v_new,
                               k_len=k_len)
        if commit_at is not None:
            layer(dkv.k, li).index_copy_(2, commit_idx, k_new)
            layer(dkv.v, li).index_copy_(2, commit_idx, v_new)
        x, h = _add_norm(x, _attn_out(ctx, lp), lp["ln_mlp"], cfg)
        y = _mlp(h, lp)
    return x, y


def draft_forward(cfg: ModelConfig, params, input_ids: torch.Tensor,
                  dkv: StreamingCache, need_logits: bool = True,
                  ) -> Tuple[Optional[torch.Tensor], StreamingCache]:
    """Drafter prefill chunk: append at ``seq_len`` with slot positions (in
    place). The caller runs ``streaming_evict_prefill`` first.
    ``need_logits=False`` skips the lm_head projection (the prefill throws
    the logits away; the JAX scan drops them as dead code)."""
    if not cfg.rope_on_slots:
        raise ValueError("draft_forward needs a rope_on_slots drafter")
    b, t = input_ids.shape
    seq_len0 = dkv.seq_len
    positions = _positions(seq_len0, t, input_ids.device)
    x, y = _draft_layers(cfg, params, _embed(params, input_ids), dkv,
                         positions, seq_len0, seq_len0)
    logits = _logits(cfg, params, x, y) if need_logits else None
    return logits, dataclasses.replace(dkv, seq_len=seq_len0 + t)


def draft_forward_spec(cfg: ModelConfig, params, input_ids: torch.Tensor,
                       dkv: StreamingCache, spec: SpecConfig,
                       commit: bool = True,
                       ) -> Tuple[torch.Tensor, StreamingCache]:
    """Drafter speculation step: T tokens at the FIXED spec slots
    ``start + recent + i`` (query positions = those slot indices), keys
    re-rotated over the whole window; with ``commit`` their KV is written
    there in place. Causal masking makes a junk suffix inert, so one fixed
    T serves every offset."""
    if not cfg.rope_on_slots:
        raise ValueError("draft_forward_spec needs a rope_on_slots drafter")
    b, t = input_ids.shape
    spec0 = spec.draft_start_size + spec.draft_recent_size
    positions = _positions(spec0, t, input_ids.device)
    x, y = _draft_layers(cfg, params, _embed(params, input_ids), dkv,
                         positions, spec0, spec0 if commit else None)
    return _logits(cfg, params, x, y), dkv


# ---------------------------------------------------------------------------
# Row-batched forwards (B rows, one pass over the weights)
# ---------------------------------------------------------------------------

def _target_layers_rows(cfg: ModelConfig, params, input_ids, cache,
                        positions, k_len, aq: bool = False,
                        par: Optional[_Par] = None, shard_seq: bool = False):
    """The target's layer loop for B rows over a row-stacked cache, read
    only: row b attends slots [0, k_len[b]) of its own cache plus its T new
    tokens, at RoPE positions ``positions`` [B, T]. Returns (hidden
    [B, T, H] before the last MLP's residual, that MLP's output, new K
    stack, new V stack [B, L, Hkv, T, D]); keys rotated.
    ``par``: over a mesh (this rank's heads and columns; with
    ``shard_seq`` the cache's slots split over ``sp``)."""
    refuse_hybrid(cfg, "the rows forwards")
    cos, sin = rope.cos_sin_tables(cfg, device=input_ids.device)
    quant = cache.quantized
    x, y = _embed(params, input_ids), None
    nk, nv = [], []
    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        x, h = _add_norm(x, y, lp["ln_attn"], cfg)
        q, k_new, v_new = _qkv(h, lp, cfg, aq=aq)
        q, k_new = layer_glue.rope((q, k_new), cos, sin, positions)
        kw = dict(k_len=k_len,
                  k_scale=cache.k_scale[:, li] if quant else None,
                  v_scale=cache.v_scale[:, li] if quant else None)
        if par is not None and shard_seq:
            ctx = append_attention_rows_sharded(
                par.mesh, q, cache.k[:, li], cache.v[:, li], k_new, v_new,
                **kw)
        else:
            ctx = append_attention_rows(q, cache.k[:, li], cache.v[:, li],
                                        k_new, v_new, **kw)
        x, h = _add_norm(x, _attn_out(ctx, lp, aq=aq, tp=par and par.wo),
                         lp["ln_mlp"], cfg)
        y = _mlp(h, lp, aq=aq, tp=par and par.w_down)
        nk.append(k_new)
        nv.append(v_new)
    return x, y, torch.stack(nk, 1), torch.stack(nv, 1)


def _row_positions(start: torch.Tensor, t: int) -> torch.Tensor:
    """[B, T] positions ``start[b] + arange(T)``."""
    return start.to(torch.int64)[:, None] \
        + torch.arange(t, device=start.device)


def forward_append_rows(cfg: ModelConfig, params, input_ids: torch.Tensor,
                        kv: KVCache, mesh=None, shard_seq: bool = False):
    """``forward_append`` for B rows at once: row b appends its T tokens at
    its own length ``kv.seq_len[b]`` and attends its own live prefix. The
    cache is NOT written: returns (logits [B, T, V] fp32, new K stack, new
    V stack [B, L, Hkv, T, D]) for ``cache.batched_commit_and_refresh``
    (or a plain per-row commit) to store. ``mesh`` / ``shard_seq`` as in
    ``forward_append`` (``kv.seq_len`` stays global)."""
    if cfg.rope_on_slots:
        raise ValueError("a rope_on_slots drafter runs draft_forward_spec")
    t = input_ids.shape[1]
    par = _par(mesh, cfg)
    x, y, nk, nv = _target_layers_rows(cfg, params, input_ids, kv,
                                       _row_positions(kv.seq_len, t),
                                       kv.seq_len, par=par,
                                       shard_seq=shard_seq)
    return _logits(cfg, params, x, y, vocab_mesh=par and par.vocab), nk, nv


def forward_spec_rows(cfg: ModelConfig, params, input_ids: torch.Tensor,
                      rkv: RetrievalCache, kv_seq_len: torch.Tensor,
                      budget: int, act_quant: bool = False,
                      mesh=None) -> torch.Tensor:
    """``forward_spec`` for B rows at once, read-only (the engines never
    commit a middle verify): row b's gamma+1 tokens attend its budget
    region plus themselves at positions ``kv_seq_len[b] + arange(T)``.
    ``kv_seq_len[b] == 0`` (a dead slot, or a dead middle trip) collapses
    that row's retrieval read to zero columns. ``act_quant`` as in
    ``forward_spec``. ``mesh``: this rank's heads of the retrieval caches,
    whose slots are never split. Returns logits [B, T, V]."""
    t = input_ids.shape[1]
    k_len = torch.where(kv_seq_len > 0, budget, 0).to(torch.int32)
    par = _par(mesh, cfg)
    x, y, _, _ = _target_layers_rows(cfg, params, input_ids, rkv,
                                     _row_positions(kv_seq_len, t), k_len,
                                     aq=act_quant, par=par)
    return _logits(cfg, params, x, y, aq=act_quant,
                   vocab_mesh=par and par.vocab)


def draft_forward_spec_rows(cfg: ModelConfig, params,
                            input_ids: torch.Tensor, dkv: StreamingCache,
                            spec: SpecConfig, commit: bool = True
                            ) -> Tuple[torch.Tensor, StreamingCache]:
    """``draft_forward_spec`` for B rows over a row-stacked drafter cache
    [B, L, Hkv, S, D]: every row's T tokens sit at the same fixed spec
    slots, so positions and the visible window are shared and only the
    cache contents differ by row."""
    if not cfg.rope_on_slots:
        raise ValueError("draft_forward_spec needs a rope_on_slots drafter")
    t = input_ids.shape[1]
    spec0 = spec.draft_start_size + spec.draft_recent_size
    positions = _positions(spec0, t, input_ids.device)
    x, y = _draft_layers(cfg, params, _embed(params, input_ids), dkv,
                         positions, spec0, spec0 if commit else None,
                         rows=True)
    return _logits(cfg, params, x, y), dkv
