"""Attention over a cache plus the tokens being appended — the port of
``triforce_tpu/ops/attention.py``.

Plain PyTorch online-softmax attention split into PARTIALS (m, l, acc) that
merge associatively:

  cache part — blockwise over the read-only cache, bounded by ``k_len`` (a
               0-d device tensor or an int);
  new part   — the T tokens appended by this forward.

``attention_partials_auto`` is the same dispatch for the cache part alone
(the tree grow's prefix): the partials kernel on a CUDA tensor,
``attention_partials`` on the CPU. ``attention_partials_rows`` is it for B
rows with a length each (rows whose cache slots are split over a mesh):
one partials-kernel launch a row on a CUDA tensor.

``append_attention_auto`` is the dispatcher the models call: a CUDA tensor
with no extra cache mask goes to the hand-written flash-decode kernel
(``ops/flash_decode.py``; its int8 kernel for an int8 cache), a CPU tensor
to ``append_attention``. ``append_attention_rows`` is the same dispatch for
B rows with a live length each (``k_len`` [B]): the row-batched kernel on a
CUDA tensor, ``append_attention`` with per-row lengths on the CPU. It
stands where the JAX package has its ``custom_vmap`` rules and
``batching._batched_attention``.

A sliding-window layer's cache is a ring (``cache.KVCache.ring_k``): R
slots, position p at slot p mod R, ``k_len`` the sequence length L. With
``window`` W > 0 slot s holds position L - 1 - ((L - 1 - s) mod R), and
query token t (at position L + t) sees it iff that position is at least
L + t - W + 1 (``window_valid``); the new block stays causal (a forward
appends at most R - W <= W tokens).

An int8 cache comes with fp32 per-token scales (``k_scale``/``v_scale``
[B, Hkv, S]); the plain path dequantizes each block to fp32 and then runs
the model-dtype step, as the JAX package does off the TPU
(``triforce_tpu/ops/attention.py:106-151``).

Convention: q is [B, Hq, T, D]; cached K/V are [B, Hkv, S, D]; GQA groups
q heads (no materialised repeat of K/V).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .flash_decode import (append_attention_kernel,
                           append_attention_kernel_batched,
                           append_attention_kernel_batched_int8,
                           append_attention_kernel_int8,
                           attention_partials_kernel, causal_mask,
                           window_valid)

_NEG_INF = -1e30

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # m, l, acc


def _update(qg, m, l, acc, k_blk, v_blk, valid):
    """One online-softmax step over a key block. qg [B,Hkv,G,T,D]
    pre-scaled in the model dtype; k/v [B,Hkv,S_blk,D]; valid [T,S_blk].
    Operands are in the model dtype with fp32 accumulation (products of
    bf16 values are exact in fp32); the softmax state is fp32."""
    sc = torch.einsum("bhgtd,bhsd->bhgts", qg.float(),
                      k_blk.to(qg.dtype).float())
    sc = torch.where(valid, sc, _NEG_INF)
    m_new = torch.maximum(m, sc.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(sc - m_new[..., None])
    l = l * alpha + p.sum(-1)
    acc = acc * alpha[..., None] + torch.einsum(
        "bhgts,bhsd->bhgtd", p.to(qg.dtype).float(),
        v_blk.to(qg.dtype).float())
    return m_new, l, acc


def _prescaled(q, hkv):
    b, hq, t, d = q.shape
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    return (q.reshape(b, hkv, g, t, d).float() * scale).to(q.dtype)


def _init_partials(q, hkv):
    b, hq, t, d = q.shape
    g = hq // hkv
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.full((b, hkv, g, t), _NEG_INF, **f32),
            torch.zeros((b, hkv, g, t), **f32),
            torch.zeros((b, hkv, g, t, d), **f32))


def _deq(blk, scale):
    """fp32 values of an int8 block (``blk`` as it is without scales)."""
    if scale is None:
        return blk
    return blk.float() * scale[..., None].float()


def attention_partials(q, k, v, *, k_len=None, mask_fn=None,
                       block: int = 2048, k_scale=None,
                       v_scale=None, window: int = 0) -> Partials:
    """Online-softmax partials of q against a read-only key/value buffer.
    ``k_len`` masks columns >= k_len (a [B] tensor gives every row its own
    length); ``mask_fn(rows, cols) -> bool`` adds extra masking. Blocks
    past a host-known ``k_len`` are skipped; with a device ``k_len`` every
    block runs masked (no host sync). An int8 buffer passes its scales and
    is dequantized block by block. ``window``: the buffer is a
    sliding-window layer's ring and ``k_len`` the sequence length
    (``window_valid``)."""
    t = q.shape[2]
    hkv, s = k.shape[1], k.shape[2]
    if torch.is_tensor(k_len) and k_len.dim() == 1:
        k_len = k_len.reshape(-1, 1, 1, 1, 1)     # against [B,Hkv,G,T,S]
    qg = _prescaled(q, hkv)
    m, l, acc = _init_partials(q, hkv)
    n_run = s if (k_len is None or torch.is_tensor(k_len)) \
        else min(s, max(int(k_len), 0))
    rows = torch.arange(t, device=q.device)[:, None]
    for start in range(0, n_run, block):
        stop = min(start + block, s)
        cols = torch.arange(start, stop, device=q.device)[None, :]
        valid = torch.ones((t, stop - start), dtype=torch.bool,
                           device=q.device)
        if window:
            valid = valid & window_valid(rows, cols, k_len, s, window)
        elif k_len is not None:
            valid = valid & (cols < k_len)
        if mask_fn is not None:
            valid = valid & mask_fn(rows, cols)
        ks = None if k_scale is None else k_scale[:, :, start:stop]
        vs = None if v_scale is None else v_scale[:, :, start:stop]
        m, l, acc = _update(qg, m, l, acc, _deq(k[:, :, start:stop], ks),
                            _deq(v[:, :, start:stop], vs), valid)
    return m, l, acc


def attention_partials_auto(q, k, v, *, k_len, k_scale=None,
                            v_scale=None) -> Partials:
    """Dispatch of the cache-only partials over a fully visible prefix
    [0, k_len): a CUDA tensor goes to the partials kernel
    (``flash_decode_partials``, the int8 one when the cache has scales;
    each raises on what it does not take), a CPU tensor to
    ``attention_partials``. k/v are one layer [1, Hkv, S, D]."""
    if q.device.type == "cuda":
        return attention_partials_kernel(q, k, v, k_len=k_len,
                                         k_scale=k_scale, v_scale=v_scale)
    return attention_partials(q, k, v, k_len=k_len, k_scale=k_scale,
                              v_scale=v_scale)


def attention_partials_rows(q, k, v, *, k_len, k_scale=None,
                            v_scale=None) -> Partials:
    """``attention_partials_auto`` for B rows, each over its own fully
    visible prefix [0, k_len[b]): q [B, Hq, T, D]; k/v [B, Hkv, S, D] (one
    layer of every row); k_len [B] int32 on q's device; scales [B, Hkv, S]
    with an int8 cache. A CUDA tensor launches the partials kernel once a
    row (its ``k_len`` a view of the row's entry, never read back); a CPU
    tensor runs ``attention_partials`` with per-row lengths. -> (m, l
    [B, Hkv, G, T], acc [B, Hkv, G, T, D])."""
    if q.device.type == "cuda":
        parts = [attention_partials_kernel(
            q[b:b + 1], k[b:b + 1], v[b:b + 1], k_len=k_len[b],
            k_scale=None if k_scale is None else k_scale[b:b + 1],
            v_scale=None if v_scale is None else v_scale[b:b + 1])
            for b in range(q.shape[0])]
        return tuple(torch.cat(x) for x in zip(*parts))
    return attention_partials(q, k, v, k_len=k_len, k_scale=k_scale,
                              v_scale=v_scale)


def new_block_partials(q, k_new, v_new, new_mask) -> Partials:
    """Partials of q against the new-token block; new_mask [T, Tn] bool
    (True = attend), typically lower-triangular, or [B, T, Tn] per row."""
    hkv = k_new.shape[1]
    if new_mask.dim() == 3:
        new_mask = new_mask[:, None, None]
    qg = _prescaled(q, hkv)
    m, l, acc = _init_partials(q, hkv)
    return _update(qg, m, l, acc, k_new, v_new, new_mask)


def merge_partials(a: Partials, b: Partials) -> Partials:
    """Associative combine of online-softmax partials."""
    m1, l1, acc1 = a
    m2, l2, acc2 = b
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return m, l1 * a1 + l2 * a2, acc1 * a1[..., None] + acc2 * a2[..., None]


def finalize(p: Partials, out_dtype) -> torch.Tensor:
    m, l, acc = p
    b, hkv, g, t, d = acc.shape
    out = acc / l.clamp_min(1e-37)[..., None]
    return out.reshape(b, hkv * g, t, d).to(out_dtype)


def append_attention(q, k_cache, v_cache, k_new, v_new, *, k_len,
                     cache_mask_fn=None, new_mask=None, block: int = 2048,
                     k_scale=None, v_scale=None,
                     window: int = 0) -> torch.Tensor:
    """Attention of T new tokens against [valid cache prefix] +
    [themselves]. The cache is read-only here; the caller commits
    (k_new, v_new) afterwards. The new tokens are never quantized.
    ``window``: the cache is a sliding-window layer's ring (module
    docstring)."""
    t, tn = q.shape[2], k_new.shape[2]
    if new_mask is None:
        new_mask = causal_mask(t, tn, 1, q.device)
    pc = attention_partials(q, k_cache, v_cache, k_len=k_len,
                            mask_fn=cache_mask_fn, block=block,
                            k_scale=k_scale, v_scale=v_scale, window=window)
    pn = new_block_partials(q, k_new, v_new, new_mask)
    return finalize(merge_partials(pc, pn), q.dtype)


def append_attention_auto(q, k_cache, v_cache, k_new, v_new, *, k_len,
                          cache_mask_fn=None, new_mask=None,
                          block: int = 2048, k_scale=None,
                          v_scale=None, window: int = 0) -> torch.Tensor:
    """Dispatch: a CUDA tensor with no extra cache mask goes to the
    flash-decode kernel, the int8 one when the cache has scales (each
    raises on what it does not take); anything else runs
    ``append_attention``. k/v cache are one layer [B,Hkv,S,D], scales
    [B,Hkv,S]. ``window``: a sliding-window layer's ring (bf16 only)."""
    if q.device.type == "cuda" and cache_mask_fn is None:
        if k_scale is not None:
            if window:
                raise NotImplementedError("no int8 sliding-window kernel")
            return append_attention_kernel_int8(
                q, k_cache, v_cache, k_new, v_new, k_len=k_len,
                new_mask=new_mask, k_scale=k_scale, v_scale=v_scale)
        return append_attention_kernel(q, k_cache, v_cache, k_new, v_new,
                                       k_len=k_len, new_mask=new_mask,
                                       window=window)
    return append_attention(q, k_cache, v_cache, k_new, v_new, k_len=k_len,
                            cache_mask_fn=cache_mask_fn, new_mask=new_mask,
                            block=block, k_scale=k_scale, v_scale=v_scale,
                            window=window)


def append_attention_rows(q, k_cache, v_cache, k_new, v_new, *, k_len,
                          new_mask=None, block: int = 2048, k_scale=None,
                          v_scale=None) -> torch.Tensor:
    """Dispatch for B rows with a live length each: q [B, Hq, T, D]; k/v
    cache [B, Hkv, S, D] (one layer of every row); k_new/v_new
    [B, Hkv, Tn, D]; k_len [B] on q's device; new_mask None (causal),
    [T, Tn] or [B, T, Tn]; scales [B, Hkv, S] for int8 caches. A CUDA
    tensor launches the row-batched flash-decode kernel once for all rows,
    the int8 one when the cache has scales (each raises on what it does not
    take); a CPU tensor runs ``append_attention``, whose cache partials
    mask each row at its own length."""
    if q.device.type == "cuda":
        if k_scale is not None:
            return append_attention_kernel_batched_int8(
                q, k_cache, v_cache, k_new, v_new, k_len=k_len,
                new_mask=new_mask, k_scale=k_scale, v_scale=v_scale)
        return append_attention_kernel_batched(
            q, k_cache, v_cache, k_new, v_new, k_len=k_len,
            new_mask=new_mask)
    return append_attention(q, k_cache, v_cache, k_new, v_new, k_len=k_len,
                            new_mask=new_mask, block=block, k_scale=k_scale,
                            v_scale=v_scale)
