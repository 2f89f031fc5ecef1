"""The layer glue's entry points (``ops/layer_glue.py``) and the forwards
that call them, on the CPU, against the chain of PyTorch ops the forwards
ran before the glue had kernels.

On a CPU tensor every entry point takes its plain version, so each must
equal that chain bit for bit, in fp32 and bf16: residual add + RMSNorm with
and without a residual, RoPE at shared and per-row positions, D 64 and 128,
GQA 4 and 8 and over the drafter's whole window, and silu(gate) * up. The
forwards, whose layer loops now carry each MLP output into the next norm,
must leave the logits and caches the old loop left. The kernels themselves
are held against these plain versions on a card
(``tests/test_torch_kernels_cuda.py``).
"""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from triforce_tpu_torch import cache as tcache
from triforce_tpu_torch import config as tcfg
from triforce_tpu_torch.models import llama as tl
from triforce_tpu_torch.models import rope as trope
from triforce_tpu_torch.ops import layer_glue as lg

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16]


# the chain as the forwards ran it before the glue had kernels
def _chain_rms_norm(x, w, eps):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return w * (xf * torch.rsqrt(var + eps)).to(x.dtype)


def _chain_rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _chain_rope(x, cos, sin, positions):
    if positions.dim() == 2:
        c = cos[positions][:, None].to(x.dtype)
        s = sin[positions][:, None].to(x.dtype)
    else:
        c = cos.index_select(0, positions).to(x.dtype)
        s = sin.index_select(0, positions).to(x.dtype)
    return x * c + _chain_rotate_half(x) * s


def _randn(seed, *shape, dtype=torch.float32, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dtype)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("shape,eps", [((1, 7, 4096), 1e-5),
                                       ((8, 7, 768), 1e-6),
                                       ((1, 512, 256), 1e-5)])
def test_add_rms_norm_equals_the_chain(dtype, residual, shape, eps):
    x = _randn(0, *shape, dtype=dtype)
    y = _randn(1, *shape, dtype=dtype, scale=0.3) if residual else None
    w = 1 + _randn(2, shape[-1], dtype=dtype, scale=0.1)
    xo, h = lg.add_rms_norm(x, y, w, eps)
    want_x = x + y if residual else x
    _same(xo, want_x)
    _same(h, _chain_rms_norm(want_x, w, eps))
    if not residual:
        assert xo is x
    assert lg.add_rms_norm.launches == 0


# (B, Hq, Hkv, T, D, positions per row): decode and verify widths at GQA 4
# and 8, the batched rows, a prefill chunk, D 64 and 128
ROPE_CASES = [(1, 32, 8, 7, 128, False), (1, 32, 8, 8, 128, False),
              (8, 32, 4, 7, 128, True), (1, 32, 4, 1, 64, False),
              (3, 8, 1, 5, 64, True), (1, 16, 4, 64, 128, False)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,hq,hkv,t,d,per_row", ROPE_CASES)
def test_rope_on_q_and_k_equals_the_chain(dtype, b, hq, hkv, t, d, per_row):
    cfg = tcfg.TINY_TARGET.with_(head_dim=d)
    cos, sin = trope.cos_sin_tables(cfg, device="cpu")
    g = torch.Generator().manual_seed(t * d + b)
    shape = (b, t) if per_row else (t,)
    positions = torch.randint(0, cos.shape[0], shape, generator=g)
    # q and k as the projections leave them: [B, T, H, D] seen as [B, H, T,
    # D]
    q = _randn(3, b, t, hq, d, dtype=dtype).transpose(1, 2)
    k = _randn(4, b, t, hkv, d, dtype=dtype).transpose(1, 2)
    rq, rk = lg.rope((q, k), cos, sin, positions)
    _same(rq, _chain_rope(q, cos, sin, positions))
    _same(rk, _chain_rope(k, cos, sin, positions))
    assert lg.rope.launches == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [1, 4])
def test_rope_over_the_drafters_whole_window(dtype, rows):
    """The drafter re-rotates one layer of its un-rotated cache, a view of
    the stacked [L, B, ...] (or row-stacked [B, L, ...]) planes, at every
    slot's position."""
    cfg = tcfg.TINY_DRAFT.with_(head_dim=64)
    spec = tcfg.SpecConfig(gamma=6, draft_start_size=16,
                           draft_recent_size=250)
    if rows == 1:
        dkv = tcache.init_streaming(cfg, spec, dtype=dtype, device="cpu")
    else:
        dkv = tcache.init_streaming_rows(cfg, spec, rows, dtype=dtype,
                                         device="cpu")
    dkv.k.copy_(_randn(5, *dkv.k.shape, dtype=dtype))
    layer = dkv.k[1] if rows == 1 else dkv.k[:, 1]
    s = dkv.real_budget
    assert s == 275
    cos, sin = trope.cos_sin_tables(cfg, max_len=s, device="cpu")
    slot_pos = torch.arange(s)
    (got,) = lg.rope((layer,), cos, sin, slot_pos)
    _same(got, _chain_rope(layer, cos, sin, slot_pos))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 7, 14336), (8, 7, 11008),
                                   (1, 64, 3072)])
def test_silu_mul_equals_the_chain(dtype, shape):
    gate = _randn(6, *shape, dtype=dtype, scale=3.0)
    up = _randn(7, *shape, dtype=dtype)
    _same(lg.silu_mul(gate, up), F.silu(gate) * up)
    assert lg.silu_mul.launches == 0


@pytest.mark.parametrize("what,xs,positions", [
    ("three tensors", [(1, 4, 7, 64)] * 3, (7,)),
    ("odd D", [(1, 4, 7, 63)], (7,)),
    ("3-D", [(4, 7, 64)], (7,)),
    ("two B", [(1, 4, 7, 64), (2, 4, 7, 64)], (7,)),
    ("positions of another T", [(1, 4, 7, 64)], (6,)),
    ("positions of another B", [(2, 4, 7, 64)], (3, 7)),
])
def test_rope_refuses_what_its_kernel_does_not_take(what, xs, positions):
    """The kernel's shape checks (pure Python, so they run here too)."""
    d = xs[0][-1]
    cos = torch.zeros((16, d))
    tensors = [torch.zeros(s) for s in xs]
    with pytest.raises(ValueError):
        lg._check_rope(tensors, cos, cos,
                       torch.zeros(positions, dtype=torch.int64))


def test_rope_checks_pass_the_forwards_shapes():
    q = torch.zeros((1, 7, 32, 128)).transpose(1, 2)
    k = torch.zeros((1, 7, 8, 128)).transpose(1, 2)
    cos = torch.zeros((64, 128))
    lg._check_rope((q, k), cos, cos, torch.zeros(7, dtype=torch.int64))
    lg._check_rope((q, k), cos, cos, torch.zeros((1, 7), dtype=torch.int64))


def test_glue_refuses_an_unsupported_dtype_or_a_mix():
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        lg._dtype_code("silu_mul", x)
    with pytest.raises(ValueError):
        lg._dtype_code("silu_mul", torch.zeros(4),
                       torch.zeros(4, dtype=torch.bfloat16))
    assert lg._dtype_code("rope", torch.zeros(4, dtype=torch.bfloat16)) == 1


# ---------------------------------------------------------------------------
# The forwards against the layer loop they ran before
# ---------------------------------------------------------------------------

SPEC = tcfg.SpecConfig(gamma=6, budget=16, chunk_size=4, draft_start_size=4,
                       draft_recent_size=12)


def _params(cfg, dtype, seed):
    p = tl.init_params(cfg, device="cpu", dtype=dtype, seed=seed)
    for i, name in enumerate(("ln_attn", "ln_mlp")):
        w = p["layers"][name]
        w.copy_(1 + _randn(seed + i, *w.shape, dtype=dtype, scale=0.2))
    p["final_norm"].copy_(1 + _randn(seed + 2, *p["final_norm"].shape,
                                     dtype=dtype, scale=0.2))
    return p


def _chain_mlp(h, lp):
    gate = tl._wmm(h, lp, "w_gate")
    up = tl._wmm(h, lp, "w_up")
    return tl._wmm(F.silu(gate) * up, lp, "w_down")


def _chain_logits(cfg, params, x):
    h = _chain_rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return tl._wmm(h, params, "lm_head", out_dtype=torch.float32)


def _chain_target(cfg, params, ids, cache, positions, k_len, commit_idx):
    """The target's layer loop as it was: norm, rotations, attention over
    ``cache``, commit at ``commit_idx``, two residual adds a layer."""
    cos, sin = trope.cos_sin_tables(cfg, device="cpu")
    eps = cfg.rms_norm_eps
    x = tl._embed(params, ids)
    for li in range(cfg.num_layers):
        lp = tl._layer(params, li)
        h = _chain_rms_norm(x, lp["ln_attn"], eps)
        q, k_new, v_new = tl._qkv(h, lp, cfg)
        q = _chain_rope(q, cos, sin, positions)
        k_new = _chain_rope(k_new, cos, sin, positions)
        ctx = tl._layer_attention(q, cache, li, k_new, v_new, k_len)
        tl._commit_layer(cache, li, commit_idx, k_new, v_new)
        x = x + tl._attn_out(ctx, lp)
        h = _chain_rms_norm(x, lp["ln_mlp"], eps)
        x = x + _chain_mlp(h, lp)
    return _chain_logits(cfg, params, x)


def _same_caches(a, b):
    for name in ("k", "v"):
        _same(getattr(a, name), getattr(b, name))


def _prefilled(cfg, dtype, n=20):
    params = _params(cfg, dtype, 0)
    kv = tcache.init_kv(cfg, 64, dtype=dtype, device="cpu")
    ids = torch.randint(0, cfg.vocab_size, (1, n),
                        generator=torch.Generator().manual_seed(1))
    _, kv, _ = tl.forward_append(cfg, params, ids, kv, need_logits=False)
    return params, kv


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_append_leaves_what_the_old_loop_left(dtype):
    cfg = tcfg.TINY_TARGET
    params, kv = _prefilled(cfg, dtype)
    ids = torch.randint(0, cfg.vocab_size, (1, 7),
                        generator=torch.Generator().manual_seed(2))
    old = kv.clone()
    logits, new, _ = tl.forward_append(cfg, params, ids, kv.clone())
    n0 = int(old.seq_len)
    want = _chain_target(cfg, params, ids, old, torch.arange(n0, n0 + 7),
                         old.seq_len, tcache.window(n0, 7, old.max_len,
                                                    "cpu"))
    _same(logits, want)
    _same_caches(new, old)
    assert int(new.seq_len) == n0 + 7


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_spec_leaves_what_the_old_loop_left(dtype):
    cfg = tcfg.TINY_TARGET
    params, kv = _prefilled(cfg, dtype)
    rkv = tcache.init_retrieval(cfg, SPEC, dtype=dtype, device="cpu")
    rkv.k.copy_(_randn(8, *rkv.k.shape, dtype=dtype))
    rkv.v.copy_(_randn(9, *rkv.v.shape, dtype=dtype))
    t = SPEC.gamma + 1
    ids = torch.randint(0, cfg.vocab_size, (1, t),
                        generator=torch.Generator().manual_seed(3))
    old = rkv.clone()
    logits, new = tl.forward_spec(cfg, params, ids, rkv.clone(), kv.seq_len,
                                  SPEC.budget)
    n0 = int(kv.seq_len)
    want = _chain_target(
        cfg, params, ids, old, torch.arange(n0, n0 + t),
        torch.tensor(SPEC.budget, dtype=torch.int32),
        tcache.window(SPEC.budget, t, old.real_budget, "cpu"))
    _same(logits, want)
    _same_caches(new, old)


def _chain_draft(cfg, params, ids, dkv, positions, k_len, commit_at):
    """The drafter's layer loop as it was (``_draft_layers``)."""
    s = dkv.real_budget
    cos, sin = trope.cos_sin_tables(cfg, max_len=s, device="cpu")
    slot_pos = torch.arange(s)
    commit_idx = tcache.window(commit_at, ids.shape[1], s, "cpu")
    eps = cfg.rms_norm_eps
    x = tl._embed(params, ids)
    for li in range(cfg.num_layers):
        lp = tl._layer(params, li)
        h = _chain_rms_norm(x, lp["ln_attn"], eps)
        q, k_new, v_new = tl._qkv(h, lp, cfg)
        q = _chain_rope(q, cos, sin, positions)
        k_cache = _chain_rope(dkv.k[li], cos, sin, slot_pos)
        k_att = _chain_rope(k_new, cos, sin, positions)
        ctx = tl.append_attention(q, k_cache, dkv.v[li], k_att, v_new,
                                  k_len=k_len)
        dkv.k[li].index_copy_(2, commit_idx, k_new)
        dkv.v[li].index_copy_(2, commit_idx, v_new)
        x = x + tl._attn_out(ctx, lp)
        h = _chain_rms_norm(x, lp["ln_mlp"], eps)
        x = x + _chain_mlp(h, lp)
    return _chain_logits(cfg, params, x)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("phase", ["prefill", "spec"])
def test_draft_layers_leave_what_the_old_loop_left(dtype, phase):
    cfg = tcfg.TINY_DRAFT
    params = _params(cfg, dtype, 5)
    dkv = tcache.init_streaming(cfg, SPEC, dtype=dtype, device="cpu")
    dkv.k.copy_(_randn(10, *dkv.k.shape, dtype=dtype))
    dkv.v.copy_(_randn(11, *dkv.v.shape, dtype=dtype))
    if phase == "prefill":
        dkv = dataclasses.replace(dkv, seq_len=torch.tensor(
            5, dtype=torch.int32))
        start, t = 5, 6
    else:
        start, t = SPEC.draft_start_size + SPEC.draft_recent_size, \
            SPEC.gamma + 1
    ids = torch.randint(0, cfg.vocab_size, (1, t),
                        generator=torch.Generator().manual_seed(4))
    old = dkv.clone()
    if phase == "prefill":
        logits, new = tl.draft_forward(cfg, params, ids, dkv.clone())
        k_len = old.seq_len
    else:
        logits, new = tl.draft_forward_spec(cfg, params, ids, dkv.clone(),
                                            SPEC)
        k_len = start
    want = _chain_draft(cfg, params, ids, old, torch.arange(start,
                                                            start + t),
                        k_len, start)
    _same(logits, want)
    _same_caches(new, old)
