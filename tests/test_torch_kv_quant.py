"""INT8 KV cache: the port against the JAX package on the CPU.

Covers the codec, kernel B1-int8's and B2-int8's plain versions against the
Pallas kernels in interpret mode (run as tests/test_flash_decode.py and
tests/test_retrieval_kernel.py run them), the CPU attention path against
the JAX XLA path, the forwards' quantized commits, the int8 retrieval build
and tail refresh, and the Engine with ``kv_quant`` under the near-greedy
oracle of tests/test_torch_engine.py. Inputs are numpy arrays from a seed;
each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triforce_tpu import cache as jcache
from triforce_tpu import config as jcfg
from triforce_tpu import decoding as jdec
from triforce_tpu.engine import Engine as JEngine
from triforce_tpu.models import llama as jl
from triforce_tpu.ops import attention as jatt
from triforce_tpu.ops import retrieval as jret
from triforce_tpu.ops.flash_decode import flash_decode_append as j_fda
from triforce_tpu.ops.retrieval_kernel import chunk_scores_pallas
from triforce_tpu_torch import cache as tcache
from triforce_tpu_torch import config as tcfg
from triforce_tpu_torch import decoding as tdec
from triforce_tpu_torch.engine import Engine as TEngine
from triforce_tpu_torch.models import llama as tl
from triforce_tpu_torch.ops import attention as tatt
from triforce_tpu_torch.ops import flash_decode as tfd
from triforce_tpu_torch.ops import retrieval as tret
from triforce_tpu_torch.ops import retrieval_kernel as trk

torch.set_num_threads(1)

HKV, S, D, BLOCK = 2, 512, 32, 128
K_LENS = [0, 300, 256, 512]          # empty, inside a block, boundary, S
# fp32 arithmetic of the same inputs summed in another order
TOL = dict(rtol=2e-5, atol=2e-5)
SPEC_KW = dict(gamma=3, budget=16, chunk_size=4, draft_start_size=4,
               draft_recent_size=12)


def _np(x):
    return np.array(x)


def _codes(rng, *shape):
    """int8 codes and positive fp32 scales of a cache [..., S, D]."""
    codes = rng.integers(-127, 128, shape).astype(np.int8)
    scales = (rng.random(shape[:-1]) * 0.05 + 0.005).astype(np.float32)
    return codes, scales


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

def test_quantize_tokens_and_dequantize_match_jax_bitwise():
    """Codes and scales are bit-identical (round half to even on both
    sides, including exact .5 ties and an all-zero token)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 3, 7, 16)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0                               # scale floor 1e-8
    x[0, 0, 1, :4] = [127.0, 0.5, 1.5, -2.5]       # ties at scale 1
    jc, js = jcache.quantize_tokens(jnp.asarray(x))
    tc, ts = tcache.quantize_tokens(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), _np(jc))
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        want = _np(jcache.dequantize(jc, js, jd).astype(jnp.float32))
        got = tcache.dequantize(tc, ts, td).float().numpy()
        np.testing.assert_array_equal(got, want)


def test_quantized_cache_constructors_match_jax():
    spec_j, spec_t = jcfg.SpecConfig(**SPEC_KW), tcfg.SpecConfig(**SPEC_KW)
    jkv = jcache.init_kv(jcfg.TINY_TARGET, 24, quant=True)
    tkv = tcache.init_kv(tcfg.TINY_TARGET, 24, device="cpu", quant=True)
    jr = jcache.init_retrieval(jcfg.TINY_TARGET, spec_j, quant=True)
    tr = tcache.init_retrieval(tcfg.TINY_TARGET, spec_t, device="cpu",
                               quant=True)
    for j, t in ((jkv, tkv), (jr, tr)):
        assert t.quantized and t.k.dtype == torch.int8
        assert t.k.shape == j.k.shape and t.k_scale.shape == j.k_scale.shape
        assert t.v_scale.dtype == torch.float32
    assert not tcache.init_kv(tcfg.TINY_TARGET, 8, device="cpu").quantized
    c = tkv.clone()
    c.k_scale += 1
    assert tkv.k_scale.sum() == 0                 # clone copies the scales


# ---------------------------------------------------------------------------
# kernel B1-int8: plain version vs the Pallas quant branch
# ---------------------------------------------------------------------------

def _assert_close_up_to_flips(got, want, tol, flip_bound, err_msg=""):
    """Elementwise within ``tol``, except where an integer code of p
    flipped by one: exp differs by an ulp between the frameworks, so a
    p * vs / ps within an ulp of a rounding midpoint may round the other
    way. Such an element moves by at most one code step, ps * |v8| / l <=
    max vs (``flip_bound``); at most 0.5% of elements may."""
    diff = np.abs(got - want)
    over = diff > tol["atol"] + tol["rtol"] * np.abs(want)
    assert over.mean() <= 5e-3, (err_msg, over.mean())
    assert diff.max() <= flip_bound, (err_msg, diff.max())


def _b1_inputs(gt, seed, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((HKV, gt, D)).astype(np.float32)
    kn = rng.standard_normal((HKV, gt, D)).astype(np.float32)
    vn = rng.standard_normal((HKV, gt, D)).astype(np.float32)
    if dtype == "bfloat16":      # round once, then hand both sides the same
        q, kn, vn = (np.array(jnp.asarray(a, jnp.bfloat16)
                              .astype(jnp.float32)) for a in (q, kn, vn))
    k8, ks = _codes(rng, HKV, S, D)
    v8, vs = _codes(rng, HKV, S, D)
    return q, kn, vn, k8, ks, v8, vs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gt", [1, 7, 8, 256])
def test_int8_plain_matches_pallas_interpret(gt, dtype):
    """GT in {1, 7, 8, 256 (q-tiled)} with every k_len case, the plain
    version at the Pallas block. Every p and integer code is the kernel's;
    only the rescaled sum over blocks is ordered differently (fp32
    tolerance) and, rarely, a p code flips by one (see
    ``_assert_close_up_to_flips``). With bf16 inputs the new block's p is
    rounded to bf16, and exp differing by an ulp between the frameworks
    can move that rounding by one bf16 ulp (2^-8 relative), hence 1e-2."""
    q, kn, vn, k8, ks, v8, vs = _b1_inputs(gt, 10 + gt, dtype)
    mask = np.tril(np.ones((gt, gt), bool))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    for k_len in K_LENS:
        want = j_fda(jnp.asarray(q, jd), jnp.asarray(k8), jnp.asarray(v8),
                     jnp.asarray(kn, jd), jnp.asarray(vn, jd),
                     jnp.asarray(k_len), jnp.asarray(mask), block=BLOCK,
                     interpret=True, k_scale=jnp.asarray(ks),
                     v_scale=jnp.asarray(vs))
        got = tfd.flash_decode_append_int8_plain(
            torch.from_numpy(q).to(td), torch.from_numpy(k8),
            torch.from_numpy(v8), torch.from_numpy(kn).to(td),
            torch.from_numpy(vn).to(td),
            torch.tensor(k_len, dtype=torch.int32), torch.from_numpy(mask),
            torch.from_numpy(ks), torch.from_numpy(vs), group=BLOCK)
        assert got.dtype == torch.float32 and got.shape == (HKV, gt, D)
        tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
        _assert_close_up_to_flips(got.numpy(), _np(want), tol, vs.max(),
                                  err_msg=f"k_len={k_len}")


def test_int8_wrapper_on_cpu_is_plain_at_kernel_group():
    """On a CPU tensor the int8 wrapper runs its plain version at the CUDA
    kernel's group, bit for bit; the group changes the result (p is
    re-quantized per group), within a few percent of the output scale."""
    q, kn, vn, k8, ks, v8, vs = (torch.from_numpy(a) for a in
                                 _b1_inputs(8, 3, "float32"))
    mask = tfd.causal_mask(8, 8, 1, "cpu")
    kl = torch.tensor(300, dtype=torch.int32)
    args = (q, k8, v8, kn, vn, kl, mask, ks, vs)
    got = tfd.flash_decode_append_int8(*args)
    want = tfd.flash_decode_append_int8_plain(*args,
                                              group=tfd.KERNEL_GROUP)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    other = tfd.flash_decode_append_int8_plain(*args, group=BLOCK)
    gap = (other - got).abs().max().item()
    assert 0 < gap < 3e-2 * got.abs().max().item()
    assert tfd.flash_decode_append_int8.launches == 0   # no kernel on CPU


def test_int8_stale_tail_never_read():
    """Codes and scales at or past k_len must not contribute."""
    q, kn, vn, k8, ks, v8, vs = (torch.from_numpy(a) for a in
                                 _b1_inputs(1, 4, "float32"))
    mask = torch.ones((1, 1), dtype=torch.bool)
    kl = torch.tensor(120, dtype=torch.int32)
    clean = tfd.flash_decode_append_int8(q, k8, v8, kn, vn, kl, mask, ks, vs)
    k8p, v8p, ksp, vsp = k8.clone(), v8.clone(), ks.clone(), vs.clone()
    k8p[:, 120:], v8p[:, 120:] = 127, -127
    ksp[:, 120:], vsp[:, 120:] = 1e3, 1e3
    dirty = tfd.flash_decode_append_int8(q, k8p, v8p, kn, vn, kl, mask, ksp,
                                         vsp)
    torch.testing.assert_close(clean, dirty, rtol=0, atol=0)


def test_auto_dispatch_int8_cpu_matches_jax_xla_path():
    """append_attention_auto with an int8 cache on the CPU runs the
    dequantizing partials path, as JAX does off the TPU (fp32)."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((1, 4, 3, D)).astype(np.float32)
    kn = rng.standard_normal((1, HKV, 3, D)).astype(np.float32)
    vn = rng.standard_normal((1, HKV, 3, D)).astype(np.float32)
    k8, ks = _codes(rng, 1, HKV, S, D)
    v8, vs = _codes(rng, 1, HKV, S, D)
    for k_len, block in ((100, 2048), (300, 128)):
        want = jatt.append_attention(
            *[jnp.asarray(a) for a in (q, k8, v8, kn, vn)],
            k_len=jnp.asarray(k_len), block=block, k_scale=jnp.asarray(ks),
            v_scale=jnp.asarray(vs))
        got = tatt.append_attention_auto(
            *[torch.from_numpy(a) for a in (q, k8, v8, kn, vn)],
            k_len=torch.tensor(k_len), block=block,
            k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


# ---------------------------------------------------------------------------
# kernel B2-int8: plain version vs the Pallas quant branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,prefill", [(1, 512), (2, 384), (4, 256)])
def test_chunk_scores_int8_plain_matches_pallas(g, prefill):
    """q quantized per (head, row) with no bf16 cast; i32 dots exact on
    both sides, so only the scale products and means differ in rounding
    (1e-5 of the score scale)."""
    chunk = 8
    rng = np.random.default_rng(g * 100 + prefill)
    q = rng.standard_normal((HKV, g, 64)).astype(np.float32)
    k8, ks = _codes(rng, HKV, S, 64)
    want = chunk_scores_pallas(jnp.asarray(q), jnp.asarray(k8), chunk=chunk,
                               prefill=prefill, block=128, interpret=True,
                               k_scale=jnp.asarray(ks))
    got = trk.chunk_scores_int8(torch.from_numpy(q), torch.from_numpy(k8),
                                torch.from_numpy(ks), chunk=chunk,
                                prefill=prefill)
    assert got.shape == (HKV, prefill // chunk) and got.dtype == torch.float32
    scale = np.abs(_np(want)).max()
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                               atol=1e-5 * scale)
    assert trk.chunk_scores_int8.launches == 0


def test_chunk_scores_int8_cpu_dispatch_is_the_xla_path():
    """On the CPU the retrieval build scores an int8 cache like JAX's
    off-TPU path: dequantized keys, fp32 q."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, HKV * 2, 1, D)).astype(np.float32)
    k8, ks = _codes(rng, 1, HKV, S, D)
    want = jret.chunk_scores(jnp.asarray(q), jnp.asarray(k8), 384, 4,
                             k_scale=jnp.asarray(ks))
    got = tret.chunk_scores(torch.from_numpy(q), torch.from_numpy(k8), 384, 4,
                            k_scale=torch.from_numpy(ks))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


# ---------------------------------------------------------------------------
# forwards, build and tail refresh over int8 caches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def target():
    pj = jl.init_params(jax.random.PRNGKey(0), jcfg.TINY_TARGET,
                        dtype=jnp.float32)
    pt = tl.params_from_numpy(jax.tree.map(np.asarray, pj),
                              jcfg.TINY_TARGET, "cpu")
    return pj, pt


def _ids(n, seed=0):
    return np.random.default_rng(seed).integers(0, 199, (1, n))


def _check_cache(tc, jc, n=None):
    """Codes equal and scales within fp32 tolerance over the first n
    slots (all when None)."""
    sl = slice(None) if n is None else slice(0, n)
    np.testing.assert_array_equal(tc.k[:, :, :, sl].numpy(),
                                  _np(jc.k[:, :, :, sl]))
    np.testing.assert_array_equal(tc.v[:, :, :, sl].numpy(),
                                  _np(jc.v[:, :, :, sl]))
    np.testing.assert_allclose(tc.k_scale[:, :, :, sl].numpy(),
                               _np(jc.k_scale[:, :, :, sl]), **TOL)
    np.testing.assert_allclose(tc.v_scale[:, :, :, sl].numpy(),
                               _np(jc.v_scale[:, :, :, sl]), **TOL)


def test_forward_append_int8_cache_logits_codes_and_scales(target):
    """T in {prefill chunk, 1, gamma+2}, chained on one int8 cache, then a
    rollback and re-append: logits (fp32 tolerance), committed codes
    (equal) and scales."""
    pj, pt = target
    ids = _ids(40, 2)
    kvj = jcache.init_kv(jcfg.TINY_TARGET, 64, quant=True)
    kvt = tcache.init_kv(tcfg.TINY_TARGET, 64, device="cpu", quant=True)
    for sl in (slice(0, 16), slice(16, 17), slice(17, 22)):
        lj, kvj, _ = jl.forward_append(jcfg.TINY_TARGET, pj,
                                       jnp.asarray(ids[:, sl]), kvj)
        lt, kvt, _ = tl.forward_append(tcfg.TINY_TARGET, pt,
                                       torch.from_numpy(ids[:, sl]), kvt)
        np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
        _check_cache(kvt, kvj)
    kvj, kvt = kvj.rollback(3), kvt.rollback(3)
    lj, kvj, _ = jl.forward_append(jcfg.TINY_TARGET, pj,
                                   jnp.asarray(ids[:, 30:32]), kvj)
    lt, kvt, _ = tl.forward_append(tcfg.TINY_TARGET, pt,
                                   torch.from_numpy(ids[:, 30:32]), kvt)
    np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
    _check_cache(kvt, kvj)


def test_int8_retrieval_build_and_forward_spec(target):
    """The build over an int8 cache selects the same chunks and gathers
    codes and scales alike; forward_spec over the int8 retrieval cache
    matches, with and without its quantized scratch commit."""
    pj, pt = target
    prefill = 32
    ids = _ids(prefill + 4, 1)
    jspec, tspec = jcfg.SpecConfig(**SPEC_KW), tcfg.SpecConfig(**SPEC_KW)
    kvj = jcache.init_kv(jcfg.TINY_TARGET, 64, quant=True)
    kvt = tcache.init_kv(tcfg.TINY_TARGET, 64, device="cpu", quant=True)
    _, kvj, _ = jl.forward_append(jcfg.TINY_TARGET, pj,
                                  jnp.asarray(ids[:, :prefill - 1]), kvj)
    _, kvt, _ = tl.forward_append(tcfg.TINY_TARGET, pt,
                                  torch.from_numpy(ids[:, :prefill - 1]), kvt)
    rj = jcache.init_retrieval(jcfg.TINY_TARGET, jspec, quant=True)
    rt = tcache.init_retrieval(tcfg.TINY_TARGET, tspec, device="cpu",
                               quant=True)
    last = ids[:, prefill - 1:prefill]
    lj, kvj, rj = jl.forward_append(jcfg.TINY_TARGET, pj, jnp.asarray(last),
                                    kvj, build_rkv=rj, prefill=prefill,
                                    chunk_size=4, budget=16)
    lt, kvt, rt = tl.forward_append(tcfg.TINY_TARGET, pt,
                                    torch.from_numpy(last), kvt,
                                    build_rkv=rt, prefill=prefill,
                                    chunk_size=4, budget=16)
    np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
    _check_cache(rt, rj)

    vt = ids[:, prefill:prefill + 4]
    for commit in (False, True):
        mj, rj2 = jl.forward_spec(jcfg.TINY_TARGET, pj, jnp.asarray(vt), rj,
                                  kvj.seq_len, 16, commit=commit)
        mt, rt2 = tl.forward_spec(tcfg.TINY_TARGET, pt, torch.from_numpy(vt),
                                  rt, kvt.seq_len, 16, commit=commit)
        np.testing.assert_allclose(mt.numpy(), _np(mj), **TOL)
        _check_cache(rt2, rj2)


def test_build_layer_int8_selects_and_gathers_codes_and_scales():
    hkv, g, s, d, chunk, prefill, budget = 2, 2, 96, 16, 4, 64, 32
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, hkv * g, 1, d)).astype(np.float32)
    k8, ks = _codes(rng, 1, hkv, s, d)
    v8, vs = _codes(rng, 1, hkv, s, d)
    want = jret.build_layer(*[jnp.asarray(a) for a in (q, k8, v8)], prefill,
                            chunk, budget, k_scale=jnp.asarray(ks),
                            v_scale=jnp.asarray(vs))
    got = tret.build_layer(*[torch.from_numpy(a) for a in (q, k8, v8)],
                           prefill, chunk, budget,
                           k_scale=torch.from_numpy(ks),
                           v_scale=torch.from_numpy(vs))
    assert len(got) == 4 and got[0].dtype == torch.int8
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), _np(b))


def test_tail_refresh_moves_codes_and_scales_across_budget_wrap():
    """Enough refreshes to wrap the rolling budget window twice over an
    int8 full cache: codes and scales of the retrieval cache stay equal to
    the JAX ones."""
    gamma, budget, prefill = 2, 8, 16
    spec_kw = dict(gamma=gamma, budget=budget, chunk_size=4)
    jspec, tspec = jcfg.SpecConfig(**spec_kw), tcfg.SpecConfig(**spec_kw)
    L, hkv, d, s = 2, 2, 4, 64
    rng = np.random.default_rng(0)
    fk, fks = _codes(rng, L, 1, hkv, s, d)
    fv, fvs = _codes(rng, L, 1, hkv, s, d)
    rk, rks = _codes(rng, L, 1, hkv, budget + gamma + 1, d)
    jr = jcache.RetrievalCache(k=jnp.asarray(rk), v=jnp.asarray(-rk),
                               k_scale=jnp.asarray(rks),
                               v_scale=jnp.asarray(2 * rks))
    tr = tcache.RetrievalCache(k=torch.from_numpy(rk.copy()),
                               v=torch.from_numpy(-rk),
                               k_scale=torch.from_numpy(rks.copy()),
                               v_scale=torch.from_numpy(2 * rks))
    seq = prefill
    for i in range(12):
        old, seq = seq, seq + 1 + (i * 5) % (gamma + 2)
        jkv = jcache.KVCache(k=jnp.asarray(fk), v=jnp.asarray(fv),
                             seq_len=jnp.asarray(seq, jnp.int32),
                             k_scale=jnp.asarray(fks),
                             v_scale=jnp.asarray(fvs))
        tkv = tcache.KVCache(torch.from_numpy(fk), torch.from_numpy(fv),
                             torch.tensor(seq, dtype=torch.int32),
                             torch.from_numpy(fks), torch.from_numpy(fvs))
        jr = jcache.retrieval_tail_refresh(jr, jkv, jspec, prefill,
                                           jnp.asarray(old, jnp.int32))
        tr = tcache.retrieval_tail_refresh(tr, tkv, tspec, prefill,
                                           torch.tensor(old))
        for name in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                          _np(getattr(jr, name)),
                                          err_msg=f"refresh {i} {name}")
    assert seq - prefill > 2 * budget


# ---------------------------------------------------------------------------
# Engine with kv_quant: near-greedy oracle (see tests/test_torch_engine.py)
# ---------------------------------------------------------------------------

PREFILL, GEN = 32, 16
ENGINE_SPEC = dict(SPEC_KW, temperature=1e-4, top_p=0.9)


@pytest.fixture(scope="module")
def kvq_engines():
    pj = jl.init_params(jax.random.PRNGKey(0), jcfg.TINY_TARGET,
                        dtype=jnp.float32)
    dj = jl.init_params(jax.random.PRNGKey(1), jcfg.TINY_DRAFT,
                        dtype=jnp.float32)
    pt = tl.params_from_numpy(jax.tree.map(np.asarray, pj),
                              tcfg.TINY_TARGET, "cpu")
    dt = tl.params_from_numpy(jax.tree.map(np.asarray, dj),
                              tcfg.TINY_DRAFT, "cpu")
    common = dict(prefill=PREFILL, max_cache_len=PREFILL + 64,
                  prefill_chunk=16, draft_prefill_chunk=8, kv_quant=True)
    je = JEngine(jcfg.TINY_TARGET, jcfg.SpecConfig(**ENGINE_SPEC), pj,
                 draft_cfg=jcfg.TINY_DRAFT, draft_params=dj,
                 dtype=jnp.float32, donate=False, **common)
    te = TEngine(tcfg.TINY_TARGET, tcfg.SpecConfig(**ENGINE_SPEC), pt,
                 draft_cfg=tcfg.TINY_DRAFT, draft_params=dt,
                 dtype=torch.float32, device="cpu", **common)
    # a prompt whose JAX runs agree under several sampling seeds: no near
    # tie between top logits, so every draw is one-hot
    ids = np.random.default_rng(2).integers(0, 199, (1, PREFILL))
    return je, te, ids


@pytest.mark.parametrize("mode", ["ar", "retrieval", "triforce"])
def test_engine_kv_quant_token_and_counter_identity(kvq_engines, mode):
    je, te, ids = kvq_engines
    fns = {"ar": (jdec.autoregressive, tdec.autoregressive),
           "retrieval": (jdec.retrieval_spec, tdec.retrieval_spec),
           "triforce": (jdec.triforce, tdec.triforce)}[mode]
    jr = fns[0](je, jnp.asarray(ids), max_len=GEN, seed=9)
    tr = fns[1](te, torch.from_numpy(ids), max_len=GEN, seed=9,
                device="cpu")
    assert jr.tokens == tr.tokens
    assert jr.steps == tr.steps
    if mode != "ar":
        assert jr.acceptance_rate == tr.acceptance_rate
        assert jr.middle_acceptance_rate == tr.middle_acceptance_rate


def test_engine_kv_quant_states_match(kvq_engines):
    """After prefill and a few TriForce steps: int8 full cache (live
    prefix), retrieval cache codes and scales, counters and next token."""
    je, te, ids = kvq_engines
    js = je.init_state(jax.random.PRNGKey(100))
    js = je.prefill_draft(je.prefill_target(js, jnp.asarray(ids)),
                          jnp.asarray(ids))
    ts = te.init_state(100)
    ts = te.prefill_draft(te.prefill_target(ts, torch.from_numpy(ids)),
                          torch.from_numpy(ids))
    assert ts.kv.k.dtype == torch.int8 and ts.rkv.quantized
    assert ts.dkv.k.dtype == torch.float32          # drafter stays float
    _check_cache(ts.rkv, js.rkv)
    jst, jbuf, jn, jcnt, _ = je.generate(js, GEN, mode="triforce")
    tst, tbuf, tn, tcnt = te.generate(ts, GEN, mode="triforce")
    assert int(jn) == tn
    assert _np(jbuf)[:tn].tolist() == tbuf[:tn].tolist()
    assert _np(jcnt).tolist() == tcnt.tolist()
    n_live = int(jst.kv.seq_len)
    assert int(tst.kv.seq_len) == n_live
    _check_cache(tst.kv, jst.kv, n_live)
    _check_cache(tst.rkv, jst.rkv, SPEC_KW["budget"])
