"""INT8 weights: the port against the JAX package on the CPU.

Covers ``quantize_weights`` / ``dequant_weights``, the int8 branch of
``_wmm`` in fp32 and bf16, loading JAX-quantized params, forwards over
int8 weights, and the Engine with ``weight_quant`` (alone and with
``kv_quant``) under the near-greedy oracle of tests/test_torch_engine.py.
Inputs are numpy arrays from a seed; each test states its tolerance.
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
from triforce_tpu_torch import cache as tcache
from triforce_tpu_torch import config as tcfg
from triforce_tpu_torch import decoding as tdec
from triforce_tpu_torch.engine import Engine as TEngine
from triforce_tpu_torch.models import llama as tl

torch.set_num_threads(1)

# fp32 arithmetic of the same inputs summed in another order
TOL = dict(rtol=2e-5, atol=2e-5)
MATMULS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _np(x):
    return np.array(x)


@pytest.fixture(scope="module")
def params():
    pj = jl.init_params(jax.random.PRNGKey(0), jcfg.TINY_TARGET,
                        dtype=jnp.float32)
    pt = tl.params_from_numpy(jax.tree.map(np.asarray, pj),
                              tcfg.TINY_TARGET, "cpu")
    return pj, pt


def _ids(n, seed=0):
    return np.random.default_rng(seed).integers(0, 199, (1, n))


def test_quantize_weights_matches_jax(params):
    """Per-output-channel codes and scales equal JAX's bit for bit (the
    same fp32 max / 127 and round half to even); the embedding and norms
    are untouched."""
    pj, pt = params
    qj, qt = jl.quantize_weights(pj), tl.quantize_weights(pt)
    for name in MATMULS:
        assert qt["layers"][name].dtype == torch.int8
        np.testing.assert_array_equal(qt["layers"][name].numpy(),
                                      _np(qj["layers"][name]))
        np.testing.assert_array_equal(qt["layers"][name + "_scale"].numpy(),
                                      _np(qj["layers"][name + "_scale"]))
    np.testing.assert_array_equal(qt["lm_head"].numpy(), _np(qj["lm_head"]))
    np.testing.assert_array_equal(qt["lm_head_scale"].numpy(),
                                  _np(qj["lm_head_scale"]))
    assert qt["embed"] is pt["embed"]
    assert qt["layers"]["ln_attn"] is pt["layers"]["ln_attn"]


def test_params_from_numpy_loads_int8_weights_and_forward_matches(params):
    """JAX-quantized params load with their codes and scales; a forward
    over them matches JAX's (fp32 tolerance) and the port's own
    quantization of the same weights, bit for bit."""
    pj, pt = params
    qj = jl.quantize_weights(pj)
    lt_params = tl.params_from_numpy(jax.tree.map(np.asarray, qj),
                                     tcfg.TINY_TARGET, "cpu")
    assert lt_params["layers"]["wq"].dtype == torch.int8
    assert lt_params["layers"]["wq_scale"].dtype == torch.float32
    assert lt_params["lm_head_scale"].dtype == torch.float32
    ids = _ids(24, 1)
    kvj = jcache.init_kv(jcfg.TINY_TARGET, 32, dtype=jnp.float32)
    lj, kvj, _ = jl.forward_append(jcfg.TINY_TARGET, qj, jnp.asarray(ids),
                                   kvj)
    outs = []
    for p in (lt_params, tl.quantize_weights(pt)):
        kvt = tcache.init_kv(tcfg.TINY_TARGET, 32, dtype=torch.float32,
                             device="cpu")
        lt, kvt, _ = tl.forward_append(tcfg.TINY_TARGET, p,
                                       torch.from_numpy(ids), kvt)
        np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
        np.testing.assert_allclose(kvt.k.numpy(), _np(kvj.k), **TOL)
        outs.append(lt)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_params_from_numpy_rejects_unknown_layer_keys(params):
    pj, _ = params
    tree = jax.tree.map(np.asarray, pj)
    tree["layers"]["w_bogus"] = tree["layers"]["wq"]
    with pytest.raises(ValueError, match="unknown"):
        tl.params_from_numpy(tree, tcfg.TINY_TARGET, "cpu")


def test_dequant_weights_forwards_bitwise_identical(params):
    """dequant_weights converts the codes exactly and keeps the scales, so
    forwards over the result are bit-identical to the int8 path (logits
    and the committed cache, int8 cache included); weights that are not
    int8 pass through unchanged."""
    _, pt = params
    qt = tl.quantize_weights(pt)
    dt = tl.dequant_weights(qt, torch.float32)
    assert dt["layers"]["wq"].dtype == torch.float32
    assert "wq_scale" in dt["layers"] and dt["lm_head"].dtype == torch.float32
    ids = torch.from_numpy(_ids(24, 2))
    for quant in (False, True):
        res = []
        for p in (qt, dt):
            kv = tcache.init_kv(tcfg.TINY_TARGET, 32, dtype=torch.float32,
                                device="cpu", quant=quant)
            lg, kv, _ = tl.forward_append(tcfg.TINY_TARGET, p, ids, kv)
            res.append((lg, kv.k))
        torch.testing.assert_close(res[0][0], res[1][0], rtol=0, atol=0)
        torch.testing.assert_close(res[0][1], res[1][1], rtol=0, atol=0)
    same = tl.dequant_weights(pt, torch.float32)
    assert same["layers"]["wq"] is pt["layers"]["wq"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wmm_int8_matches_jax(dtype):
    """The int8 branch of _wmm: codes converted to x's dtype, the scale
    multiplying the output in the output dtype (x's for the layers, fp32
    for lm_head). fp32: summation order only (2e-5). bf16: the two
    frameworks round the bf16 GEMM output and the product with the
    bf16-rounded scale in their own order, one bf16 ulp (2^-8) apart at
    most, hence 1e-2 relative."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 5, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.05).astype(np.float32)
    s = np.maximum(np.abs(w).max(0) / 127.0, 1e-8).astype(np.float32)
    codes = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    lpj = {"w": jnp.asarray(codes), "w_scale": jnp.asarray(s)}
    lpt = {"w": torch.from_numpy(codes), "w_scale": torch.from_numpy(s)}
    xj, xt = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    want = jl._wmm(xj, "bth,hd->btd", lpj, "w")
    got = tl._wmm(xt, lpt, "w")
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               _np(want.astype(jnp.float32)), **tol)
    want = jl._wmm(xj, "bth,hd->btd", lpj, "w", pet=jnp.float32)
    got = tl._wmm(xt, lpt, "w", out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), **tol)


# ---------------------------------------------------------------------------
# Engine with weight_quant: near-greedy oracle (see test_torch_engine.py)
# ---------------------------------------------------------------------------

SPEC_KW = dict(gamma=3, budget=16, chunk_size=4, draft_start_size=4,
               draft_recent_size=12, temperature=1e-4, top_p=0.9)
PREFILL, GEN = 32, 16


def _engine_pair(kv_quant):
    pj = jl.init_params(jax.random.PRNGKey(0), jcfg.TINY_TARGET,
                        dtype=jnp.float32)
    dj = jl.init_params(jax.random.PRNGKey(1), jcfg.TINY_DRAFT,
                        dtype=jnp.float32)
    pt = tl.params_from_numpy(jax.tree.map(np.asarray, pj),
                              tcfg.TINY_TARGET, "cpu")
    dt = tl.params_from_numpy(jax.tree.map(np.asarray, dj),
                              tcfg.TINY_DRAFT, "cpu")
    common = dict(prefill=PREFILL, max_cache_len=PREFILL + 64,
                  prefill_chunk=16, draft_prefill_chunk=8,
                  weight_quant=True, kv_quant=kv_quant)
    je = JEngine(jcfg.TINY_TARGET, jcfg.SpecConfig(**SPEC_KW), pj,
                 draft_cfg=jcfg.TINY_DRAFT, draft_params=dj,
                 dtype=jnp.float32, donate=False, **common)
    te = TEngine(tcfg.TINY_TARGET, tcfg.SpecConfig(**SPEC_KW), pt,
                 draft_cfg=tcfg.TINY_DRAFT, draft_params=dt,
                 dtype=torch.float32, device="cpu", **common)
    return je, te


@pytest.fixture(scope="module", params=[False, True],
                ids=["weights", "weights+kv"])
def wq_engines(request):
    return _engine_pair(request.param)


def test_engine_weight_quant_quantizes_target_and_drafter(wq_engines):
    je, te = wq_engines
    for p, q in ((te.t_params, je.t_params), (te.d_params, je.d_params)):
        assert p["layers"]["wq"].dtype == torch.int8
        np.testing.assert_array_equal(p["layers"]["w_up"].numpy(),
                                      _np(q["layers"]["w_up"]))
        np.testing.assert_array_equal(p["lm_head_scale"].numpy(),
                                      _np(q["lm_head_scale"]))


@pytest.mark.parametrize("mode", ["ar", "retrieval", "triforce"])
def test_engine_weight_quant_token_and_counter_identity(wq_engines, mode):
    """A prompt whose JAX runs agree under several sampling seeds (no near
    tie between top logits): tokens, steps and both acceptance rates
    equal JAX's."""
    je, te = wq_engines
    ids = np.random.default_rng(2).integers(0, 199, (1, PREFILL))
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
