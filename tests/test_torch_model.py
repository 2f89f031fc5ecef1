"""The port's model forwards and sampling ops against the JAX package on the
tiny configs in fp32, with the same numpy weights (JAX ``init_params``
through ``params_from_numpy``) and the same token ids.

Tolerances: fp32 end to end, the two frameworks differ only in summation
order, so logits agree to ~1e-6 (2e-5 allowed) and caches likewise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triforce_tpu import cache as jcache
from triforce_tpu import config as jcfg
from triforce_tpu.models import llama as jl
from triforce_tpu.ops import sampling as jsamp
from triforce_tpu_torch import cache as tcache
from triforce_tpu_torch import config as tcfg
from triforce_tpu_torch.models import llama as tl
from triforce_tpu_torch.ops import sampling as tsamp

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
SPEC_KW = dict(gamma=3, budget=16, chunk_size=4, draft_start_size=4,
               draft_recent_size=12)


def _np(x):
    return np.array(x)


@pytest.fixture(scope="module")
def target():
    pj = jl.init_params(jax.random.PRNGKey(0), jcfg.TINY_TARGET,
                        dtype=jnp.float32)
    pt = tl.params_from_numpy(jax.tree.map(np.asarray, pj),
                              tcfg.TINY_TARGET, "cpu")
    return pj, pt


@pytest.fixture(scope="module")
def draft():
    pj = jl.init_params(jax.random.PRNGKey(1), jcfg.TINY_DRAFT,
                        dtype=jnp.float32)
    pt = tl.params_from_numpy(jax.tree.map(np.asarray, pj),
                              tcfg.TINY_DRAFT, "cpu")
    return pj, pt


def _ids(n, seed=0):
    return np.random.default_rng(seed).integers(0, 199, (1, n))


def test_params_from_numpy_keeps_layout_and_bf16(target):
    pj, pt = target
    np.testing.assert_array_equal(pt["layers"]["wq"].numpy(),
                                  _np(pj["layers"]["wq"]))
    pb = jl.init_params(jax.random.PRNGKey(0), jcfg.TINY_TARGET,
                        dtype=jnp.bfloat16)
    tb = tl.params_from_numpy(jax.tree.map(np.asarray, pb),
                              tcfg.TINY_TARGET, "cpu", dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        tb["lm_head"].float().numpy(),
        _np(pb["lm_head"].astype(jnp.float32)))


def test_forward_append_logits_and_cache(target):
    """T in {prefill chunk, 1, gamma+2}, chained on one cache."""
    pj, pt = target
    ids = _ids(40)
    kvj = jcache.init_kv(jcfg.TINY_TARGET, 64, dtype=jnp.float32)
    kvt = tcache.init_kv(tcfg.TINY_TARGET, 64, dtype=torch.float32,
                         device="cpu")
    for sl in (slice(0, 16), slice(16, 17), slice(17, 22)):
        lj, kvj, _ = jl.forward_append(jcfg.TINY_TARGET, pj,
                                       jnp.asarray(ids[:, sl]), kvj)
        lt, kvt, _ = tl.forward_append(tcfg.TINY_TARGET, pt,
                                       torch.from_numpy(ids[:, sl]), kvt)
        np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
        np.testing.assert_allclose(kvt.k.numpy(), _np(kvj.k), **TOL)
        np.testing.assert_allclose(kvt.v.numpy(), _np(kvj.v), **TOL)
        assert int(kvt.seq_len) == int(kvj.seq_len)
    # rollback then re-append overwrites the rolled-back slots
    kvj, kvt = kvj.rollback(3), kvt.rollback(3)
    lj, kvj, _ = jl.forward_append(jcfg.TINY_TARGET, pj,
                                   jnp.asarray(ids[:, 30:32]), kvj)
    lt, kvt, _ = tl.forward_append(tcfg.TINY_TARGET, pt,
                                   torch.from_numpy(ids[:, 30:32]), kvt)
    np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
    np.testing.assert_allclose(kvt.k.numpy(), _np(kvj.k), **TOL)


def test_forward_append_commit_clamps_at_cache_end(target):
    """An append that would run past the cache end: JAX clamps the write
    start to S - T, and the port reproduces it."""
    pj, pt = target
    ids = _ids(12, 4)
    kvj = jcache.init_kv(jcfg.TINY_TARGET, 8, dtype=jnp.float32)
    kvt = tcache.init_kv(tcfg.TINY_TARGET, 8, dtype=torch.float32,
                         device="cpu")
    for sl in (slice(0, 6), slice(6, 10)):
        lj, kvj, _ = jl.forward_append(jcfg.TINY_TARGET, pj,
                                       jnp.asarray(ids[:, sl]), kvj)
        lt, kvt, _ = tl.forward_append(tcfg.TINY_TARGET, pt,
                                       torch.from_numpy(ids[:, sl]), kvt)
    np.testing.assert_allclose(kvt.k.numpy(), _np(kvj.k), **TOL)
    np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)


def test_build_forward_retrieval_cache_and_forward_spec(target):
    pj, pt = target
    prefill = 32
    ids = _ids(prefill + 4, 1)
    jspec, tspec = jcfg.SpecConfig(**SPEC_KW), tcfg.SpecConfig(**SPEC_KW)
    kvj = jcache.init_kv(jcfg.TINY_TARGET, 64, dtype=jnp.float32)
    kvt = tcache.init_kv(tcfg.TINY_TARGET, 64, dtype=torch.float32,
                         device="cpu")
    _, kvj, _ = jl.forward_append(jcfg.TINY_TARGET, pj,
                                  jnp.asarray(ids[:, :prefill - 1]), kvj)
    _, kvt, _ = tl.forward_append(tcfg.TINY_TARGET, pt,
                                  torch.from_numpy(ids[:, :prefill - 1]), kvt)
    rj = jcache.init_retrieval(jcfg.TINY_TARGET, jspec, dtype=jnp.float32)
    rt = tcache.init_retrieval(tcfg.TINY_TARGET, tspec, dtype=torch.float32,
                               device="cpu")
    lj, kvj, rj = jl.forward_append(
        jcfg.TINY_TARGET, pj, jnp.asarray(ids[:, prefill - 1:prefill]), kvj,
        build_rkv=rj, prefill=prefill, chunk_size=4, budget=16)
    lt, kvt, rt = tl.forward_append(
        tcfg.TINY_TARGET, pt, torch.from_numpy(ids[:, prefill - 1:prefill]),
        kvt, build_rkv=rt, prefill=prefill, chunk_size=4, budget=16)
    np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
    np.testing.assert_allclose(rt.k.numpy(), _np(rj.k), **TOL)
    np.testing.assert_allclose(rt.v.numpy(), _np(rj.v), **TOL)

    vt = ids[:, prefill:prefill + 4]
    for commit in (False, True):
        mj, rj2 = jl.forward_spec(jcfg.TINY_TARGET, pj, jnp.asarray(vt), rj,
                                  kvj.seq_len, 16, commit=commit)
        mt, rt2 = tl.forward_spec(tcfg.TINY_TARGET, pt, torch.from_numpy(vt),
                                  rt, kvt.seq_len, 16, commit=commit)
        np.testing.assert_allclose(mt.numpy(), _np(mj), **TOL)
        np.testing.assert_allclose(rt2.k.numpy(), _np(rj2.k), **TOL)
    # dead-trip gate: kv_seq_len 0 reads no retrieval column
    mj, _ = jl.forward_spec(jcfg.TINY_TARGET, pj, jnp.asarray(vt), rj,
                            jnp.asarray(0, jnp.int32), 16, commit=False)
    mt, _ = tl.forward_spec(tcfg.TINY_TARGET, pt, torch.from_numpy(vt), rt,
                            torch.tensor(0, dtype=torch.int32), 16,
                            commit=False)
    np.testing.assert_allclose(mt.numpy(), _np(mj), **TOL)


def test_draft_forwards_across_eviction_crossings(draft):
    """Drafter prefill in chunks past the sink+window capacity (several
    evictions), then spec forwards + compaction: logits and caches equal."""
    pj, pt = draft
    jspec, tspec = jcfg.SpecConfig(**SPEC_KW), tcfg.SpecConfig(**SPEC_KW)
    dj = jcache.init_streaming(jcfg.TINY_DRAFT, jspec, dtype=jnp.float32)
    dt = tcache.init_streaming(tcfg.TINY_DRAFT, tspec, dtype=torch.float32,
                               device="cpu")
    ids = _ids(48, 2)
    chunk = 6
    for i in range(0, 48, chunk):
        dj = jcache.streaming_evict_prefill(dj, jspec, chunk)
        dt = tcache.streaming_evict_prefill(dt, tspec, chunk)
        lj, dj = jl.draft_forward(jcfg.TINY_DRAFT, pj,
                                  jnp.asarray(ids[:, i:i + chunk]), dj)
        lt, dt = tl.draft_forward(tcfg.TINY_DRAFT, pt,
                                  torch.from_numpy(ids[:, i:i + chunk]), dt)
        np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
        np.testing.assert_allclose(dt.k.numpy(), _np(dj.k), **TOL)
        assert int(dt.seq_len) == int(dj.seq_len)
    for count in (2, 0, 4):
        sp = _ids(SPEC_KW["gamma"] + 3, count)
        for commit in (False, True):
            lj, dj2 = jl.draft_forward_spec(jcfg.TINY_DRAFT, pj,
                                            jnp.asarray(sp), dj, jspec,
                                            commit=commit)
            lt, dt2 = tl.draft_forward_spec(tcfg.TINY_DRAFT, pt,
                                            torch.from_numpy(sp), dt, tspec,
                                            commit=commit)
            np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
        dj = jcache.streaming_evict_for_spec(dj2, jspec, jnp.asarray(count))
        dt = tcache.streaming_evict_for_spec(dt2, tspec, torch.tensor(count))
        np.testing.assert_allclose(dt.k.numpy(), _np(dj.k), **TOL)
        np.testing.assert_allclose(dt.v.numpy(), _np(dj.v), **TOL)


@pytest.mark.parametrize("sort_topp", [False, True])
@pytest.mark.parametrize("temperature,top_k,top_p",
                         [(0.6, -1, 0.9), (1.0, 20, 0.95), (0.05, -1, 0.9)])
def test_norm_logits_matches(monkeypatch, sort_topp, temperature, top_k,
                             top_p):
    """Filtered probabilities within fp32 tolerance (fast grid top-p and the
    sort-based filter, selected by TRIFORCE_SORT_TOPP like the JAX one)."""
    if sort_topp:
        monkeypatch.setenv("TRIFORCE_SORT_TOPP", "1")
    else:
        monkeypatch.delenv("TRIFORCE_SORT_TOPP", raising=False)
    x = np.random.default_rng(0).standard_normal((4, 199)).astype(
        np.float32) * 2
    want = jsamp.norm_logits(jnp.asarray(x), temperature, top_k, top_p)
    got = tsamp.norm_logits(torch.from_numpy(x), temperature, top_k, top_p)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-6)
    # the kept support is the same set of tokens
    np.testing.assert_array_equal(got.numpy() > 0, _np(want) > 0)


def test_top_k_filter_and_max_fn_match():
    x = np.random.default_rng(1).standard_normal((3, 50)).astype(np.float32)
    np.testing.assert_array_equal(
        tsamp.top_k_filter(torch.from_numpy(x), 7).numpy(),
        _np(jsamp.top_k_filter(jnp.asarray(x), 7)))
    np.testing.assert_allclose(
        tsamp.max_fn(torch.from_numpy(x)).numpy(),
        _np(jsamp.max_fn(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    zero = np.full((1, 5), -1.0, np.float32)   # all-rejected corner
    np.testing.assert_array_equal(tsamp.max_fn(torch.from_numpy(zero)).numpy(),
                                  _np(jsamp.max_fn(jnp.asarray(zero))))


def test_sample_follows_the_distribution():
    """Gumbel-max on a torch Generator: the draw frequencies follow the
    probabilities (tokens outside the support never appear)."""
    p = torch.tensor([0.5, 0.3, 0.2, 0.0])
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([tsamp.sample(p, gen) for _ in range(4000)])
    freq = torch.bincount(draws, minlength=4).float() / 4000
    assert freq[3] == 0
    torch.testing.assert_close(freq, p, atol=0.03, rtol=0)
