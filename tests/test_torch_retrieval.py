"""Kernel B2 (chunk scoring) and the retrieval build / tail refresh: the
port's plain paths against the JAX package.

The TPU kernel casts q to the cache dtype before scoring; the JAX CPU path
(``chunk_scores_xla``) forms fp32 chunk means first. In fp32 the two agree,
so the port's plain version is held against both there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triforce_tpu import cache as jcache
from triforce_tpu.config import SpecConfig as JSpec
from triforce_tpu.ops import retrieval as jret
from triforce_tpu.ops.retrieval_kernel import chunk_scores_pallas
from triforce_tpu_torch import cache as tcache
from triforce_tpu_torch.config import SpecConfig as TSpec
from triforce_tpu_torch.ops import retrieval as tret
from triforce_tpu_torch.ops import retrieval_kernel as trk

torch.set_num_threads(1)

# fp32 scores of the same inputs, summed in another order
TOL = dict(rtol=1e-5, atol=1e-5)


def _mk(seed, hkv, g, s, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, hkv * g, 1, d)).astype(np.float32)
    k = rng.standard_normal((1, hkv, s, d)).astype(np.float32)
    return q, k


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("prefill", [512, 384])
def test_chunk_scores_plain_matches_pallas_and_xla(g, prefill):
    hkv, s, d, chunk = 2, 512, 64, 8
    q, k = _mk(g * 10 + prefill, hkv, g, s, d)
    qk = q[0].reshape(hkv, g, d)
    want_k = chunk_scores_pallas(jnp.asarray(qk), jnp.asarray(k[0]),
                                 chunk=chunk, prefill=prefill, block=128,
                                 interpret=True)
    want_x = jret.chunk_scores_xla(jnp.asarray(q),
                                   jnp.asarray(k[:, :, :prefill]), chunk)
    got = trk.chunk_scores(torch.from_numpy(qk), torch.from_numpy(k[0]),
                           chunk=chunk, prefill=prefill)
    assert got.shape == (hkv, prefill // chunk) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want_k), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_x[0]), **TOL)
    got_x = tret.chunk_scores_xla(torch.from_numpy(q),
                                  torch.from_numpy(k[:, :, :prefill]), chunk)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **TOL)


def test_chunk_scores_plain_bf16_casts_q_like_the_kernel():
    """bf16 cache: q is cast to bf16 before scoring, as the TPU kernel does
    (products of bf16 values are exact in fp32, so only the sum order
    differs)."""
    hkv, g, s, d, chunk, prefill = 2, 2, 256, 32, 4, 256
    q, k = _mk(5, hkv, g, s, d)
    qk = q[0].reshape(hkv, g, d)
    kb = jnp.asarray(k[0], jnp.bfloat16)
    want = chunk_scores_pallas(jnp.asarray(qk), kb, chunk=chunk,
                               prefill=prefill, block=128, interpret=True)
    got = trk.chunk_scores(torch.from_numpy(qk),
                           torch.from_numpy(k[0]).to(torch.bfloat16),
                           chunk=chunk, prefill=prefill)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_select_gather_and_build_layer_match():
    hkv, g, s, d, chunk, prefill, budget = 2, 2, 96, 16, 4, 64, 32
    q, k = _mk(2, hkv, g, s, d)
    v = np.random.default_rng(9).standard_normal((1, hkv, s, d)).astype(
        np.float32)
    sc_j = jret.chunk_scores_xla(jnp.asarray(q),
                                 jnp.asarray(k[:, :, :prefill]), chunk)
    idx_j = jret.select_chunks(sc_j, budget // chunk)
    idx_t = tret.select_chunks(torch.from_numpy(np.array(sc_j)),
                               budget // chunk)
    # identical index sets in identical order (scores have no ties)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert (idx_t[..., 0] == 0).all()          # chunk 0 pinned first
    ks_j, vs_j = jret.build_layer(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), prefill, chunk, budget)
    ks_t, vs_t = tret.build_layer(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), prefill, chunk, budget)
    np.testing.assert_array_equal(ks_t.numpy(), np.asarray(ks_j))
    np.testing.assert_array_equal(vs_t.numpy(), np.asarray(vs_j))


@pytest.mark.parametrize("max_new", [None, 3])
def test_tail_refresh_wraps_budget_window_like_jax(max_new):
    """Enough refreshes of 1..gamma+2 tokens to wrap the rolling budget
    window more than once; the retrieval cache (budget and scratch slots)
    must stay equal to the JAX one, including its clamped slices."""
    gamma, budget, prefill = 2, 8, 16
    spec_kw = dict(gamma=gamma, budget=budget, chunk_size=4)
    jspec, tspec = JSpec(**spec_kw), TSpec(**spec_kw)
    L, hkv, d, s = 2, 2, 4, 64
    rng = np.random.default_rng(0)
    full = rng.standard_normal((L, 1, hkv, s, d)).astype(np.float32)
    rk0 = rng.standard_normal((L, 1, hkv, budget + gamma + 1, d)).astype(
        np.float32)
    jr = jcache.RetrievalCache(k=jnp.asarray(rk0), v=jnp.asarray(-rk0))
    tr = tcache.RetrievalCache(k=torch.from_numpy(rk0.copy()),
                               v=torch.from_numpy(-rk0))
    jkv = jcache.KVCache(k=jnp.asarray(full), v=jnp.asarray(2 * full),
                         seq_len=jnp.asarray(prefill, jnp.int32))
    tkv = tcache.KVCache(k=torch.from_numpy(full.copy()),
                         v=torch.from_numpy(2 * full),
                         seq_len=torch.tensor(prefill, dtype=torch.int32))
    step_cap = max_new or gamma + 2
    seq = prefill
    for i in range(12):
        new = 1 + (i * 5) % step_cap
        old = seq
        seq += new
        jkv = jkv.replace(seq_len=jnp.asarray(seq, jnp.int32))
        tkv = tcache.KVCache(tkv.k, tkv.v,
                             torch.tensor(seq, dtype=torch.int32))
        jr = jcache.retrieval_tail_refresh(jr, jkv, jspec, prefill,
                                           jnp.asarray(old, jnp.int32),
                                           max_new=max_new)
        tr = tcache.retrieval_tail_refresh(tr, tkv, tspec, prefill,
                                           torch.tensor(old), max_new=max_new)
        np.testing.assert_array_equal(tr.k.numpy(), np.asarray(jr.k),
                                      err_msg=f"refresh {i}")
        np.testing.assert_array_equal(tr.v.numpy(), np.asarray(jr.v))
    assert seq - prefill > 2 * budget        # the window wrapped twice


def test_tail_refresh_clamps_near_cache_end_like_jax():
    """A refresh whose source window would run past the cache end: JAX
    clamps the slice start, and so must the port."""
    spec_kw = dict(gamma=2, budget=8, chunk_size=4)
    L, hkv, d, s, prefill = 1, 1, 2, 20, 8
    rng = np.random.default_rng(1)
    full = rng.standard_normal((L, 1, hkv, s, d)).astype(np.float32)
    rk0 = np.zeros((L, 1, hkv, 11, d), np.float32)
    old, seq = 18, 20                        # 18 + max_new(4) > 20
    jr = jcache.retrieval_tail_refresh(
        jcache.RetrievalCache(k=jnp.asarray(rk0), v=jnp.asarray(rk0)),
        jcache.KVCache(k=jnp.asarray(full), v=jnp.asarray(full),
                       seq_len=jnp.asarray(seq, jnp.int32)),
        JSpec(**spec_kw), prefill, jnp.asarray(old, jnp.int32))
    tr = tcache.retrieval_tail_refresh(
        tcache.RetrievalCache(k=torch.from_numpy(rk0.copy()),
                              v=torch.from_numpy(rk0.copy())),
        tcache.KVCache(k=torch.from_numpy(full), v=torch.from_numpy(full),
                       seq_len=torch.tensor(seq, dtype=torch.int32)),
        TSpec(**spec_kw), prefill, torch.tensor(old))
    np.testing.assert_array_equal(tr.k.numpy(), np.asarray(jr.k))


def test_streaming_evictions_match_jax():
    spec_kw = dict(gamma=2, draft_start_size=2, draft_recent_size=6)
    jspec, tspec = JSpec(**spec_kw), TSpec(**spec_kw)
    rng = np.random.default_rng(3)
    k = rng.standard_normal((1, 1, 1, 2 + 6 + 2 + 3, 2)).astype(np.float32)
    for seq_len, incoming in [(8, 3), (5, 3), (7, 1)]:
        jd = jcache.StreamingCache(k=jnp.asarray(k), v=jnp.asarray(-k),
                                   seq_len=jnp.asarray(seq_len, jnp.int32))
        td = tcache.StreamingCache(k=torch.from_numpy(k.copy()),
                                   v=torch.from_numpy(-k),
                                   seq_len=torch.tensor(seq_len,
                                                        dtype=torch.int32))
        jd = jcache.streaming_evict_prefill(jd, jspec, incoming)
        td = tcache.streaming_evict_prefill(td, tspec, incoming)
        np.testing.assert_array_equal(td.k.numpy(), np.asarray(jd.k))
        assert int(td.seq_len) == int(jd.seq_len)
        jd = jcache.streaming_evict_for_spec(jd, jspec, jnp.asarray(2))
        td = tcache.streaming_evict_for_spec(td, tspec, torch.tensor(2))
        np.testing.assert_array_equal(td.v.numpy(), np.asarray(jd.v))
