"""The graphed prefills on the CPU: the target chunks, the retrieval build
and the drafter chunks as graph regions (``engine.append_graphed``,
``engine.prefill_chunks``, ``Engine.prefill_draft``), the device-side
window slide (``cache.streaming_evict_prefill``), ``SpecScheduler``'s
reused admission row and the int8 weights' converted copy.

The engines run on the staged stand-in (``graphs.staged``: the same keys,
static input buffers and copies of the static outputs, with the capture
replaced by a direct call through the static buffers). Oracles: the staged
prefill leaves the caches, lengths, first token and generator of an eager
engine (``graphs=False``) bit for bit, in bf16 and with int8 KV or int8
weights; against the JAX engine, its caches within fp32 tolerance and its
retrieval picks equal away from near ties; the window slide exactly as
JAX's. A region that read a value back to the host raises here
(``_no_readback``), as a capture would on a card.
"""

import contextlib
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triforce_tpu import cache as jcache
from triforce_tpu import config as jcfg
from triforce_tpu.engine import Engine as JEngine
from triforce_tpu.models import llama as jl
from triforce_tpu_torch import batched_spec as tbs
from triforce_tpu_torch import batching as tbatching
from triforce_tpu_torch import cache as tcache
from triforce_tpu_torch import config as tcfg
from triforce_tpu_torch import graphs as tgraphs
from triforce_tpu_torch.engine import Engine as TEngine
from triforce_tpu_torch.models import llama as tl
from triforce_tpu_torch.ops import retrieval as tret
from triforce_tpu_torch.tree import planner as tplan
from triforce_tpu_torch.tree import spectree as ttree

torch.set_num_threads(1)

SPEC_KW = dict(gamma=3, budget=16, chunk_size=4, draft_start_size=4,
               draft_recent_size=12, temperature=0.7, top_p=0.9)
# 3 full target chunks of 16 and a ragged 15, then the build token; 8
# drafter chunks of 8, sliding a 16-slot window
PREFILL, CHUNK, DCHUNK = 64, 16, 8
CASES = {"bf16": {}, "kv_quant": dict(kv_quant=True),
         "weight_quant": dict(weight_quant=True)}


@pytest.fixture(scope="module")
def weights():
    return (tl.init_params(tcfg.TINY_TARGET, device="cpu",
                           dtype=torch.bfloat16, seed=0),
            tl.init_params(tcfg.TINY_DRAFT, device="cpu",
                           dtype=torch.bfloat16, seed=1))


def _engine(weights, case, staged=False, spec_kw=SPEC_KW):
    tp, dp = weights
    eng = TEngine(tcfg.TINY_TARGET, tcfg.SpecConfig(**spec_kw), tp,
                  draft_cfg=tcfg.TINY_DRAFT, draft_params=dp,
                  prefill=PREFILL, max_cache_len=PREFILL + 64,
                  prefill_chunk=CHUNK, draft_prefill_chunk=DCHUNK,
                  dtype=torch.bfloat16, device="cpu", graphs=False,
                  **CASES[case])
    if staged:
        eng.graphs = tgraphs.staged("cpu")
    return eng


def _ids(seed=3):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(0, 199, (1, PREFILL)))


def _reset(state, seed):
    """``state`` with zero lengths and a fresh generator: the same planes,
    so a second prefill into it reuses its graphs."""
    dkv = getattr(state, "dkv", None)
    if dkv is not None:
        dkv = dataclasses.replace(dkv, seq_len=torch.zeros_like(dkv.seq_len))
    return dataclasses.replace(
        state, kv=dataclasses.replace(
            state.kv, seq_len=torch.zeros_like(state.kv.seq_len)),
        gen=torch.Generator().manual_seed(seed),
        **({} if dkv is None else dict(dkv=dkv)))


@contextlib.contextmanager
def _no_readback(monkeypatch):
    """Any host read of a tensor's value raises (a region that read one
    could not be captured on a card)."""
    def refuse(*_a, **_k):
        raise AssertionError("host read-back inside a prefill region")
    with monkeypatch.context() as m:
        for name in ("__bool__", "__int__", "__float__", "item", "tolist"):
            m.setattr(torch.Tensor, name, refuse)
        yield


def _planes_equal(a, b, live=None):
    for name in ("k", "v", "k_scale", "v_scale"):
        x, y = getattr(a, name, None), getattr(b, name, None)
        assert (x is None) == (y is None), name
        if x is None:
            continue
        if live is not None:
            x, y = x[:, :, :, :live], y[:, :, :, :live]
        assert torch.equal(x, y), name


def _target_equal(got, want):
    """kv up to its length, the length, the whole retrieval cache, the
    first token and the generator, bit for bit."""
    n = int(want.kv.seq_len)
    assert int(got.kv.seq_len) == n
    assert got.kv.seq_len.dtype == want.kv.seq_len.dtype
    _planes_equal(got.kv, want.kv, n)
    _planes_equal(got.rkv, want.rkv)
    assert torch.equal(got.next_token, want.next_token)
    assert torch.equal(got.gen.get_state(), want.gen.get_state())


def _draft_equal(got, want):
    assert int(got.dkv.seq_len) == int(want.dkv.seq_len)
    assert got.dkv.seq_len.dtype == want.dkv.seq_len.dtype
    _planes_equal(got.dkv, want.dkv)


# ---------------------------------------------------------------------------
# staged against eager, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_staged_prefill_target_equals_eager(weights, case, monkeypatch):
    """Three prefills into one state: the first runs each key eagerly and
    captures the full chunk; the second replays the chunks and captures
    the remainder and the build; the third replays everything. Each
    leaves what the eager engine leaves."""
    ids = _ids()
    ee, se = _engine(weights, case), _engine(weights, case, staged=True)
    want = ee.prefill_target(ee.init_state(7), ids)
    st = se.init_state(7)
    for rnd in range(3):
        c0, r0 = se.graphs.captures, se.graphs.replays
        with _no_readback(monkeypatch):
            got = se.prefill_target(_reset(st, 7), ids)
        _target_equal(got, want)
        # captures / replays this round: chunk, remainder, build
        assert (se.graphs.captures - c0, se.graphs.replays - r0) == \
            [(1, 2), (2, 5), (0, 5)][rnd]
    assert se.graphs.replays_by == {"prefill 1x16": 8, "prefill 1x15": 2,
                                    "build 1x1": 2}
    assert ee.graphs.captures == ee.graphs.replays == 0


@pytest.mark.parametrize("case", list(CASES))
def test_staged_prefill_slices_equal_eager(weights, case):
    """Chained admission slices of one chunk each, twice over one state
    (the second time every key replays), equal the eager engine's one
    ``prefill_target``."""
    ids = _ids(4)
    ee, se = _engine(weights, case), _engine(weights, case, staged=True)
    want = ee.prefill_target(ee.init_state(8), ids)
    st = se.init_state(8)
    for rnd in range(2):
        row, pos, done, slices = _reset(st, 8), 0, False, 0
        c0 = se.graphs.captures
        while not done:
            row, pos, done = se.prefill_target_partial(row, ids, pos, 1)
            slices += 1
        assert slices == 4     # three chunks, then remainder and build
        _target_equal(row, want)
    assert se.graphs.captures - c0 == 2      # remainder and build, round 2


@pytest.mark.parametrize("case", list(CASES))
def test_staged_prefill_draft_equals_eager(weights, case, monkeypatch):
    """The drafter's chunks (window slide + forward) as one region: the
    eager engine's window, bit for bit, with no length read back; one
    graph for the eight chunks."""
    ids = _ids(5)
    ee, se = _engine(weights, case), _engine(weights, case, staged=True)
    want = ee.prefill_draft(ee.init_state(9), ids)
    with _no_readback(monkeypatch):
        got = se.prefill_draft(se.init_state(9), ids)
    _draft_equal(got, want)
    assert int(want.dkv.seq_len) == 16      # the window slid
    assert se.graphs.captures == 1 and se.graphs.replays == 7


@pytest.mark.parametrize("case", ["bf16", "int8"])
def test_staged_tree_prefill_equals_eager(weights, case, monkeypatch):
    """``TreeEngine.prefill_target`` through the same helpers: twice into
    one state, the eager engine's caches, root token and generator."""
    pv = tplan.modeled_acceptance_vector(0.8, 4)
    gm = tplan.build_grow_map(*tplan.plan_tree(pv, 8, 4), 8, 4)
    quant = case == "int8"

    def tree(staged):
        eng = ttree.TreeEngine(
            tcfg.TINY_TARGET, gm, weights[0], prefill=PREFILL,
            max_cache_len=PREFILL + 32, budget=16, chunk_size=4,
            prefill_chunk=CHUNK, dtype=torch.bfloat16, device="cpu",
            kv_quant=quant, weight_quant=quant, graphs=False)
        if staged:
            eng.graphs = tgraphs.staged("cpu")
        return eng

    ee, se = tree(False), tree(True)
    ids = _ids(6)
    want = ee.prefill_target(ee.init_state(4), ids)
    st = se.init_state(4)
    for _ in range(2):
        with _no_readback(monkeypatch):
            got = se.prefill_target(_reset(st, 4), ids)
        _target_equal(got, want)
    assert se.graphs.captures == 3 and ee.graphs.captures == 0


# ---------------------------------------------------------------------------
# the int8 weights' converted copy
# ---------------------------------------------------------------------------

def test_dense_copy_made_once_and_keyed(weights):
    """With graphs on, the prefill converts the int8 weights once per
    engine; the copy's addresses are in the chunk graphs' keys, so a new
    copy (the old one freed) starts new keys instead of replaying over
    freed memory; ``release_graphs`` drops the copy."""
    ids = _ids()
    ee, se = _engine(weights, "weight_quant"), \
        _engine(weights, "weight_quant", staged=True)
    want = ee.prefill_target(ee.init_state(7), ids)
    assert ee._dense is None                 # eager: converted per call
    st = se.init_state(7)
    se.prefill_target(_reset(st, 7), ids)
    dense = se._dense
    assert dense["layers"]["wq"].dtype == torch.bfloat16
    assert se.t_params["layers"]["wq"].dtype == torch.int8
    _target_equal(se.prefill_target(_reset(st, 7), ids), want)
    assert se._dense is dense                 # made once
    key = tgraphs._plane_key(dense["layers"]["wq"])
    chunk_keys = [k for k in se.graphs._entries if k[0] == "prefill"]
    assert len(chunk_keys) == 2 and all(key in k[2] for k in chunk_keys)

    # a new copy: the old one is freed and its keys die with it
    old = weakref.ref(dense["layers"]["wq"])
    del dense, chunk_keys
    se._dense = None
    gc.collect()
    assert old() is None
    c0, r0 = se.graphs.captures, se.graphs.replays
    _target_equal(se.prefill_target(_reset(st, 7), ids), want)
    # the chunk starts over (eager, capture, replay), the remainder runs
    # eagerly, the build (over the int8 codes) replays
    assert (se.graphs.captures - c0, se.graphs.replays - r0) == (1, 3)
    se.release_graphs()
    assert se._dense is None and se.graphs.stats()["graphs"] == 0


# ---------------------------------------------------------------------------
# SpecScheduler: one admission row, reused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [12, 96], ids=["slid", "unfilled"])
@pytest.mark.parametrize("case", list(CASES))
def test_reused_admission_row_equals_fresh(weights, case, window):
    """Three requests admitted one after another through the scheduler's
    one row (dirty from the request before) each leave in their slot what
    a fresh state prefilled by an eager engine holds: every plane of the
    kv, the retrieval cache and the drafter window (also where a 96-slot
    window is left partly unwritten by the prompt), the lengths, the
    first token and the request's own generator. From the second request
    the chunks and the drafter chunks replay; the third captures
    nothing."""
    spec_kw = dict(SPEC_KW, draft_recent_size=window)
    ee = _engine(weights, case, spec_kw=spec_kw)
    se = _engine(weights, case, staged=True, spec_kw=spec_kw)
    sched = tbs.SpecScheduler(se, mode="triforce", slots=3, segment=2)
    caps = []
    for rid in range(3):
        req = tbatching.Request(rid=rid, prompt=_ids(10 + rid)[0].numpy(),
                                max_new_tokens=4)
        c0 = se.graphs.captures
        while not sched._admit_one(rid, req):
            pass
        caps.append(se.graphs.captures - c0)
        want = ee.prefill_draft(ee.prefill_target(ee.init_state(rid),
                                                  _ids(10 + rid)),
                                _ids(10 + rid))
        pool = sched.state
        got = dataclasses.replace(
            want, kv=tcache.row_view(pool.kv, rid),
            rkv=tcache.row_view(pool.rkv, rid),
            dkv=tcache.row_view(pool.dkv, rid),
            next_token=pool.next_token[rid:rid + 1], gen=pool.gens[rid])
        _target_equal(got, want)
        _planes_equal(got.kv, want.kv)          # past the length too
        _draft_equal(got, want)
        assert req.out == [int(want.next_token[0])]
    # request 0: the full chunk and the drafter chunk; request 1: the
    # remainder and the build; request 2: nothing new
    assert caps == [2, 2, 0]
    assert len({id(g) for g in sched.state.gens}) == 3


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def f32_weights():
    pj = jl.init_params(jax.random.PRNGKey(0), jcfg.TINY_TARGET,
                        dtype=jnp.float32)
    dj = jl.init_params(jax.random.PRNGKey(1), jcfg.TINY_DRAFT,
                        dtype=jnp.float32)
    return (pj, dj,
            tl.params_from_numpy(jax.tree.map(np.asarray, pj),
                                 tcfg.TINY_TARGET, "cpu"),
            tl.params_from_numpy(jax.tree.map(np.asarray, dj),
                                 tcfg.TINY_DRAFT, "cpu"))


def _chunk_picks(rkv_k, kv_k, chunk, budget):
    """The kv chunk each budget chunk of a retrieval cache holds, per
    (layer, head): the nearest chunk of the prefill, [L, Hkv, budget /
    chunk]."""
    rk = np.asarray(rkv_k, np.float32)[:, 0, :, :budget]
    kk = np.asarray(kv_k, np.float32)[:, 0, :, :PREFILL]
    lyr, hkv, _, d = rk.shape
    rk = rk.reshape(lyr, hkv, budget // chunk, chunk * d)
    kk = kk.reshape(lyr, hkv, PREFILL // chunk, chunk * d)
    dist = ((rk[:, :, :, None] - kk[:, :, None]) ** 2).sum(-1)
    return dist.argmin(-1)


@pytest.mark.parametrize("case", list(CASES))
def test_graphed_prefill_matches_jax(f32_weights, case, monkeypatch):
    """The staged port's target and drafter prefill against the JAX
    engine's, fp32 weights: kv (int8: codes within one step, scales) and
    the drafter window within 2e-5; the first token equal (near-greedy);
    the retrieval picks equal wherever the port's chunk scores at the
    top-k edge are not a near tie (relative gap 1e-4), and the picked
    chunks' contents within 2e-5."""
    pj, dj, pt, dt = f32_weights
    kw = dict(prefill=PREFILL, max_cache_len=PREFILL + 64,
              prefill_chunk=CHUNK, draft_prefill_chunk=DCHUNK,
              **CASES[case])
    spec_kw = dict(SPEC_KW, temperature=1e-4)
    je = JEngine(jcfg.TINY_TARGET, jcfg.SpecConfig(**spec_kw), pj,
                 draft_cfg=jcfg.TINY_DRAFT, draft_params=dj,
                 dtype=jnp.float32, donate=False, **kw)
    te = TEngine(tcfg.TINY_TARGET, tcfg.SpecConfig(**spec_kw), pt,
                 draft_cfg=tcfg.TINY_DRAFT, draft_params=dt,
                 dtype=torch.float32, device="cpu", graphs=False, **kw)
    te.graphs = tgraphs.staged("cpu")
    ids = np.random.default_rng(3).integers(0, 199, (1, PREFILL))
    js = je.init_state(jax.random.PRNGKey(100))
    js = je.prefill_draft(je.prefill_target(js, jnp.asarray(ids)),
                          jnp.asarray(ids))
    scores, select = [], tret.select_chunks

    def recording(sc, n):       # the port's chunk scores, layer by layer
        scores.append(sc[0].clone())
        return select(sc, n)
    monkeypatch.setattr(tret, "select_chunks", recording)
    ts = te.prefill_target(te.init_state(100), torch.from_numpy(ids))
    ts = te.prefill_draft(ts, torch.from_numpy(ids))
    assert len(scores) == tcfg.TINY_TARGET.num_layers

    tol = dict(rtol=2e-5, atol=2e-5)
    assert int(js.next_token[0]) == int(ts.next_token[0])
    assert int(js.kv.seq_len) == int(ts.kv.seq_len) == PREFILL
    assert int(js.dkv.seq_len) == int(ts.dkv.seq_len)
    if te.kv_quant:
        assert np.abs(np.asarray(js.kv.k, np.int32)
                      - ts.kv.k.numpy().astype(np.int32)).max() <= 1
        np.testing.assert_allclose(np.asarray(js.kv.k_scale),
                                   ts.kv.k_scale.numpy(), **tol)
    else:
        np.testing.assert_allclose(np.asarray(js.kv.k), ts.kv.k.numpy(),
                                   **tol)
    np.testing.assert_allclose(np.asarray(js.dkv.k), ts.dkv.k.numpy(), **tol)
    np.testing.assert_allclose(np.asarray(js.dkv.v), ts.dkv.v.numpy(), **tol)

    budget, chunk = SPEC_KW["budget"], SPEC_KW["chunk_size"]

    def values(c):     # dequantized, so that picks compare by content
        k = np.asarray(c.k, np.float32)
        return k * np.asarray(c.k_scale)[..., None] if te.kv_quant else k
    jp = _chunk_picks(values(js.rkv), values(js.kv), chunk, budget)
    tp = _chunk_picks(values(ts.rkv), values(ts.kv), chunk, budget)
    same = (jp == tp).all(-1)
    for li, h in zip(*np.nonzero(~same)):
        # a pick (or its rank) may differ only where the port's scores of
        # the two chunks nearly tie
        sc = scores[li][h].numpy()
        gap = np.abs(sc[jp[li, h]] - sc[tp[li, h]]).max()
        assert gap <= 1e-4 * np.abs(sc).max(), (li, h)
    assert (~same).sum() <= 1
    np.testing.assert_allclose(values(js.rkv)[:, 0, :, :budget][same],
                               values(ts.rkv)[:, 0, :, :budget][same], **tol)


@pytest.mark.parametrize("seq_len,incoming", [(3, 8), (8, 8), (9, 8),
                                              (16, 8), (12, 4), (15, 1)])
def test_device_side_window_slide_matches_jax(seq_len, incoming,
                                              monkeypatch):
    """``streaming_evict_prefill`` decides on the device, as JAX's
    ``lax.cond``: the same planes and length on overflow (seq_len +
    incoming > start + recent = 16) and without (the kept window copied
    onto itself), with no value read back."""
    spec_kw = dict(gamma=3, draft_start_size=4, draft_recent_size=12)
    rng = np.random.default_rng(seq_len * 31 + incoming)
    k = rng.standard_normal((2, 1, 2, 4 + 12 + 6, 8)).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    jd = jcache.streaming_evict_prefill(
        jcache.StreamingCache(k=jnp.asarray(k), v=jnp.asarray(v),
                              seq_len=jnp.asarray(seq_len, jnp.int32)),
        jcfg.SpecConfig(**spec_kw), incoming)
    td = tcache.StreamingCache(k=torch.from_numpy(k.copy()),
                               v=torch.from_numpy(v.copy()),
                               seq_len=torch.tensor(seq_len,
                                                    dtype=torch.int32))
    with _no_readback(monkeypatch):
        td = tcache.streaming_evict_prefill(td, tcfg.SpecConfig(**spec_kw),
                                            incoming)
    np.testing.assert_array_equal(td.k.numpy(), np.asarray(jd.k))
    np.testing.assert_array_equal(td.v.numpy(), np.asarray(jd.v))
    assert td.seq_len.dtype == torch.int32 and td.seq_len.dim() == 0
    assert int(td.seq_len) == int(jd.seq_len)
    if seq_len + incoming <= 16:
        np.testing.assert_array_equal(td.k.numpy(), k)


def test_phase_table_build_replays(weights):
    """``measure_phase_times``' retrieval build goes through the engine's
    build region: its warm-up captures and its timed calls replay, and the
    state is left as it was."""
    from triforce_tpu_torch import profiling
    se = _engine(weights, "bf16", staged=True)
    ids = _ids()
    st = se.prefill_draft(se.prefill_target(se.init_state(1), ids), ids)
    before = [x.clone() for x in (st.kv.k, st.rkv.k, st.dkv.k)]
    c0, r0 = se.graphs.captures, se.graphs.replays
    times = profiling.measure_phase_times(se, st, iters=4)
    assert times["retrieval_build"] > 0
    # one graph a phase (two verify widths, the build, the middle verify,
    # the drafter), replayed at its capture and by every timed call: 4
    # timed calls a phase, 2 for the build
    assert se.graphs.captures - c0 == 5
    assert se.graphs.replays - r0 == 4 * (1 + 4) + (1 + 2)
    for a, b in zip(before, (st.kv.k, st.rkv.k, st.dkv.k)):
        assert torch.equal(a, b)
