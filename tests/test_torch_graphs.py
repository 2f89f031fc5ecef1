"""The port's CUDA-graph layer (``triforce_tpu_torch/graphs.py``) on the CPU.

A CPU has no graphs to capture, so these tests run the engines on the
staged stand-in (``graphs.staged``): the same keys, static input buffers,
static outputs handed back as copies and launch-counter bookkeeping, with
the capture replaced by a direct call through the static buffers. A
region whose output aliased a static buffer, or whose key missed a state
change, would change the tokens here. Oracles: the staged engine emits
what the eager engine emits, bit for bit (real sampling, the same
generator), and near-greedy what the JAX engine emits.

The same regions run as real graphs on a card in
``tests/test_torch_kernels_cuda.py`` (marked ``cuda``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triforce_tpu import batched_spec as jbs
from triforce_tpu import config as jcfg
from triforce_tpu.engine import Engine as JEngine
from triforce_tpu.models import llama as jl
from triforce_tpu.tree import planner as jplan
from triforce_tpu.tree import spectree as jtree
from triforce_tpu_torch import batched_spec as tbs
from triforce_tpu_torch import batching as tbatching
from triforce_tpu_torch import cache as tcache
from triforce_tpu_torch import config as tcfg
from triforce_tpu_torch import graphs as tgraphs
from triforce_tpu_torch.engine import Engine as TEngine
from triforce_tpu_torch.models import llama as tl
from triforce_tpu_torch.tree import planner as tplan
from triforce_tpu_torch.tree import spectree as ttree

torch.set_num_threads(1)

SPEC_KW = dict(gamma=3, budget=16, chunk_size=4, draft_start_size=4,
               draft_recent_size=12, temperature=0.7, top_p=0.9)
GREEDY_KW = dict(SPEC_KW, temperature=1e-4)
PREFILL, GEN = 32, 16


@pytest.fixture(scope="module")
def weights():
    pj = jl.init_params(jax.random.PRNGKey(0), jcfg.TINY_TARGET,
                        dtype=jnp.float32)
    dj = jl.init_params(jax.random.PRNGKey(1), jcfg.TINY_DRAFT,
                        dtype=jnp.float32)
    pt = tl.params_from_numpy(jax.tree.map(np.asarray, pj),
                              tcfg.TINY_TARGET, "cpu")
    dt = tl.params_from_numpy(jax.tree.map(np.asarray, dj),
                              tcfg.TINY_DRAFT, "cpu")
    return pj, dj, pt, dt


def _common(**kw):
    return dict(dict(prefill=PREFILL, max_cache_len=PREFILL + 64,
                     prefill_chunk=16, draft_prefill_chunk=8), **kw)


def _t_engine(weights, spec_kw=SPEC_KW, staged=False, **kw):
    _, _, pt, dt = weights
    eng = TEngine(tcfg.TINY_TARGET, tcfg.SpecConfig(**spec_kw), pt,
                  draft_cfg=tcfg.TINY_DRAFT, draft_params=dt,
                  dtype=torch.float32, device="cpu", **_common(**kw))
    if staged:
        eng.graphs = tgraphs.staged("cpu")
    return eng


def _j_engine(weights, spec_kw=GREEDY_KW, **kw):
    pj, dj, _, _ = weights
    return JEngine(jcfg.TINY_TARGET, jcfg.SpecConfig(**spec_kw), pj,
                   draft_cfg=jcfg.TINY_DRAFT, draft_params=dj,
                   dtype=jnp.float32, donate=False, **_common(**kw))


def _ids(seed=2):
    return np.random.default_rng(seed).integers(0, 199, (1, PREFILL))


def _prefilled(eng, ids, seed=100):
    st = eng.prefill_target(eng.init_state(seed), torch.from_numpy(ids))
    return eng.prefill_draft(st, torch.from_numpy(ids))


def _run(eng, state, mode, alpha):
    """``mode`` over ``state``: (tokens, counters, kv length, generator
    state); ``ar`` returns no counters."""
    if mode == "ar":
        kv, _, gen, buf = eng.generate_ar(state.kv, state.next_token,
                                          state.gen, GEN)
        return buf.tolist(), None, int(kv.seq_len), gen.get_state()
    if alpha is None:
        st, buf, n, c = eng.generate(state, GEN, mode=mode)
    else:
        st, buf, n, c = eng.generate_forced(state, GEN, alpha, mode=mode)
    return (buf[:n].tolist(), c.tolist(), int(st.kv.seq_len),
            st.gen.get_state())


MODES = [("ar", None), ("retrieval", None), ("triforce", None),
         ("triforce", 0.8), ("retrieval", 0.8)]


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("mode,alpha", MODES)
def test_staged_engine_equals_eager(weights, mode, alpha, quant):
    """Every graph region of the batch-1 engine through static buffers,
    call after call with new inputs: the same tokens, counters, kv length
    and generator state as the eager engine."""
    ids = _ids()
    kw = dict(kv_quant=quant, weight_quant=quant)
    staged = _t_engine(weights, staged=True, **kw)
    eager = _t_engine(weights, **kw)
    got = _run(staged, _prefilled(staged, ids), mode, alpha)
    want = _run(eager, _prefilled(eager, ids), mode, alpha)
    assert got[:3] == want[:3]
    assert torch.equal(got[3], want[3])
    assert staged.graphs.captures >= 1
    assert staged.graphs.replays > staged.graphs.captures
    assert eager.graphs.captures == eager.graphs.replays == 0


@pytest.mark.parametrize("mode,alpha", [m for m in MODES if m[0] != "ar"])
def test_staged_engine_matches_jax_near_greedy(weights, mode, alpha):
    """Near-greedy (temperature 1e-4) every draw is one-hot unless two top
    logits lie within fp32 drift of each other, and the two packages'
    random streams differ; this prompt (seed 3) has no such near tie on
    these runs (seed 2's forced run meets one in its last step, the eager
    port and the staged one alike)."""
    ids = _ids(3)
    je = _j_engine(weights)
    te = _t_engine(weights, GREEDY_KW, staged=True)
    js = je.init_state(jax.random.PRNGKey(100))
    js = je.prefill_draft(je.prefill_target(js, jnp.asarray(ids)),
                          jnp.asarray(ids))
    ts = _prefilled(te, ids)
    if alpha is None:
        _, jbuf, jn, jc, _ = je.generate(js, GEN, mode=mode)
        _, tbuf, tn, tc = te.generate(ts, GEN, mode=mode)
    else:
        _, jbuf, jn, jc, _ = je.generate_forced(js, GEN, 1.0, mode=mode)
        _, tbuf, tn, tc = te.generate_forced(ts, GEN, 1.0, mode=mode)
    assert int(jn) == tn
    assert np.asarray(jbuf)[:tn].tolist() == tbuf[:tn].tolist()
    assert np.asarray(jc).tolist() == tc.tolist()


def test_staged_ar_matches_jax_near_greedy(weights):
    ids = _ids()
    je = _j_engine(weights)
    te = _t_engine(weights, GREEDY_KW, staged=True)
    js = je.prefill_target(je.init_state(jax.random.PRNGKey(100)),
                           jnp.asarray(ids))
    ts = te.prefill_target(te.init_state(100), torch.from_numpy(ids))
    _, _, _, jbuf = je.generate_ar(js.kv, js.next_token,
                                   jax.random.PRNGKey(3), GEN)
    _, _, _, tbuf = te.generate_ar(ts.kv, ts.next_token, ts.gen, GEN)
    assert np.asarray(jbuf).tolist() == tbuf.tolist()


# ---------------------------------------------------------------------------
# tree grow and verify
# ---------------------------------------------------------------------------

def _grow_map(pl):
    p = pl.modeled_acceptance_vector(0.8, max_branch=3)
    T, choice = pl.plan_tree(p, max_budget=8, max_depth=4)
    return pl.build_grow_map(T, choice, 8, 4)


def _tree_engine(weights, temperature, staged=False, **kw):
    _, _, pt, _ = weights
    eng = ttree.TreeEngine(tcfg.TINY_TARGET, _grow_map(tplan), pt,
                           prefill=PREFILL, max_cache_len=PREFILL + 64,
                           budget=16, chunk_size=4, temperature=temperature,
                           top_p=0.9, prefill_chunk=16, dtype=torch.float32,
                           device="cpu", **kw)
    if staged:
        eng.graphs = tgraphs.staged("cpu")
    return eng


@pytest.mark.parametrize("kw", [{}, dict(kv_quant=True, weight_quant=True),
                                dict(ssl=1)], ids=["fp32", "int8", "ssl1"])
def test_staged_tree_equals_eager(weights, kw):
    """The tree's generation loops (grow, verify, the walk's conditional
    node bodies, commit) through the staged set: the eager engine's steps,
    nodes, tokens and generator; one read-back a call where the eager
    engine reads every walk and loop predicate back."""
    ids = torch.from_numpy(_ids(5))
    out = []
    for staged in (True, False):
        eng = _tree_engine(weights, 0.7, staged=staged, **kw)
        st = eng.prefill_target(eng.init_state(7), ids)
        st, buf, n, c, _ = eng.generate(st, 12)
        st, buf2, n2, c2, _ = eng.generate_forced(st, 8, 0.8)
        out.append((buf[:n].tolist(), c[:2].tolist(), buf2[:n2].tolist(),
                    c2[:2].tolist(), int(st.kv.seq_len), st.gen.get_state(),
                    eng.graphs.captures, (c[2], c2[2])))
    (g, e) = out
    assert g[:5] == e[:5] and torch.equal(g[5], e[5])
    assert g[6] == 2 and e[6] == 0   # the loop, the forced loop
    assert g[7] == (1, 1) and min(e[7]) > 1


def test_staged_tree_matches_jax_near_greedy(weights):
    pj = weights[0]
    common = dict(prefill=PREFILL, max_cache_len=PREFILL + 64, budget=16,
                  chunk_size=4, temperature=1e-3, top_p=0.9,
                  prefill_chunk=16)
    je = jtree.TreeEngine(jcfg.TINY_TARGET, _grow_map(jplan), pj,
                          dtype=jnp.float32, donate=False, **common)
    te = _tree_engine(weights, 1e-3, staged=True)
    ids = np.random.default_rng(5).integers(3, 199, (1, PREFILL))
    rj = jtree.tree_decode(je, jnp.asarray(ids), max_len=20, seed=1)
    rt = ttree.tree_decode(te, torch.from_numpy(ids), max_len=20, seed=1,
                           device="cpu")
    assert rt.tokens == rj.tokens and rt.steps == rj.steps


# ---------------------------------------------------------------------------
# batched steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["retrieval", "triforce"])
def test_staged_batched_equals_eager(weights, mode):
    """The batched decode through static buffers: every row's tokens,
    counts and lengths as the eager batched engine's; the decode captures
    one graph, its loop region (the rows forwards run inside it), the
    prefill's one drafter chunk graph a row (each row is a new batch-1
    state; its target chunk and build run once)."""
    prompts = [torch.from_numpy(_ids(s)) for s in (1, 2, 3)]
    out = []
    for staged in (True, False):
        eng = _t_engine(weights, staged=staged, max_cache_len=PREFILL + 96)
        bat = tbs.BatchedSpecEngine(eng, mode=mode)
        state = bat.prefill_rows(prompts, [7, 8, 9])
        pre = eng.graphs.captures
        state, toks, ns, c, eos = bat.decode(state, 4)
        out.append((toks.tolist(), ns.tolist(), c.tolist(),
                    state.kv.seq_len.tolist(), eng.graphs.captures - pre,
                    pre))
    assert out[0][:4] == out[1][:4]
    assert out[0][4] == 1
    assert out[0][5] == (3 if mode == "triforce" else 0)


def test_staged_batched_matches_jax_near_greedy(weights):
    je = _j_engine(weights, max_cache_len=PREFILL + 96)
    te = _t_engine(weights, GREEDY_KW, staged=True,
                   max_cache_len=PREFILL + 96)
    prompts = [_ids(s) for s in (1, 2, 3)]
    jbat = jbs.BatchedSpecEngine(je, mode="retrieval", donate=False)
    jstate = jbat.prefill_rows([jnp.asarray(p) for p in prompts], [7, 8, 9])
    tstate = tbs.stacked_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                          [7, 8, 9], "cpu")
    tbat = tbs.BatchedSpecEngine(te, mode="retrieval")
    jstate, jtoks, jns, _, _ = jbat.decode(jstate, 3)
    tstate, ttoks, tns, _, _ = tbat.decode(tstate, 3)
    np.testing.assert_array_equal(tns, np.asarray(jns))
    jtoks = np.asarray(jtoks)
    for r in range(3):
        for s in range(3):
            n = tns[r, s]
            assert ttoks[r, s, :n].tolist() == jtoks[r, s, :n].tolist()
    assert tstate.kv.seq_len.tolist() == np.asarray(jstate.kv.seq_len).tolist()


def test_staged_ar_scheduler_equals_eager(weights):
    _, _, pt, _ = weights
    spec = tcfg.SpecConfig(**SPEC_KW)
    out = []
    for staged in (True, False):
        sched = tbatching.Scheduler(tcfg.TINY_TARGET, spec, pt, batch=2,
                                    max_len=PREFILL + 32, prefill_chunk=16,
                                    segment=3, device="cpu",
                                    dtype=torch.float32, eos_token_id=-1)
        if staged:
            sched.graphs = tgraphs.staged("cpu")
        for i in range(3):
            sched.submit(tbatching.Request(rid=i, prompt=_ids(i)[0],
                                           max_new_tokens=8))
        done = sched.run()
        out.append((sorted((r.rid, r.out) for r in done),
                    sched.graphs.captures, sched.stats["captures"],
                    sched.stats["admit_captures"]))
    assert out[0][0] == out[1][0]
    # one decode step graph; the third request, admitted into a slot that
    # was used before, captures that slot's chunk and its last chunk
    assert out[0][2] == 1 and out[0][3] == 2 and out[1][1] == 0
    assert out[0][1] == out[0][2] + out[0][3]


# ---------------------------------------------------------------------------
# keys, refusal, counters, capture-safe forms
# ---------------------------------------------------------------------------

def test_same_state_reuses_its_graphs_a_clone_gets_new_ones(weights):
    eng = _t_engine(weights, staged=True)
    state = _prefilled(eng, _ids())
    pre = eng.graphs.captures     # the drafter prefill's chunk
    step = eng._step_fn("triforce", None)
    for _ in range(3):
        state, _ = step(state)
    caps = eng.graphs.captures - pre
    assert pre == 1 and caps == 1   # the step, one region
    for _ in range(3):
        state, _ = step(state)
    assert eng.graphs.captures == pre + caps
    twin = state.clone()
    for _ in range(2):
        twin, _ = step(twin)
    assert eng.graphs.captures == pre + 2 * caps
    eng.release_graphs()
    assert eng.graphs.stats()["graphs"] == 0


def test_graphs_true_on_the_cpu_raises(weights):
    _, _, pt, dt = weights
    with pytest.raises(ValueError, match="CUDA device"):
        TEngine(tcfg.TINY_TARGET, tcfg.SpecConfig(**SPEC_KW), pt,
                prefill=PREFILL, max_cache_len=PREFILL + 64, device="cpu",
                graphs=True)
    with pytest.raises(ValueError, match="CUDA device"):
        _tree_engine(weights, 0.7, graphs=True)
    with pytest.raises(ValueError, match="CUDA device"):
        tbatching.Scheduler(tcfg.TINY_TARGET, tcfg.SpecConfig(**SPEC_KW),
                            pt, device="cpu", graphs=True)
    assert not TEngine(tcfg.TINY_TARGET, tcfg.SpecConfig(**SPEC_KW), pt,
                       prefill=PREFILL, max_cache_len=PREFILL + 64,
                       device="cpu").graphs.enabled


def test_staged_set_refuses_a_cuda_device():
    with pytest.raises(ValueError, match="CPU stand-in"):
        tgraphs.staged("cuda")


def test_replayed_launch_counter_adds_up(monkeypatch):
    """A region's launches are counted once per call: the eager first
    call counts itself, the capture takes its own back off, and every
    replay adds what was captured."""
    def fake(x):
        fake.launches += 3
        return x + 1
    fake.launches = 0
    monkeypatch.setattr(tgraphs, "COUNTED", tgraphs.COUNTED + [fake])
    gs = tgraphs.staged("cpu")
    x = torch.zeros(4)
    for i in range(6):
        (y,) = gs.run("r", lambda t: (fake(t),), (x + i,))
        assert y.tolist() == [i + 1.0] * 4
        assert fake.launches == 3 * (i + 1)
    assert gs.captures == 1 and gs.replays == 5


def test_outputs_are_copies_and_host_numbers_are_staged():
    gs = tgraphs.staged("cpu")
    outs = [gs.run("r", lambda t, n: (t * n, n + 0), (torch.ones(2), i))
            for i in range(4)]
    assert [o[0].tolist() for o in outs] == [[float(i)] * 2 for i in range(4)]
    assert [int(o[1]) for o in outs] == [0, 1, 2, 3]
    assert all(o[1].dtype == torch.int64 for o in outs)


def test_dead_state_drops_its_graphs(weights):
    gs = tgraphs.staged("cpu")
    for _ in range(2):
        buf = torch.zeros(3)
        for i in range(3):
            gs.run("w", lambda t: (t + buf,), (torch.ones(3) * i,),
                   caches=(buf,))
        del buf
    assert gs.captures == 2 and gs.stats()["graphs"] == 1


@pytest.mark.parametrize("start,size,extent", [(0, 4, 16), (5, 4, 16),
                                               (14, 4, 16), (-3, 4, 16),
                                               (40, 8, 16)])
def test_window_host_and_device_starts_agree(start, size, extent):
    want = (torch.tensor(start).clamp(0, extent - size)
            + torch.arange(size)).tolist()
    assert tcache.window(start, size, extent, "cpu").tolist() == want
    assert tcache.window(torch.tensor(start, dtype=torch.int32), size,
                         extent, "cpu").tolist() == want


@pytest.mark.parametrize("start", [0, 7, 4095])
def test_positions_host_and_device_starts_agree(start):
    want = (start + torch.arange(5)).tolist()
    for s in (start, torch.tensor(start, dtype=torch.int32),
              torch.tensor(start)):
        got = tl._positions(s, 5, torch.device("cpu"))
        assert got.tolist() == want and got.dtype == torch.int64
    assert tcache.device_scalar(start, "cpu").tolist() == start


def test_tree_positions_host_and_device_lengths_agree(weights):
    """``forward_tree_spec`` with the length as a host int and as a device
    scalar, the depths and masks as host arrays and as tensors: the same
    logits and the same cache writes."""
    eng = _tree_engine(weights, 0.7)
    ids = torch.from_numpy(_ids(5))
    base = eng.prefill_target(eng.init_state(7), ids)
    gm = eng.gm
    out = []
    for host in (True, False):
        st = base.clone()
        seq = int(st.kv.seq_len) if host else st.kv.seq_len
        depths = gm.depth[:3] if host else torch.from_numpy(gm.depth[:3])
        amask = gm.mask[:3] if host else torch.from_numpy(gm.mask[:3])
        logits, rkv, _ = tl.forward_tree_spec(
            tcfg.TINY_TARGET, eng.params, torch.tensor([[5, 6, 7]]), st.rkv,
            seq, eng.budget, depths, amask, slot_start=1, kv=st.kv, ssl=1)
        out.append((logits, rkv.k.clone(), st.kv.k.clone()))
    for a, b in zip(*out):
        assert torch.equal(a, b)
