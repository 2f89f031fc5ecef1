"""The port's device-side generation loops on the CPU: ``GraphSet.cond``
(the conditional bodies a capture turns into CUDA if-nodes), the step's
fixed draws, and ``Engine.generate`` / ``TreeEngine.generate`` run as
loop regions.

The staged set (``graphs.staged``) stands in for a graph set: a loop
region's first call is its "capture", ``cond`` reads its predicate but
counts no read-back, and each body's launches are kept apart from its
region's as a graph keeps them. Oracles: the staged engines emit the eager
engines' tokens, counters, lengths and generator state bit for bit with
the same (fake) kernel launches, read back once a generation call where
the eager engine reads every condition back, and emit what the JAX
engines emit near-greedy (temperature 1e-4 / 1e-3, prompt ``default_rng
(3)`` / seed 5, as ``tests/test_torch_graphs.py``): token identity with a
tolerance of zero, counters equal.

On a card the same loops replay CUDA graphs with if-nodes
(``tests/test_torch_kernels_cuda.py``, marked ``cuda``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triforce_tpu import config as jcfg
from triforce_tpu.engine import Engine as JEngine
from triforce_tpu.models import llama as jl
from triforce_tpu.tree import planner as jplan
from triforce_tpu.tree import spectree as jtree
from triforce_tpu_torch import config as tcfg
from triforce_tpu_torch import engine as tengine
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
    return dict(dict(prefill=PREFILL, max_cache_len=PREFILL + 96,
                     prefill_chunk=16, draft_prefill_chunk=8), **kw)


def _t_engine(weights, spec_kw=SPEC_KW, staged=False, **kw):
    _, _, pt, dt = weights
    eng = TEngine(tcfg.TINY_TARGET, tcfg.SpecConfig(**spec_kw), pt,
                  draft_cfg=tcfg.TINY_DRAFT, draft_params=dt,
                  dtype=torch.float32, device="cpu", **_common(**kw))
    if staged:
        eng.graphs = tgraphs.staged("cpu")
    return eng


def _ids(seed=3):
    return np.random.default_rng(seed).integers(0, 199, (1, PREFILL))


def _prefilled(eng, ids, seed=100):
    st = eng.prefill_target(eng.init_state(seed), torch.from_numpy(ids))
    return eng.prefill_draft(st, torch.from_numpy(ids))


def _fake_counter(monkeypatch):
    """A counted "kernel" launched by every target and drafter forward:
    the CPU's wrappers launch nothing, so the launch bookkeeping of the
    loops (a region's own launches, each body's apart) is held through
    this one."""
    def fake():
        fake.launches += 1
    fake.launches = 0
    monkeypatch.setattr(tgraphs, "COUNTED", tgraphs.COUNTED + [fake])
    for name in ("forward_append", "forward_spec", "draft_forward_spec",
                 "forward_tree_spec"):
        orig = getattr(tl, name)

        def counted(*a, _orig=orig, **k):
            fake()
            return _orig(*a, **k)
        monkeypatch.setattr(tl, name, counted)
    return fake


# ---------------------------------------------------------------------------
# GraphSet.cond
# ---------------------------------------------------------------------------

def _cond_region(gs, fake, pred, pred2, out):
    """A region with a body nested in a body, each launching the fake
    kernel (the outer twice); ``out`` counts the bodies run."""
    def inner():
        fake()
        out[1:2] += 1

    def outer():
        fake()
        fake()
        out[0:1] += 1
        gs.cond(pred2, inner)

    def region():
        fake()                   # the region's own launch
        gs.cond(pred, outer)
        return ()
    return region


@pytest.mark.parametrize("mode", ["eager", "staged"])
def test_cond_runs_only_the_bodies_whose_predicate_holds(monkeypatch, mode):
    """A skipped body runs nothing and counts no launch; a body that runs
    counts its launches once a call, nested bodies too; the staged set
    counts no read-back for a condition, the eager set one each."""
    def fake():
        fake.launches += 1
    fake.launches = 0
    monkeypatch.setattr(tgraphs, "COUNTED", tgraphs.COUNTED + [fake])
    gs = tgraphs.staged("cpu") if mode == "staged" \
        else tgraphs.GraphSet("cpu", False)
    pred, pred2 = torch.zeros((), dtype=torch.bool), \
        torch.zeros((), dtype=torch.bool)
    out = torch.zeros(2, dtype=torch.int64)
    region = _cond_region(gs, fake, pred, pred2, out)
    cases = [(True, True), (True, False), (False, True), (False, False),
             (True, True)]
    for p1, p2 in cases:
        pred.fill_(p1)
        pred2.fill_(p2)
        out0, l0, r0 = out.clone(), fake.launches, gs.readbacks
        gs.run("cond", region, (), caches=(out,), capture_first=True)
        assert (out - out0).tolist() == [int(p1), int(p1 and p2)]
        assert fake.launches - l0 == 1 + 2 * p1 + (p1 and p2)
        assert gs.readbacks - r0 == (0 if mode == "staged" else 1 + p1)
    if mode == "staged":       # the first call captured, then replays
        assert gs.captures == 1 and gs.replays == len(cases)
    else:
        assert gs.captures == 0


def test_nested_run_inlines_under_a_staged_capture(monkeypatch):
    """A region reached while its set runs one is called inline: it is
    neither a key nor a capture of its own, and its launches are the outer
    region's (its body's, where it sits in one)."""
    def fake():
        fake.launches += 1
    fake.launches = 0
    monkeypatch.setattr(tgraphs, "COUNTED", tgraphs.COUNTED + [fake])
    gs = tgraphs.staged("cpu")
    pred = torch.ones((), dtype=torch.bool)
    acc = torch.zeros(3)

    def inner(x):
        fake()
        return (x + 1,)

    def region():
        acc.copy_(gs.run("inner", inner, (acc,))[0])

        def body():
            acc.copy_(gs.run("inner", inner, (acc,))[0])
        gs.cond(pred, body)
        return ()

    for i in range(4):
        pred.fill_(i % 2 == 0)
        l0 = fake.launches
        gs.run("outer", region, (), caches=(acc,), capture_first=True)
        assert fake.launches - l0 == 1 + (i % 2 == 0)
    assert acc.tolist() == [6.0] * 3
    assert gs.captures == 1 and list(gs.replays_by) == ["outer"]
    assert gs.stats()["graphs"] == 1


def test_loop_buffers_live_with_their_planes():
    """A loop region's kept buffers are made once per key and dropped with
    the cache planes they belong to."""
    gs = tgraphs.staged("cpu")
    plane = torch.zeros(4)
    made = []

    def make():
        made.append(1)
        return dict(n=torch.zeros((), dtype=torch.int64))
    a = gs.buffers("gen", (plane,), make, extra=(8,))
    assert gs.buffers("gen", (plane,), make, extra=(8,)) is a
    gs.buffers("gen", (plane,), make, extra=(9,))
    assert len(made) == 2
    del plane
    gs.buffers("gen", (torch.zeros(4),), make, extra=(8,))
    assert len(made) == 3 and len(gs._buffers) == 1


def test_cond_refuses_a_host_predicate_under_capture():
    gs = tgraphs.staged("cpu")
    gs._graph = object()        # as under a capture
    with pytest.raises(TypeError, match="0-d bool"):
        gs.cond(torch.ones(2, dtype=torch.bool), lambda: None)
    gs._graph = None


# ---------------------------------------------------------------------------
# the step's draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["triforce", "retrieval"])
def test_a_step_draws_the_same_whichever_bodies_run(weights, mode):
    """Forced acceptance 0 and 1 take different trips, drafter forwards,
    residuals and bonuses; the step draws the same block either way, so
    the generators leave the step in the same state."""
    eng = _t_engine(weights)
    base = _prefilled(eng, _ids())
    out = []
    for alpha in (0.0, 1.0):
        st = base.clone()
        st, stats = eng._step_fn(mode, alpha)(st)
        out.append((stats.n_emitted, stats.mid_verify, st.gen.get_state()))
    (n0, v0, g0), (n1, v1, g1) = out
    assert n0 != n1 or v0 != v1                # other bodies ran
    assert torch.equal(g0, g1)
    parts = tengine._draw_parts(eng.spec, tcfg.TINY_TARGET.vocab_size, mode)
    g = torch.Generator().manual_seed(5)
    u = tengine._draws(parts, g, "cpu")
    flat = torch.rand(sum(v.numel() for v in u.values()),
                      generator=torch.Generator().manual_seed(5))
    assert torch.equal(torch.cat([v.reshape(-1) for v in u.values()]), flat)


def test_a_tree_step_draws_the_same_whichever_nodes_are_walked(weights):
    _, _, pt, _ = weights
    eng = _tree_engine(pt, 0.7)
    base = eng.prefill_target(eng.init_state(7), torch.from_numpy(_ids(5)))
    out = []
    for alpha in (0.0, 1.0):
        st, stats = eng.step(base.clone(), force_accept=alpha)
        out.append((stats.n_nodes, st.gen.get_state()))
    assert out[0][0] == 1 and out[1][0] > 1     # the walk took other bodies
    assert torch.equal(out[0][1], out[1][1])


# ---------------------------------------------------------------------------
# the batch-1 engine's loop: staged against eager, against JAX
# ---------------------------------------------------------------------------

MODES = [("triforce", None), ("retrieval", None), ("triforce", 0.9),
         ("retrieval", 0.9)]


def _generate(eng, state, mode, alpha, n=GEN, **kw):
    if alpha is None:
        return eng.generate(state, n, mode=mode, **kw)
    return eng.generate_forced(state, n, alpha, mode=mode, **kw)


@pytest.mark.parametrize("mode,alpha", MODES)
def test_staged_loop_equals_eager(weights, monkeypatch, mode, alpha):
    """The loop region through the staged set, two calls on one state: the
    eager engine's tokens, counters, kv length, generator state and
    launches bit for bit; one capture (the loop's key holds the call's
    length and the state's caches) and one read-back a call."""
    fake = _fake_counter(monkeypatch)
    ids = _ids()
    out = []
    for staged in (True, False):
        eng = _t_engine(weights, staged=staged)
        st = _prefilled(eng, ids)
        got = []
        for _ in range(2):
            fake.launches, r0 = 0, eng.graphs.readbacks
            st, buf, n, c = _generate(eng, st, mode, alpha)
            got.append((buf[:n].tolist(), c.tolist(), int(st.kv.seq_len),
                        fake.launches, eng.graphs.readbacks - r0))
        out.append((got, st.gen.get_state(), eng.graphs.captures))
    (g, gs_, gc), (e, es, ec) = out
    assert [x[:4] for x in g] == [x[:4] for x in e]
    assert all(x[3] > 0 for x in g)
    assert torch.equal(gs_, es)
    assert [x[4] for x in g] == [1, 1] and min(x[4] for x in e) > GEN
    assert gc == 2 and ec == 0     # a drafter prefill chunk, the loop


@pytest.mark.parametrize("mode,alpha", [("triforce", None),
                                        ("retrieval", None),
                                        ("triforce", 1.0)])
def test_staged_loop_matches_jax_near_greedy(weights, mode, alpha):
    pj, dj, _, _ = weights
    je = JEngine(jcfg.TINY_TARGET, jcfg.SpecConfig(**GREEDY_KW), pj,
                 draft_cfg=jcfg.TINY_DRAFT, draft_params=dj,
                 dtype=jnp.float32, donate=False, **_common())
    te = _t_engine(weights, GREEDY_KW, staged=True)
    ids = _ids()
    js = je.init_state(jax.random.PRNGKey(100))
    js = je.prefill_draft(je.prefill_target(js, jnp.asarray(ids)),
                          jnp.asarray(ids))
    ts = _prefilled(te, ids)
    if alpha is None:
        jst, jbuf, jn, jc, _ = je.generate(js, GEN, mode=mode)
    else:
        jst, jbuf, jn, jc, _ = je.generate_forced(js, GEN, alpha, mode=mode)
    tst, tbuf, tn, tc = _generate(te, ts, mode, alpha)
    assert int(jn) == tn
    assert np.asarray(jbuf)[:tn].tolist() == tbuf[:tn].tolist()
    assert np.asarray(jc).tolist() == tc.tolist()
    assert int(jst.kv.seq_len) == int(tst.kv.seq_len)
    assert int(jst.next_token[0]) == int(tst.next_token[0])


@pytest.mark.parametrize("staged", [True, False])
def test_stop_on_eos_stops_at_the_jax_step(weights, staged):
    """An EOS id that the stream emits mid-generation: the loop stops at
    the step that emitted it, with JAX's count, counters and length."""
    pj, dj, _, _ = weights
    ids = _ids()
    te0 = _t_engine(weights, GREEDY_KW)
    _, buf0, _, _ = te0.generate(_prefilled(te0, ids), GEN,
                                 mode="retrieval")
    eos = int(buf0[5])
    je = JEngine(jcfg.TINY_TARGET, jcfg.SpecConfig(**GREEDY_KW), pj,
                 draft_cfg=jcfg.TINY_DRAFT, draft_params=dj,
                 dtype=jnp.float32, donate=False, eos_token_id=eos,
                 **_common())
    te = _t_engine(weights, GREEDY_KW, staged=staged, eos_token_id=eos)
    js = je.init_state(jax.random.PRNGKey(100))
    js = je.prefill_draft(je.prefill_target(js, jnp.asarray(ids)),
                          jnp.asarray(ids))
    jst, jbuf, jn, jc, _ = je.generate(js, GEN, mode="retrieval",
                                       stop_on_eos=True)
    tst, tbuf, tn, tc = te.generate(_prefilled(te, ids), GEN,
                                    mode="retrieval", stop_on_eos=True)
    assert int(jn) == tn < GEN + 1
    assert eos in tbuf[:tn].tolist()
    assert np.asarray(jbuf)[:tn].tolist() == tbuf[:tn].tolist()
    assert np.asarray(jc).tolist() == tc.tolist()
    assert int(jst.kv.seq_len) == int(tst.kv.seq_len)


# ---------------------------------------------------------------------------
# the tree engine's loop
# ---------------------------------------------------------------------------

def _grow_map(pl):
    p = pl.modeled_acceptance_vector(0.8, max_branch=3)
    T, choice = pl.plan_tree(p, max_budget=8, max_depth=4)
    return pl.build_grow_map(T, choice, 8, 4)


def _tree_engine(pt, temperature, staged=False, **kw):
    eng = ttree.TreeEngine(tcfg.TINY_TARGET, _grow_map(tplan), pt,
                           prefill=PREFILL, max_cache_len=PREFILL + 64,
                           budget=16, chunk_size=4, temperature=temperature,
                           top_p=0.9, prefill_chunk=16, dtype=torch.float32,
                           device="cpu", **kw)
    if staged:
        eng.graphs = tgraphs.staged("cpu")
    return eng


@pytest.mark.parametrize("alpha", [None, 0.9])
def test_staged_tree_loop_equals_eager(weights, monkeypatch, alpha):
    fake = _fake_counter(monkeypatch)
    _, _, pt, _ = weights
    ids = torch.from_numpy(_ids(5))
    out = []
    for staged in (True, False):
        eng = _tree_engine(pt, 0.7, staged=staged)
        st = eng.prefill_target(eng.init_state(7), ids)
        fake.launches = 0
        gen = functools.partial(eng.generate_forced, alpha=alpha) \
            if alpha is not None else eng.generate
        st, buf, n, c, stop = gen(st, 12)
        out.append((buf[:n].tolist(), c[:2].tolist(), int(c[2]), stop,
                    int(st.kv.seq_len), fake.launches, st.gen.get_state()))
    (g, e) = out
    assert g[0] == e[0] and g[1] == e[1] and g[3:6] == e[3:6]
    assert g[5] > 0 and torch.equal(g[6], e[6])
    assert g[2] == 1 and e[2] > g[1][0]        # one read-back; eager: many


def test_staged_tree_loop_matches_jax_near_greedy(weights):
    pj, _, pt, _ = weights
    je = jtree.TreeEngine(jcfg.TINY_TARGET, _grow_map(jplan), pj,
                          prefill=PREFILL, max_cache_len=PREFILL + 64,
                          budget=16, chunk_size=4, temperature=1e-3,
                          top_p=0.9, prefill_chunk=16, dtype=jnp.float32,
                          donate=False)
    te = _tree_engine(pt, 1e-3, staged=True)
    ids = np.random.default_rng(5).integers(3, 199, (1, PREFILL))
    rj = jtree.tree_decode(je, jnp.asarray(ids), max_len=20, seed=1)
    rt = ttree.tree_decode(te, torch.from_numpy(ids), max_len=20, seed=1,
                           device="cpu")
    assert rt.tokens == rj.tokens and rt.steps == rj.steps
    assert rt.readbacks == 1
