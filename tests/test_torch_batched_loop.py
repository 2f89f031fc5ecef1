"""The batched speculation steps and ``SpecScheduler``'s decode segments as
device loops, on the CPU: ``BatchedSpecEngine.decode`` is ``steps`` calls
of one loop region (``engine.decode_rows``) and one read-back, as the JAX
package's ``_decode_fused``.

The staged set (``graphs.staged``) stands in for a graph set: the loop
region's first call is its "capture", ``cond`` reads its predicate but
counts no read-back, and each body's launches are kept apart from the
region's as a graph keeps them. Oracles, tolerance zero on tokens: the
staged engine emits the eager engine's tokens, counts, lengths and
generator states with the same (fake) kernel launches and reads back once
a call, where the eager engine reads each condition back; each row emits
its batch-1 run's tokens and counts, also where the rows' lockstep trips
and drafter forwards part ways (chains shorter than gamma); it emits JAX's
``BatchedSpecEngine.decode`` / ``SpecScheduler`` tokens near-greedy
(temperature 1e-4, prompts ``default_rng(2)`` / ``(3)`` as in
``tests/test_torch_batched_spec.py``); a gated row stays inert; a served
pool captures its loop once and keeps its generators.

On a card the same loop replays a CUDA graph with if-nodes
(``tests/test_torch_kernels_cuda.py``, marked ``cuda``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triforce_tpu import batched_spec as jbs
from triforce_tpu import batching as jbatching
from triforce_tpu import config as jcfg
from triforce_tpu.engine import Engine as JEngine
from triforce_tpu.models import llama as jl
from triforce_tpu_torch import batched_spec as tbs
from triforce_tpu_torch import batching as tbatching
from triforce_tpu_torch import config as tcfg
from triforce_tpu_torch import graphs as tgraphs
from triforce_tpu_torch.engine import Engine as TEngine
from triforce_tpu_torch.models import llama as tl

torch.set_num_threads(1)

SPEC_KW = dict(gamma=3, budget=16, chunk_size=4, draft_start_size=4,
               draft_recent_size=12, temperature=0.7, top_p=0.9)
GREEDY_KW = dict(SPEC_KW, temperature=1e-4)
PREFILL, B, STEPS = 32, 3, 3


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


def _common(max_new=64, **kw):
    return dict(prefill=PREFILL, max_cache_len=PREFILL + max_new,
                prefill_chunk=16, draft_prefill_chunk=8, **kw)


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


def _prompts(n=B, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 199, (1, PREFILL)) for _ in range(n)]


def _fake_counter(monkeypatch):
    """A counted "kernel" launched by every rows forward (the CPU's
    wrappers launch nothing): the loop's launch bookkeeping, the region's
    own launches and each body's apart, is held through this one."""
    def fake():
        fake.launches += 1
    fake.launches = 0
    monkeypatch.setattr(tgraphs, "COUNTED", tgraphs.COUNTED + [fake])
    for name in ("forward_append_rows", "forward_spec_rows",
                 "draft_forward_spec_rows"):
        orig = getattr(tl, name)

        def counted(*a, _orig=orig, **k):
            fake()
            return _orig(*a, **k)
        monkeypatch.setattr(tl, name, counted)
    return fake


# ---------------------------------------------------------------------------
# BatchedSpecEngine.decode: staged against eager
# ---------------------------------------------------------------------------

CASES = {
    "retrieval": ("retrieval", None, {}, {}),
    "triforce": ("triforce", None, {}, {}),
    "retrieval-forced": ("retrieval", 0.9, {}, {}),
    "triforce-forced": ("triforce", 0.9, {}, {}),
    "triforce-trips": ("triforce", None,
                       dict(middle_chain=2, middle_trips=2), {}),
    "retrieval-kv_quant": ("retrieval", None, {}, dict(kv_quant=True)),
    "triforce-kv_quant": ("triforce", None, {}, dict(kv_quant=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_staged_decode_equals_eager(weights, monkeypatch, case):
    """Two ``decode`` calls on one pool through the staged set: the eager
    engine's tokens, n_emitted, counters, eos, kv / dkv lengths, every
    row's generator state, target forwards and fake launches bit for bit;
    one capture, one read-back a call. The eager engine reads back once a
    call plus once a condition (a TriForce step has some)."""
    mode, alpha, spec_kw, kw = CASES[case]
    fake = _fake_counter(monkeypatch)
    prompts = [torch.from_numpy(p) for p in _prompts()]
    out = []
    for staged in (True, False):
        eng = _t_engine(weights, dict(SPEC_KW, **spec_kw), staged, **kw)
        bat = tbs.BatchedSpecEngine(eng, mode=mode, force_accept=alpha)
        state = bat.prefill_rows(prompts, [7, 8, 9])
        c0 = eng.graphs.captures
        got = []
        for _ in range(2):
            fake.launches, r0 = 0, eng.graphs.readbacks
            f0 = bat.target_forwards
            state, toks, ns, c, eos = bat.decode(state, STEPS)
            got.append((toks.tolist(), ns.tolist(), c.tolist(),
                        eos.tolist(), state.kv.seq_len.tolist(),
                        None if state.dkv is None
                        else state.dkv.seq_len.tolist(),
                        bat.target_forwards - f0, fake.launches,
                        eng.graphs.readbacks - r0))
        out.append((got, [g.get_state() for g in state.gens],
                    eng.graphs.captures - c0))
    (g, gg, gc), (e, eg, ec) = out
    assert [x[:8] for x in g] == [x[:8] for x in e]
    assert all(x[7] > 0 and x[6] >= STEPS * 2 for x in g)
    assert all(torch.equal(a, b) for a, b in zip(gg, eg))
    assert [x[8] for x in g] == [1, 1]
    if mode == "triforce":
        assert min(x[8] for x in e) > STEPS
    else:
        assert [x[8] for x in e] == [1, 1]
    assert gc == 1 and ec == 0


def test_step_is_a_one_step_decode(weights):
    """``step`` reads back once and returns the step's counts as tensors;
    they are ``decode``'s first step from the same pool."""
    prompts = [torch.from_numpy(p) for p in _prompts()]
    eng = _t_engine(weights, staged=True)
    bat = tbs.BatchedSpecEngine(eng, mode="triforce")
    st = bat.prefill_rows(prompts, [7, 8, 9])
    r0 = eng.graphs.readbacks
    _, stats = bat.step(st)
    assert eng.graphs.readbacks - r0 == 1
    assert stats.target_forwards == int(stats.mid_verify.max()) + 1
    st2 = bat.prefill_rows(prompts, [7, 8, 9])
    _, toks, ns, c, eos = bat.decode(st2, 1)
    assert stats.tokens.tolist() == toks[:, 0].tolist()
    assert stats.n_emitted.tolist() == ns[:, 0].tolist()
    assert stats.accepted.tolist() == c[:, 0].tolist()
    assert stats.gamma2.tolist() == c[:, 1].tolist()
    assert stats.eos.tolist() == eos[:, 0].tolist()


@pytest.mark.parametrize("spec_kw", [dict(middle_chain=2),
                                     dict(middle_chain=2, middle_trips=2)],
                         ids=["chain2", "chain2-trips2"])
def test_staged_rows_equal_single_runs(weights, spec_kw):
    """Drafter chains shorter than gamma put the rows at different
    proposal counts after a trip, so a lockstep trip or drafter forward
    runs for some rows only: each row of the staged loop still emits its
    batch-1 run's tokens and counts (temperature 0.7)."""
    kw = dict(SPEC_KW, **spec_kw)
    eng = _t_engine(weights, kw, staged=True)
    ref = _t_engine(weights, kw)
    starts, want = [], []
    for ids, seed in zip(_prompts(), [11, 22, 33]):
        st = ref.prefill_draft(ref.prefill_target(
            ref.init_state(seed), torch.from_numpy(ids)),
            torch.from_numpy(ids))
        starts.append(st.clone())
        rec = []
        for _ in range(STEPS):
            st, s = ref._step_fn("triforce", None)(st)
            rec.append((s.tokens[:s.n_emitted].tolist(), s.accepted,
                        s.gamma2, s.mid_verify, s.mid_live))
        want.append(rec)
    bat = tbs.BatchedSpecEngine(eng, mode="triforce")
    state, toks, ns, c, _ = bat.decode(tbs.stack_states(starts), STEPS)
    for r in range(B):
        assert [toks[r, s, :ns[r, s]].tolist()
                for s in range(STEPS)] == [w[0] for w in want[r]], r
        assert c[r].tolist() == np.sum([w[1:] for w in want[r]], 0).tolist()
    assert len({tuple(w[2] for w in want[r]) for r in range(B)}) > 1 \
        or len({tuple(w[3] for w in want[r]) for r in range(B)}) > 1


def test_staged_gated_row_stays_inert(weights):
    """A dead row (kv.seq_len 0) inside the loop: the live rows emit their
    batch-1 runs' tokens (the eager one-step engine), the dead row stays
    at length 0 and emits what it emits in the eager loop."""
    eng = _t_engine(weights, staged=True)
    ref = _t_engine(weights)
    starts = []
    for ids, seed in zip(_prompts(), [11, 22, 33]):
        st = ref.prefill_target(ref.init_state(seed), torch.from_numpy(ids))
        starts.append(ref.prefill_draft(st, torch.from_numpy(ids)))
    want = []
    for r in (0, 2):
        st, rec = starts[r].clone(), []
        for _ in range(STEPS):
            st, s = ref._step_fn("triforce", None)(st)
            rec.append(s.tokens[:s.n_emitted].tolist())
        want.append(rec)
    starts[1] = dataclasses.replace(starts[1], kv=dataclasses.replace(
        starts[1].kv, seq_len=torch.zeros((), dtype=torch.int32)))
    out = []
    for e in (eng, ref):
        bat = tbs.BatchedSpecEngine(e, mode="triforce")
        state = tbs.stack_states([s.clone() for s in starts])
        state, toks, ns, _, _ = bat.decode(state, STEPS)
        out.append((toks.tolist(), ns.tolist(), state.kv.seq_len.tolist()))
        for i, r in enumerate((0, 2)):
            assert [toks[r, s, :ns[r, s]].tolist()
                    for s in range(STEPS)] == want[i]
        assert state.kv.seq_len[1] == 0
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# against JAX, near-greedy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["retrieval", "triforce"])
def test_staged_decode_matches_jax(weights, mode):
    """Both packages decode from the SAME state (the JAX prefilled pool,
    carried over by ``stacked_state_from_numpy``): tokens, n_emitted,
    counters, eos, lengths and next tokens; the port reads back once."""
    je = _j_engine(weights)
    te = _t_engine(weights, GREEDY_KW, staged=True)
    jbat = jbs.BatchedSpecEngine(je, mode=mode, donate=False)
    jstate = jbat.prefill_rows([jnp.asarray(p) for p in _prompts()],
                               [7, 8, 9])
    tstate = tbs.stacked_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                          [7, 8, 9], "cpu")
    tbat = tbs.BatchedSpecEngine(te, mode=mode)
    steps = 4
    jstate, jtoks, jns, jcnt, jeos = jbat.decode(jstate, steps)
    tstate, ttoks, tns, tcnt, teos = tbat.decode(tstate, steps)
    assert te.graphs.readbacks == 1 and te.graphs.captures == 1
    np.testing.assert_array_equal(tns, np.asarray(jns))
    jtoks = np.asarray(jtoks)
    for r in range(B):
        for s in range(steps):
            n = tns[r, s]
            assert ttoks[r, s, :n].tolist() == jtoks[r, s, :n].tolist()
    np.testing.assert_array_equal(tcnt, np.asarray(jcnt))
    np.testing.assert_array_equal(teos, np.asarray(jeos))
    assert tstate.kv.seq_len.tolist() == np.asarray(jstate.kv.seq_len).tolist()
    assert tstate.next_token.tolist() \
        == np.asarray(jstate.next_token)[:, 0].tolist()


# ---------------------------------------------------------------------------
# SpecScheduler: one loop graph per pool, one read-back a segment
# ---------------------------------------------------------------------------

def _serve(sched, request_cls, prompts, max_new):
    for i, p in enumerate(prompts):
        sched.submit(request_cls(rid=i, prompt=p[0], max_new_tokens=max_new))
    done = sched.run(max_wall_s=600)
    assert len(done) == len(prompts) and all(r.done for r in done)
    return {r.rid: r.out for r in done}


def _watch_slots(sched):
    """Record, at each completed admission, whether the slot's generator
    is still the pool's object and holds the admitted row's state."""
    gens0 = list(sched.state.gens)
    seen = []
    admit = sched._admit_one

    def admit_one(slot, req):
        done = admit(slot, req)
        if done:
            g, row = sched.state.gens[slot], sched._row.gen
            seen.append((g is gens0[slot],
                         torch.equal(g.get_state(), row.get_state()),
                         sched.stats["captures"]))
        return done
    sched._admit_one = admit_one
    return seen


@pytest.mark.parametrize("mode", ["retrieval", "triforce"])
def test_staged_spec_scheduler_equals_eager(weights, monkeypatch, mode):
    """6 requests through 4 slots at temperature 0.7, admission one chunk a
    cycle: the staged scheduler serves the eager one's tokens with its
    steps, target forwards and fake launches; it captures the loop once
    for the pool, at its first segment (none after a later admission),
    reads back once a segment, and a refilled slot keeps the pool's
    generator, holding the row's state."""
    fake = _fake_counter(monkeypatch)
    prompts = _prompts(6, seed=3)
    out = []
    for staged in (True, False):
        eng = _t_engine(weights, staged=staged, max_new=256)
        sched = tbs.SpecScheduler(eng, mode=mode, slots=4, segment=2,
                                  admit_chunks=1)
        seen = _watch_slots(sched)
        fake.launches = 0
        res = _serve(sched, tbatching.Request, prompts, 10)
        st = sched.stats
        out.append((res, st["steps"], st["target_forwards"], fake.launches,
                    st["captures"], st["readbacks"], seen,
                    st["steps"] // sched.segment))
    g, e = out
    assert g[:4] == e[:4] and g[3] > 0
    assert g[4] == 1 and e[4] == 0
    assert g[5] == g[7]                       # one read-back a segment
    if mode == "triforce":
        assert e[5] > e[7]
    assert len(g[6]) == 6 and all(same and held for same, held, _ in g[6])
    # the loop is captured at the first segment, after the first admission
    # of the pool; every later admission finds it captured
    assert [c for _, _, c in g[6]][4:] == [1, 1]


def test_staged_spec_scheduler_matches_jax(weights):
    """The staged scheduler serves JAX's ``SpecScheduler`` tokens
    near-greedy (the setup of
    ``test_spec_scheduler_six_requests_four_slots_matches_jax``)."""
    je = _j_engine(weights, max_new=256)
    te = _t_engine(weights, GREEDY_KW, staged=True, max_new=256)
    prompts, max_new = _prompts(6, seed=3), 12
    jout = _serve(jbs.SpecScheduler(je, mode="retrieval", slots=4, segment=2,
                                    admit_chunks=1),
                  jbatching.Request, prompts, max_new)
    tsched = tbs.SpecScheduler(te, mode="retrieval", slots=4, segment=2,
                               admit_chunks=1)
    tout = _serve(tsched, tbatching.Request, prompts, max_new)
    assert tout == jout
    assert tsched.stats["captures"] == 1
    assert tsched.stats["readbacks"] == tsched.stats["steps"] // 2
    assert tsched.state.kv.seq_len.tolist() == [0, 0, 0, 0]


def test_ar_scheduler_counts_one_readback_a_segment(weights):
    _, _, pt, _ = weights
    sched = tbatching.Scheduler(tcfg.TINY_TARGET, tcfg.SpecConfig(**SPEC_KW),
                                pt, batch=2, max_len=PREFILL + 32,
                                prefill_chunk=16, segment=3, device="cpu",
                                dtype=torch.float32, eos_token_id=-1)
    for i, p in enumerate(_prompts(3, seed=3)):
        sched.submit(tbatching.Request(rid=i, prompt=p[0], max_new_tokens=7))
    done = sched.run()
    assert len(done) == 3
    assert sched.stats["readbacks"] == sched.stats["steps"] // 3 > 0


@pytest.mark.parametrize("mode", ["retrieval", "triforce"])
def test_cli_batched_reports_one_readback(monkeypatch, mode):
    """``--batch 2`` through the command line on the staged set: the
    decode call's read-backs land in ``DecodeResult.readbacks`` (1)."""
    from triforce_tpu_torch import cli as tcli
    init = tgraphs.GraphSet.__init__

    def staged_init(self, device, graphs=None):
        init(self, device, False)
        self.mode = "staged"
    monkeypatch.setattr(tgraphs.GraphSet, "__init__", staged_init)
    res = tcli.main(["--mode", mode, "--model", "tiny-target", "--prefill",
                     "64", "--gen_len", "6", "--gamma", "3", "--budget",
                     "16", "--chunk_size", "4", "--dataset", "synthetic",
                     "--device", "cpu", "--draft", "tiny-draft",
                     "--draft_cache_budget", "36", "--start_size", "4",
                     "--batch", "2"])
    assert res.readbacks == 1 and res.steps == 6 and res.captures == 1
