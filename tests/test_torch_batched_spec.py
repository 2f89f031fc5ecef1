"""Batched speculation and speculative serving of the port
(``triforce_tpu_torch/batched_spec.py``, the batched steps of
``engine.py``) on the CPU, tiny configs, fp32.

Port vs port: a batched row must be EXACTLY its batch-1 run with the same
seed (tokens, counts, caches), whatever rows share the batch. Each row owns
a ``torch.Generator`` and draws from it what the batch-1 step draws, in
the same order.

Port vs JAX: near-greedy token identity, as in tests/test_torch_engine.py.
At temperature 1e-4 the top-p nucleus collapses to the single top token,
so every sampled distribution is one-hot and both packages must emit the
same tokens and counts although their random streams differ. The prompts
come from ``default_rng(2)``, which has no near tie between top logits
under ``kv_quant`` either (ROADMAP.md section C).
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
from triforce_tpu_torch.engine import Engine as TEngine
from triforce_tpu_torch.models import llama as tl

torch.set_num_threads(1)

# the SpecConfig and sizes of tests/test_batched_spec.py
SPEC_KW = dict(gamma=3, budget=16, chunk_size=4, draft_start_size=4,
               draft_recent_size=12, temperature=0.7, top_p=0.9)
GREEDY_KW = dict(SPEC_KW, temperature=1e-4)
PREFILL = 32
B = 3


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


def _common(max_new=32, **kw):
    return dict(prefill=PREFILL, max_cache_len=PREFILL + max_new,
                prefill_chunk=16, draft_prefill_chunk=8, **kw)


def _t_engine(weights, spec_kw=SPEC_KW, **kw):
    _, _, pt, dt = weights
    return TEngine(tcfg.TINY_TARGET, tcfg.SpecConfig(**spec_kw), pt,
                   draft_cfg=tcfg.TINY_DRAFT, draft_params=dt,
                   dtype=torch.float32, device="cpu", **_common(**kw))


def _j_engine(weights, spec_kw=GREEDY_KW, **kw):
    pj, dj, _, _ = weights
    return JEngine(jcfg.TINY_TARGET, jcfg.SpecConfig(**spec_kw), pj,
                   draft_cfg=jcfg.TINY_DRAFT, draft_params=dj,
                   dtype=jnp.float32, donate=False, **_common(**kw))


def _prompts(n=B, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 199, (1, PREFILL)) for _ in range(n)]


def _t_prefilled(eng, ids, seed, mode):
    st = eng.prefill_target(eng.init_state(seed), torch.from_numpy(ids))
    if mode == "triforce":
        st = eng.prefill_draft(st, torch.from_numpy(ids))
    return st


def _single_runs(eng, mode, seeds, steps, force_accept=None):
    """Batch-1 runs: per row its start state (a copy) and its per-step
    (tokens, n_emitted, accepted, gamma2, mid_verify, mid_live)."""
    starts, outs, ends = [], [], []
    step = eng._step_fn(mode, force_accept)
    for ids, seed in zip(_prompts(len(seeds)), seeds):
        st = _t_prefilled(eng, ids, seed, mode)
        starts.append(st.clone())
        rec = []
        for _ in range(steps):
            st, s = step(st)
            rec.append((s.tokens.tolist(), s.n_emitted, s.accepted,
                        s.gamma2, s.mid_verify, s.mid_live))
        outs.append(rec)
        ends.append(st)
    return starts, outs, ends


def _row_record(stats, r):
    return (stats.tokens[r].tolist(), int(stats.n_emitted[r]),
            int(stats.accepted[r]), int(stats.gamma2[r]),
            int(stats.mid_verify[r]), int(stats.mid_live[r]))


# ---------------------------------------------------------------------------
# port vs port: batched rows are the batch-1 runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp32", "kv_quant"])
@pytest.mark.parametrize("mode", ["retrieval", "triforce"])
def test_batched_rows_equal_single_runs(weights, mode, kv_quant):
    """Tokens, counts and, after 6 steps (past the budget wrap), every
    cache of every row, bit for bit."""
    eng = _t_engine(weights, kv_quant=kv_quant, max_new=64)
    starts, want, ends = _single_runs(eng, mode, [11, 22, 33], 6)
    bat = tbs.BatchedSpecEngine(eng, mode=mode)
    state = tbs.stack_states(starts)
    for i in range(6):
        state, stats = bat.step(state)
        assert stats.target_forwards == int(stats.mid_verify.max()) + 1
        for r in range(B):
            assert _row_record(stats, r) == want[r][i], (mode, r, i)
    budget = SPEC_KW["budget"]
    for r, end in enumerate(tbs.unstack_state(state)):
        ref = ends[r]
        n = int(ref.kv.seq_len)
        assert int(end.kv.seq_len) == n
        assert int(end.next_token[0]) == int(ref.next_token[0])
        planes = ("k", "v", "k_scale", "v_scale") if kv_quant else ("k", "v")
        for name in planes:
            assert torch.equal(getattr(end.kv, name)[:, :, :, :n],
                               getattr(ref.kv, name)[:, :, :, :n]), name
            assert torch.equal(getattr(end.rkv, name)[:, :, :, :budget],
                               getattr(ref.rkv, name)[:, :, :, :budget]), name
        if mode == "triforce":
            assert torch.equal(end.dkv.k, ref.dkv.k)
            assert torch.equal(end.dkv.v, ref.dkv.v)


def test_batched_rows_independent(weights):
    """A row's stream must not depend on which rows share the batch."""
    eng = _t_engine(weights)
    bat = tbs.BatchedSpecEngine(eng, mode="retrieval")
    starts, _, _ = _single_runs(eng, "retrieval", [11, 22, 33], 0)

    def row0_stream(order):
        st = tbs.stack_states([starts[i].clone() for i in order])
        out = []
        for _ in range(3):
            st, stats = bat.step(st)
            out.append(stats.tokens[0].tolist())
        return out

    assert row0_stream([0, 1, 2]) == row0_stream([0, 2, 1])


@pytest.mark.parametrize("mode", ["retrieval", "triforce"])
def test_decode_equals_stepped(weights, mode):
    eng = _t_engine(weights)
    bat = tbs.BatchedSpecEngine(eng, mode=mode)
    prompts = [torch.from_numpy(p) for p in _prompts()]
    st = bat.prefill_rows(prompts, [7, 8, 9])
    toks, ns, acc = [], [], np.zeros(B, int)
    for _ in range(3):
        st, stats = bat.step(st)
        toks.append(stats.tokens.numpy())
        ns.append(stats.n_emitted.numpy())
        acc += stats.accepted.numpy()
    st2 = bat.prefill_rows(prompts, [7, 8, 9])
    _, toks2, ns2, counters, eos = bat.decode(st2, steps=3)
    np.testing.assert_array_equal(toks2, np.stack(toks, 1))
    np.testing.assert_array_equal(ns2, np.stack(ns, 1))
    np.testing.assert_array_equal(counters[:, 0], acc)
    assert toks2.shape == (B, 3, SPEC_KW["gamma"] + 2)
    assert counters.shape == (B, 4) and eos.shape == (B, 3)


def test_batched_forced_acceptance(weights):
    """force_accept=1.0: every row emits gamma accepts + the bonus token
    every step."""
    eng = _t_engine(weights)
    bat = tbs.BatchedSpecEngine(eng, mode="retrieval", force_accept=1.0)
    st = bat.prefill_rows([torch.from_numpy(p) for p in _prompts()],
                          [4, 5, 6])
    _, _, ns, counters, _ = bat.decode(st, steps=2)
    assert ns.shape == (B, 2) and (ns == SPEC_KW["gamma"] + 1).all()
    assert (counters[:, 0] == counters[:, 1]).all() and counters[:, 1].all()


def test_fixed_trip_middle_loop_batched_equals_single(weights):
    """middle_trips > 0: the lockstep trips match the batch-1 fixed-trip
    loop (dead trips draw their coins there too), and a trip-exhausted row
    proposes fewer than gamma tokens."""
    kw = dict(SPEC_KW, middle_chain=2, middle_trips=2)
    eng = _t_engine(weights, kw)
    starts, want, _ = _single_runs(eng, "triforce", [11, 22, 33], 3)
    bat = tbs.BatchedSpecEngine(eng, mode="triforce")
    state = tbs.stack_states(starts)
    for i in range(3):
        state, stats = bat.step(state)
        assert stats.target_forwards == 3          # 2 trips + the verify
        for r in range(B):
            assert 1 <= stats.gamma2[r] <= SPEC_KW["gamma"] + 1
            assert _row_record(stats, r) == want[r][i], (r, i)


def test_fixed_trip_forced_full_acceptance_matches_open_loop(weights):
    ns = {}
    for trips in (0, 1):
        kw = dict(SPEC_KW, middle_chain=3, middle_trips=trips)
        eng = _t_engine(weights, kw)
        bat = tbs.BatchedSpecEngine(eng, mode="triforce", force_accept=1.0)
        st = bat.prefill_rows([torch.from_numpy(p) for p in _prompts()],
                              [4, 5, 6])
        ns[trips] = bat.decode(st, steps=2)[2]
    assert (ns[1] == SPEC_KW["gamma"] + 2).all()
    np.testing.assert_array_equal(ns[1], ns[0])


@pytest.mark.parametrize("mode", ["retrieval", "triforce"])
def test_gated_row_stays_inert(weights, mode):
    """A dead row (kv.seq_len == 0) does not perturb the live row, whose
    trajectory equals its batch-1 run, and stays frozen at length 0."""
    eng = _t_engine(weights)
    starts, want, _ = _single_runs(eng, mode, [11, 22], 3)
    dead = starts[1]
    starts[1] = dataclasses.replace(dead, kv=dataclasses.replace(
        dead.kv, seq_len=torch.zeros((), dtype=torch.int32)))
    bat = tbs.BatchedSpecEngine(eng, mode=mode)
    state = tbs.stack_states(starts)
    for i in range(3):
        state, stats = bat.step(state)
        assert _row_record(stats, 0) == want[0][i]
        assert int(state.kv.seq_len[1]) == 0


def test_prefill_rows_peak_is_pool_plus_one_row(weights):
    """prefill_rows fills a blank pool row by row, and each row equals its
    batch-1 prefill."""
    eng = _t_engine(weights)
    bat = tbs.BatchedSpecEngine(eng, mode="triforce")
    st = bat.prefill_rows([torch.from_numpy(p) for p in _prompts()],
                          [7, 8, 9])
    assert st.kv.k.shape[:2] == (B, tcfg.TINY_TARGET.num_layers)
    assert st.kv.seq_len.tolist() == [PREFILL] * B
    for r, (ids, seed) in enumerate(zip(_prompts(), [7, 8, 9])):
        ref = _t_prefilled(eng, ids, seed, "triforce")
        row = tbs.unstack_state(st)[r]
        assert torch.equal(row.kv.k, ref.kv.k)
        assert torch.equal(row.rkv.v, ref.rkv.v)
        assert torch.equal(row.dkv.k, ref.dkv.k)
        assert int(row.dkv.seq_len) == int(ref.dkv.seq_len)
        assert int(row.next_token[0]) == int(ref.next_token[0])


# ---------------------------------------------------------------------------
# chunked admission
# ---------------------------------------------------------------------------

def test_prefill_partial_chained_equals_whole_and_jax(weights):
    """Chaining prefill_target_partial slices equals prefill_target (bit
    for bit, port vs port) and the JAX engine's prefilled state."""
    eng = _t_engine(weights, GREEDY_KW)
    ids = _prompts(1)[0]
    ref = eng.prefill_target(eng.init_state(5), torch.from_numpy(ids))
    st = eng.init_state(5)
    pos, done, slices = 0, False, 0
    while not done:
        st, pos, done = eng.prefill_target_partial(
            st, torch.from_numpy(ids), pos, 1)
        slices += 1
    assert slices > 1 and pos == PREFILL
    assert int(st.kv.seq_len) == int(ref.kv.seq_len) == PREFILL
    assert int(st.next_token[0]) == int(ref.next_token[0])
    assert torch.equal(st.kv.k, ref.kv.k) and torch.equal(st.rkv.k, ref.rkv.k)
    # a slice budget larger than the prompt finishes in one call
    one, pos1, done1 = eng.prefill_target_partial(
        eng.init_state(5), torch.from_numpy(ids), 0, 99)
    assert done1 and pos1 == PREFILL and torch.equal(one.kv.k, ref.kv.k)

    je = _j_engine(weights)
    js = je.prefill_target(je.init_state(jax.random.PRNGKey(5)),
                           jnp.asarray(ids))
    assert int(js.next_token[0]) == int(st.next_token[0])
    # fp32 arithmetic of the same inputs summed in another order
    np.testing.assert_allclose(st.kv.k.numpy(), np.asarray(js.kv.k),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(st.rkv.k.numpy(), np.asarray(js.rkv.k),
                               rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# port vs JAX, near-greedy
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_engines(weights):
    """One JAX engine per precision, shared by the tests below (every JAX
    batched program compiles for tens of seconds on the CPU)."""
    return {q: _j_engine(weights, kv_quant=q, max_new=64)
            for q in (False, True)}


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp32", "kv_quant"])
@pytest.mark.parametrize("mode", ["retrieval", "triforce"])
def test_batched_engine_matches_jax(weights, jax_engines, mode, kv_quant):
    """Both packages step from the SAME state (the JAX prefilled pool,
    carried over by ``stacked_state_from_numpy``): tokens, n_emitted and
    accepted per row and step, and the lengths at the end."""
    je = jax_engines[kv_quant]
    te = _t_engine(weights, GREEDY_KW, kv_quant=kv_quant, max_new=64)
    jbat = jbs.BatchedSpecEngine(je, mode=mode, donate=False)
    jstate = jbat.prefill_rows([jnp.asarray(p) for p in _prompts()],
                               [7, 8, 9])
    tstate = tbs.stacked_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                          [7, 8, 9], "cpu")
    tbat = tbs.BatchedSpecEngine(te, mode=mode)
    steps = 4
    jstate, jtoks, jns, jcnt, jeos = jbat.decode(jstate, steps)
    tstate, ttoks, tns, tcnt, teos = tbat.decode(tstate, steps)
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


def _serve(sched, request_cls, prompts, max_new, rids=None):
    for i, p in enumerate(prompts):
        sched.submit(request_cls(rid=i if rids is None else rids[i],
                                 prompt=p[0], max_new_tokens=max_new))
    done = sched.run(max_wall_s=600)
    assert len(done) == len(prompts) and all(r.done for r in done)
    return {r.rid: r.out for r in done}


@pytest.fixture(scope="module")
def serving_engines(weights):
    je = _j_engine(weights, max_new=256)
    te = _t_engine(weights, GREEDY_KW, max_new=256)
    return je, te


def test_spec_scheduler_six_requests_four_slots_matches_jax(serving_engines):
    """6 requests through 4 speculative slots, admission one chunk per
    cycle so that it interleaves with decode segments: every request's
    ``out`` is identical in the two packages, and the drained pool is
    gated (all lengths 0)."""
    je, te = serving_engines
    prompts, max_new = _prompts(6, seed=3), 12
    jout = _serve(jbs.SpecScheduler(je, mode="retrieval", slots=4, segment=2,
                                    admit_chunks=1),
                  jbatching.Request, prompts, max_new)
    tsched = tbs.SpecScheduler(te, mode="retrieval", slots=4, segment=2,
                               admit_chunks=1)
    tout = _serve(tsched, tbatching.Request, prompts, max_new)
    assert tout == jout
    assert all(len(o) == max_new for o in tout.values())
    assert tsched.state.kv.seq_len.tolist() == [0, 0, 0, 0]
    assert tsched.stats["prefill_tokens"] == 6 * PREFILL
    assert tsched.stats["decode_s"] > 0 and tsched.stats["admit_s"] > 0


def test_spec_scheduler_triforce_rows_equal_single_runs(weights):
    """Port vs port, sampling at temperature 0.7: every served request
    equals its batch-1 ``decoding.triforce`` run with seed = rid, through
    chunked admission, slot reuse and the drafter's row-stacked cache."""
    from triforce_tpu_torch import decoding as tdec
    eng = _t_engine(weights, max_new=256)
    prompts, max_new = _prompts(5, seed=3), 10
    sched = tbs.SpecScheduler(eng, mode="triforce", slots=2, segment=2,
                              admit_chunks=1)
    out = _serve(sched, tbatching.Request, prompts, max_new)
    for i, p in enumerate(prompts):
        solo = tdec.triforce(eng, torch.from_numpy(p), max_len=max_new + 8,
                             seed=i, device="cpu")
        assert out[i] == solo.tokens[:max_new], i
    assert sched.state.kv.seq_len.tolist() == [0, 0]
    assert sched.state.dkv.seq_len.tolist() == [0, 0]


def test_spec_scheduler_retires_on_eos_matches_jax(weights, serving_engines):
    """An EOS id taken from mid-stream: the row retires early, trimmed at
    the EOS (inclusive), its slot is reused, and both packages agree."""
    je0, _ = serving_engines
    prompt = _prompts(1, seed=3)
    probe = _serve(jbs.SpecScheduler(je0, mode="retrieval", slots=2,
                                     segment=2),
                   jbatching.Request, prompt, 16)[0]
    eos_id = probe[5]
    cut = probe.index(eos_id)
    je = _j_engine(weights, max_new=256, eos_token_id=(eos_id,))
    te = _t_engine(weights, GREEDY_KW, max_new=256, eos_token_id=(eos_id,))
    rids = [0, 101, 102]                     # 3 requests through 2 slots
    jout = _serve(jbs.SpecScheduler(je, mode="retrieval", slots=2, segment=2),
                  jbatching.Request, prompt * 3, 64, rids)
    tout = _serve(tbs.SpecScheduler(te, mode="retrieval", slots=2, segment=2),
                  tbatching.Request, prompt * 3, 64, rids)
    assert tout == jout
    assert tout[0] == probe[: cut + 1] and tout[0][-1] == eos_id


# ---------------------------------------------------------------------------
# what is not a mesh raises; no card and no device raises
# ---------------------------------------------------------------------------

def test_required_headroom_matches_jax():
    for args in ((32, 4, 6), (128, 2, 3)):
        assert tbs.SpecScheduler.required_headroom(*args) \
            == jbs.SpecScheduler.required_headroom(*args)


@pytest.mark.parametrize("build", [
    lambda eng: tbs.BatchedSpecEngine(eng, mesh=object()),
    lambda eng: tbs.SpecScheduler(eng, mesh=object()),
], ids=["BatchedSpecEngine", "SpecScheduler"])
def test_mesh_raises_not_implemented(weights, build):
    """Rows over a mesh run (``tests/test_torch_sharded_rows_tree.py``);
    what is not a ``parallel.mesh.Mesh`` is refused, as ``Engine``
    refuses it."""
    with pytest.raises(TypeError, match="Mesh"):
        build(_t_engine(weights))


def test_triforce_mode_needs_a_drafter(weights):
    _, _, pt, _ = weights
    eng = TEngine(tcfg.TINY_TARGET, tcfg.SpecConfig(**SPEC_KW), pt,
                  dtype=torch.float32, device="cpu", **_common())
    with pytest.raises(ValueError):
        tbs.BatchedSpecEngine(eng, mode="triforce")
    with pytest.raises(ValueError):
        tbs.BatchedSpecEngine(eng, mode="tree")
