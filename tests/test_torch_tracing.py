"""The port's tracer (``triforce_tpu_torch/profiling.py``: ``tracing``,
host spans, ``GraphSet.region``, counters, the clock, the summary and the
Chrome export), on the CPU, where the regions take the host clock, and on
a card (tests marked ``cuda``: the stamp kernel inside CUDA graphs and
their if-nodes, the clock's calibration, the steps counter on replays).

Oracles: the engine's own counters (a region per step, per middle verify,
per drafter forward and per replay), the tokens of the same run with no
trace current (bit for bit), the scheduler's slices and live slots
counted from outside, and hand-built regions for the arithmetic. This
file imports no JAX, so the card's run takes it with ``--noconftest``:

    python -m pytest -m cuda --noconftest tests/test_torch_tracing.py
"""

import json
import time

import numpy as np
import pytest
import torch

from triforce_tpu_torch import batched_spec as tbs
from triforce_tpu_torch import batching as tbatching
from triforce_tpu_torch import config as tcfg
from triforce_tpu_torch import graphs as tgraphs
from triforce_tpu_torch import profiling
from triforce_tpu_torch.engine import Engine
from triforce_tpu_torch.models import llama as tl

torch.set_num_threads(1)

SPEC_KW = dict(gamma=3, budget=16, chunk_size=4, draft_start_size=4,
               draft_recent_size=12, temperature=0.7, top_p=0.9)
PREFILL = 32
# Engine.generate's counters, in order
COUNTERS = ("steps", "accepted", "gamma2", "resampled", "bonus",
            "mid_draft", "mid_accept", "mid_verify", "mid_live")


@pytest.fixture(scope="module")
def params():
    return (tl.init_params(tcfg.TINY_TARGET, device="cpu",
                           dtype=torch.float32, seed=0),
            tl.init_params(tcfg.TINY_DRAFT, device="cpu",
                           dtype=torch.float32, seed=1))


def _engine(params, staged=False, **kw):
    # an EOS id outside the vocabulary: every step then ends in a resample
    # or a bonus token, so steps = resampled + bonus
    pt, pd = params
    eng = Engine(tcfg.TINY_TARGET, tcfg.SpecConfig(**SPEC_KW), pt,
                 draft_cfg=tcfg.TINY_DRAFT, draft_params=pd, prefill=PREFILL,
                 max_cache_len=PREFILL + 96, prefill_chunk=16,
                 draft_prefill_chunk=8, dtype=torch.float32, device="cpu",
                 eos_token_id=tcfg.TINY_TARGET.vocab_size, **kw)
    if staged:
        eng.graphs = tgraphs.staged("cpu")
    return eng


def _ids(seed=2, n=PREFILL, vocab=199):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(3, vocab, (1, n)))


def _state(eng, seed=100):
    ids = _ids()
    st = eng.prefill_target(eng.init_state(seed), ids)
    return eng.prefill_draft(st, ids)


def _regions(tr, name):
    return [r for r in tr.regions if r.name == name]


# ---------------------------------------------------------------------------
# regions against the engine's counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("alpha", [None, 0.9])
def test_batch1_regions_equal_counters(params, staged, alpha):
    """Two generation calls under a trace: one ``step`` region per step
    (``counters[0]`` = resampled + bonus), one ``middle`` per middle
    verify, one ``verify`` per step, one ``draft`` per drafter forward
    (``mid_draft`` at the default chain of 1) and one per replay (one a
    step), each ``verify`` / ``middle`` / ``draft`` inside a ``step`` and
    each ``step`` inside one of the loop's ``max_len`` turns a call; the
    trace's counters read the same; the prefill's regions are there."""
    eng = _engine(params, staged)
    with profiling.tracing("cpu") as tr:
        st = _state(eng)
        total = np.zeros(9, np.int64)
        for _ in range(2):
            if alpha is None:
                st, _, _, c = eng.generate(st, 12)
            else:
                st, _, _, c = eng.generate_forced(st, 12, alpha,
                                                  mode="triforce")
            assert c[0] == c[3] + c[4] > 0
            total += c
    steps, mid_draft, mid_verify = total[0], total[5], total[7]
    assert len(_regions(tr, "loop")) == 2 * 12     # max_len turns a call
    assert len(_regions(tr, "step")) == steps
    assert all(r.parent.name == "loop" for r in _regions(tr, "step"))
    assert len(_regions(tr, "verify")) == steps
    assert len(_regions(tr, "middle")) == mid_verify
    assert len(_regions(tr, "draft")) == mid_draft + steps
    for name in ("verify", "middle", "draft"):
        assert all(r.parent is not None and r.parent.name == "step"
                   for r in _regions(tr, name))
    assert len(_regions(tr, "prefill")) == 2       # 31 tokens: 16 + 15
    assert len(_regions(tr, "build")) == 1
    assert len(_regions(tr, "draft_prefill")) == PREFILL // 8
    s = tr.summary()
    assert s["counters"] == dict(zip(COUNTERS, total.tolist()))
    split = s["step"]
    assert split["steps"] == steps
    assert split["middle_count"] == mid_verify
    assert split["draft_count"] == mid_draft + steps
    parts = sum(split[k] for k in ("verify_ms", "middle_ms", "draft_ms",
                                   "rest_ms"))
    assert parts == pytest.approx(split["step_ms"])
    assert split["rest_ms"] >= 0 and split["verify_ms"] > 0
    assert s["spans"]["generate"]["count"] == 2
    assert s["spans"]["readback"]["count"] == 2


@pytest.mark.parametrize("staged", [False, True])
def test_rows_regions_equal_counters(params, staged):
    """``BatchedSpecEngine.decode`` (``engine.decode_rows``) under a
    trace: a ``step`` and a ``verify`` region per batched step, a
    ``middle`` per lockstep trip and a ``draft`` per lockstep drafter
    forward (one a trip at chain 1) and per replay, so ``draft`` =
    target forwards = lockstep trips + steps."""
    eng = _engine(params, staged)
    bat = tbs.BatchedSpecEngine(eng, mode="triforce")
    prompts = [_ids(s) for s in (2, 3, 4)]
    with profiling.tracing("cpu") as tr:
        state = bat.prefill_rows(prompts, [5, 6, 7])
        n0 = len(tr.spans)
        state, toks, ns, counters, eos = bat.decode(state, 4)
    assert len(_regions(tr, "step")) == 4
    assert len(_regions(tr, "verify")) == 4
    assert len(_regions(tr, "middle")) == bat.target_forwards - 4
    assert len(_regions(tr, "draft")) == bat.target_forwards
    assert tr.summary()["counters"]["steps"] == 4
    names = [s.name for s in tr.spans[n0:] if s.parent < n0]
    assert names == ["generate"]


def _tokens(params, traced, rows):
    eng = _engine(params)
    ctx = profiling.tracing("cpu") if traced else profiling.NULL
    with ctx:
        if rows:
            bat = tbs.BatchedSpecEngine(eng, mode="triforce")
            state = bat.prefill_rows([_ids(2), _ids(3)], [5, 6])
            state, toks, ns, counters, _ = bat.decode(state, 3)
            return toks.tolist(), ns.tolist(), counters.tolist(), \
                state.kv.seq_len.tolist()
        st, buf, n, c = eng.generate(_state(eng), 16)
        return buf[:n].tolist(), c.tolist(), int(st.kv.seq_len)


@pytest.mark.parametrize("rows", [False, True])
def test_tokens_equal_with_and_without_trace(params, rows):
    """A trace changes nothing the run computes: the same tokens, counts
    and lengths, bit for bit."""
    assert _tokens(params, True, rows) == _tokens(params, False, rows)


def test_staged_graph_keyed_by_trace_and_stampless_off():
    """A staged set keys a region captured under a trace apart from one
    captured without: the graph captured with no trace current holds no
    stamp, the one under a trace holds its region's two, turning the
    trace on captures anew and off again replays the first graph; the
    trace's key dies with it."""
    g = tgraphs.staged("cpu")

    def fn(x):
        with g.region("r"):
            return (x + 1,)

    x = torch.zeros(3)
    for _ in range(3):
        g.run("r", fn, (x,))
    assert g.captures == 1
    (plain,) = [e for e in g._entries.values()
                if isinstance(e, tgraphs._Graph)]
    assert plain.stamps == 0
    with profiling.tracing("cpu") as tr:
        for _ in range(3):
            assert torch.equal(g.run("r", fn, (x,))[0], x + 1)
    assert g.captures == 2
    traced = [e for e in g._entries.values()
              if isinstance(e, tgraphs._Graph) and e is not plain]
    assert [e.stamps for e in traced] == [2]
    assert len(_regions(tr, "r")) == 3       # first call, capture, replay
    g.run("r", fn, (x,))
    assert g.captures == 2                   # the stampless graph replays
    assert plain.alive() and not traced[0].alive()


def test_region_is_null_without_trace():
    """With no trace current a region, a span and every hook are the
    shared null context or nothing."""
    g = tgraphs.staged("cpu")
    assert profiling.current() is None
    assert g.region("r") is profiling.NULL
    assert profiling.span("x", 3) is profiling.NULL
    profiling.note("k", 1)
    profiling.event("submit", 1)
    profiling.count("steps", 1)
    with profiling.tracing("cpu"):
        with pytest.raises(RuntimeError):
            with profiling.tracing("cpu"):
                pass
    assert profiling.current() is None


# ---------------------------------------------------------------------------
# the scheduler's spans and counts
# ---------------------------------------------------------------------------

def test_spec_scheduler_spans_and_counts(params):
    """A served run under a trace: one ``admit`` span per admission
    slice with its request id and token range, in a ``cycle`` /
    ``admission`` pair; ``decode_segment`` spans name the live slots;
    ``live_row_steps`` is the live rows summed over the steps, and the
    ``mid_*`` sums are ``decode``'s counts over the live rows; each
    request is submitted, gets its first token and is done once."""
    eng = _engine(params)
    sched = tbs.SpecScheduler(eng, "triforce", slots=2, segment=2, seed=1,
                              admit_chunks=1)
    live_steps, mids = [], []
    seg, dec = sched._decode_segment, sched.bat._decode

    def counting_segment():
        live_steps.append(sum(r is not None for r in sched.slot_req)
                          * sched.segment)
        return seg()

    def counting_decode(state, steps):
        out = dec(state, steps)
        live = [s for s, r in enumerate(sched.slot_req) if r is not None]
        c = out[2][live].numpy()
        mids.append([int(c[..., tbs._COLS.index(k)].sum())
                     for k in tbs._MID])
        return out

    sched._decode_segment = counting_segment
    sched.bat._decode = counting_decode
    rids = [11, 12, 13]
    with profiling.tracing("cpu") as tr:
        for i, rid in enumerate(rids):
            sched.submit(tbatching.Request(
                rid=rid, prompt=_ids(20 + i)[0].numpy(), max_new_tokens=5))
        done = sched.run(max_wall_s=120)
    assert sorted(r.rid for r in done) == rids
    st = sched.stats
    assert st["live_row_steps"] == sum(live_steps) > 0
    assert [st[k] for k in tbs._MID] == np.sum(mids, 0).tolist()
    assert st["mid_verify"] > 0 and st["mid_draft"] > 0
    # 31 body tokens at one 16-token chunk a slice: [0, 16), [16, 31)
    admits = [s for s in tr.spans if s.name == "admit"]
    for rid in rids:
        mine = [s for s in admits if s.rid == rid]
        assert [s.args["tokens"] for s in mine] == [(0, 16), (16, PREFILL)]
        for s in mine:
            assert tr.spans[s.parent].name == "admission"
            assert tr.spans[tr.spans[s.parent].parent].name == "cycle"
    segs = [s for s in tr.spans if s.name == "decode_segment"]
    assert segs and all(set(s.rid) <= set(rids) and s.rid for s in segs)
    for name in ("submit", "first_token", "done"):
        assert sorted(rid for n, _, rid in tr.events if n == name) == rids
    s = tr.summary()
    assert s["counters"]["live_row_steps"] == st["live_row_steps"]
    assert s["live_slot_pct"] == pytest.approx(
        100 * st["live_row_steps"] / (2 * st["steps"]))
    assert 0 < s["admit_device_pct"] <= 100
    assert len(_regions(tr, "row_write")) == len(rids)


# ---------------------------------------------------------------------------
# spans, the summary's arithmetic, the export
# ---------------------------------------------------------------------------

def test_spans_nest_and_chrome_export_loads(tmp_path):
    """Spans nest by parent; marks bound the window; a gap between
    regions is named by the innermost span open across it, with the
    nearest request id; the Chrome export is JSON with every span, region,
    event, counter and mark."""
    g = tgraphs.staged("cpu")
    with profiling.tracing("cpu") as tr:
        with g.region("before"):
            pass
        tr.mark("window_start")
        with profiling.span("outer", 7):
            with g.region("a"):
                with g.region("a_inner"):
                    profiling.count("n", 2)
            with profiling.span("inner") as sp:
                profiling.note("why", "wait")
                time.sleep(0.02)
            with g.region("b"):
                profiling.event("done", 7)
        tr.mark("window_end")
    outer = [s for s in tr.spans if s.name == "outer"][0]
    assert sp.parent == tr.spans.index(outer) and outer.parent == -1
    assert sp.args == {"why": "wait"} and outer.rid == 7
    assert _regions(tr, "a_inner")[0].parent is _regions(tr, "a")[0]
    s = tr.summary()
    assert set(s["regions"]) == {"a", "a_inner", "b"}       # not "before"
    name, ms, _ = s["idle"]["gaps"][0]
    assert name == "outer/inner rid=7" and ms >= 20
    assert s["counters"] == {"n": 2} and s["events"]["done"]["count"] == 1
    path = tmp_path / "trace.json"
    tr.export_chrome(str(path))
    ev = json.loads(path.read_text())["traceEvents"]
    kinds = {(e["ph"], e["name"]) for e in ev}
    for want in [("X", "outer"), ("X", "inner"), ("X", "a"), ("X", "b"),
                 ("i", "done"), ("C", "n"), ("i", "window_start")]:
        assert want in kinds
    regions = [e for e in ev if e["ph"] == "X" and e["pid"] == 1]
    assert len(regions) == 4


def test_step_split_arithmetic():
    """``step_split`` over hand-built regions: each part summed over a
    step's direct children, per step; the rest is the step less them;
    a region outside every step counts nowhere."""
    def reg(name, t0, t1, parent=None):
        r = profiling.Region(name, t0, parent)
        r.t1 = t1
        return r

    s1 = reg("step", 0, 10_000_000)
    s2 = reg("step", 20_000_000, 26_000_000)
    regs = [s1, reg("draft", 0, 1_000_000, s1),
            reg("middle", 1_000_000, 4_000_000, s1),
            reg("verify", 5_000_000, 9_000_000, s1),
            reg("draft", 9_000_000, 9_500_000, s1), s2,
            reg("verify", 20_000_000, 24_000_000, s2),
            reg("verify", 30_000_000, 40_000_000)]
    out = profiling.step_split(regs)
    assert out["steps"] == 2 and out["step_ms"] == pytest.approx(8.0)
    assert out["verify_ms"] == pytest.approx(4.0)
    assert out["middle_ms"] == pytest.approx(1.5)
    assert out["draft_ms"] == pytest.approx(0.75)
    assert out["rest_ms"] == pytest.approx(1.75)
    assert (out["verify_count"], out["draft_count"]) == (2, 2)
    assert profiling.step_split(regs[-1:]) is None


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

CARD_TARGET = tcfg.TINY_TARGET.with_(vocab_size=512, hidden_size=256,
                                     intermediate_size=512, num_heads=4,
                                     num_kv_heads=2, head_dim=64)
CARD_DRAFT = tcfg.TINY_DRAFT.with_(vocab_size=512, hidden_size=128,
                                   intermediate_size=256, num_heads=2,
                                   num_kv_heads=2, head_dim=64)
CARD_SPEC = tcfg.SpecConfig(gamma=3, budget=64, chunk_size=8,
                            draft_start_size=4, draft_recent_size=60,
                            temperature=0.6, top_p=0.9)
CARD_PREFILL = 256


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stamp kernel has no CPU mode")
    return torch.device("cuda")


def _card_engine(dev, graphs=True):
    tp = tl.init_params(CARD_TARGET, device=dev, seed=3)
    dp = tl.init_params(CARD_DRAFT, device=dev, seed=4)
    return Engine(CARD_TARGET, CARD_SPEC, tp, draft_cfg=CARD_DRAFT,
                  draft_params=dp, prefill=CARD_PREFILL,
                  max_cache_len=CARD_PREFILL + 512, prefill_chunk=128,
                  eos_token_id=CARD_TARGET.vocab_size, device=dev,
                  graphs=graphs)


def _card_state(eng, seed=7):
    ids = _ids(0, CARD_PREFILL, CARD_TARGET.vocab_size).to(eng.device)
    st = eng.prefill_target(eng.init_state(seed), ids)
    return eng.prefill_draft(st, ids)


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [None, 0.9])
def test_card_steps_counter_on_every_replay(dev, alpha):
    """``counters[0]`` (steps) = resampled + bonus on the capturing call
    of the loop graph and on the replays after it."""
    eng = _card_engine(dev)
    st = _card_state(eng)
    for _ in range(3):
        if alpha is None:
            st, _, _, c = eng.generate(st, 24)
        else:
            st, _, _, c = eng.generate_forced(st, 24, alpha,
                                              mode="triforce")
        assert c[0] == c[3] + c[4] > 0
    assert eng.graphs.captures >= 1 and eng.graphs.replays > 24


@pytest.mark.cuda
def test_card_stamps_inside_host_spans(dev):
    """A graphed engine under a trace (the loop graph captured with its
    stamps, its if-node bodies among them): regions per kind equal the
    counters, the tokens equal those of a run with no trace current (its
    graphs hold no stamp), and every mapped stamp lies inside the host
    span around its call (the call ends in a synchronise), to within the
    calibration's half interval; the clock's drift and tick are
    reported."""
    eng = _card_engine(dev)
    plain = eng.generate(_card_state(eng), 24)
    assert all(e.stamps == 0 for e in eng.graphs._entries.values()
               if isinstance(e, tgraphs._Graph))
    with profiling.tracing(dev) as tr:
        st = _card_state(eng)
        calls = []
        for _ in range(2):
            with profiling.span("call") as sp:
                out = eng.generate(st, 24)
                torch.cuda.synchronize(dev)
            st = out[0]
            calls.append((sp, out))
    assert calls[0][1][1].tolist() == plain[1].tolist()
    assert any(e.stamps > 0 for e in eng.graphs._entries.values()
               if isinstance(e, tgraphs._Graph))
    total = sum(o[3] for _, o in calls)
    steps = [r for r in _regions(tr, "step")
             if r.t0 >= calls[0][0].t0]
    assert len(steps) == total[0]
    assert len([r for r in _regions(tr, "middle")
                if r.t0 >= calls[0][0].t0]) == total[7]
    slack = max(tr.clock["halfwidth_ns"]) + 1000
    for sp, _ in calls:
        inside = [r for r in tr.regions
                  if sp.t0 - slack <= r.t0 and r.t1 <= sp.t1 + slack]
        assert inside
    for r in steps:
        assert any(sp.t0 - slack <= r.t0 and r.t1 <= sp.t1 + slack
                   for sp, _ in calls)
    assert tr.dropped == 0 and tr.clock["tick_ns"] > 0
    assert abs(tr.clock["drift_ppm"]) < 1000
    s = tr.summary()
    assert s["step"]["steps"] == len(_regions(tr, "step"))
    assert s["step"]["rest_ms"] >= 0
