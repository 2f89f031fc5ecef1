"""Profiling and tracing — the port of ``triforce_tpu/profiling.py``.

  * ``tracing`` — the port's own tracer (``Trace``), off by default:
    host spans, device regions stamped inside CUDA graphs and their
    if-node bodies, counters and request events, on one clock;
  * ``trace`` — ``torch.profiler`` over the CPU and, where there is one,
    the CUDA card, exported as a Chrome trace (eager work only: CUPTI
    crashes over graphs that hold if-nodes);
  * ``measure_phase_times`` — each decode phase (target verify, middle
    verify, AR step, retrieval build, drafter step) timed at its real
    shapes: the (draft_time, target_time) table the tree planner reads
    (``tree/planner.py``);
  * ``measure_acceptance_vector`` — per-branch acceptance from the real
    (q, p) rows of retrieval-speculation steps: the planner's ``p`` vector.

The tracer. ``with tracing() as tr:`` makes ``tr`` the process's current
trace; with none current every hook below returns at once (``span`` hands
back one shared null context: no allocation, no clock read). While one
is:

  * ``span(name, rid)`` records a host span (``time.perf_counter_ns`` at
    both edges, its parent the innermost span open, the request id where
    there is one); a span never synchronises the device. ``note`` adds an
    argument to the innermost open span, ``event`` an instant (a
    request's submit, first token, done), ``count`` a counter increment;
  * ``GraphSet.region(name)`` (``graphs.py``) brackets device work: on a
    card it launches two stamps of ``csrc/graph_cond.cu`` (one thread
    reads ``%globaltimer`` and writes (region, edge, ns) into the trace's
    device ring at an ``atomicAdd`` index), which stream capture takes
    into a graph and its if-node bodies, so a replay stamps where the
    work runs; off the card it records the host clock in their place.
    The ring is part of a graph's key (``graphs.py``): a graph captured
    under a trace is never replayed into a freed ring, and one captured
    with no trace current holds no stamp.

The ring is read back once, when the trace ends. The device clock is
calibrated against ``perf_counter_ns`` when the trace starts and when it
ends (``CAL_ROUNDS`` rounds of host time, one stamp, synchronise, host
time; the round with the shortest host interval gives the offset at its
midpoint, half that interval its uncertainty), and every stamp is mapped
onto the host timeline by the offset interpolated between the two. ``Trace.summary()`` gives plain numbers
over the window between the marks ``window_start`` and ``window_end``
(``Trace.mark``; the whole trace without them): the regions by name, the
step split into verify, middle, draft and the rest, the counters, the
clock's drift, and the longest device gaps between stamped regions, each
named by the innermost host span open across it.
``Trace.export_chrome(path)`` writes host spans and device regions on one
timeline (``chrome://tracing``, Perfetto).

On a graphed engine (``Engine.graphs``) ``measure_phase_times`` times
each decode forward as the replay of its captured graph, as the decode
loop runs it; on an eager one it times the eager forward. The retrieval
build stays eager either way (it runs once per prefill and is not
captured).

The caches are updated in place (``cache.py``), so ``measure_phase_times``
runs only forwards that write nothing the state holds live
(``commit=False``, or a build into a scratch retrieval cache) and puts the
full cache's slots that the verify forwards write back as they were: the
caller's state is unchanged, bit for bit.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import json
import math
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

from . import _build
from .models import llama
from .ops import sampling

# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------

CAPACITY = 1 << 20    # device stamps a trace's ring holds (16 MiB)
CAL_ROUNDS = 20       # calibration rounds at each end of a trace
STEP_PARTS = ("verify", "middle", "draft")     # the rest is the step's own
ADMIT_REGIONS = ("prefill", "build", "draft_prefill", "row_write")
NULL = contextlib.nullcontext()
_CURRENT: Optional["Trace"] = None


def current() -> Optional["Trace"]:
    """The process's current trace, or None."""
    return _CURRENT


def span(name: str, rid=None):
    """A host span of the current trace (a context manager that yields
    the ``Span``), or ``NULL`` with none current."""
    tr = _CURRENT
    return NULL if tr is None else Span(tr, name, rid)


def note(key: str, value) -> None:
    """Attach ``key=value`` to the current trace's innermost open span."""
    tr = _CURRENT
    if tr is not None and tr._open:
        tr.spans[tr._open[-1]].args[key] = value


def event(name: str, rid=None) -> None:
    """An instant of the current trace (a request's submit, first token,
    done)."""
    tr = _CURRENT
    if tr is not None:
        tr.events.append((name, time.perf_counter_ns(), rid))


def count(name: str, value: int) -> None:
    """Add ``value`` to the current trace's counter ``name``, stamped with
    the host clock (``summary`` sums the window's increments)."""
    tr = _CURRENT
    if tr is not None:
        tr.counts.append((name, time.perf_counter_ns(), int(value)))


@contextlib.contextmanager
def tracing(device=None, capacity: int = CAPACITY):
    """Make a new ``Trace`` the process's current one for the block and
    yield it. ``device``: the card whose regions are stamped (default the
    current CUDA card, else the CPU: host clocks only). At the end the
    trace calibrates the clock again and reads its ring back; ``summary``
    and ``export_chrome`` read it afterwards."""
    global _CURRENT
    if _CURRENT is not None:
        raise RuntimeError("a trace is already current")
    tr = Trace(device, capacity)
    _CURRENT = tr
    try:
        yield tr
    finally:
        _CURRENT = None
        tr.finish()


class Span:
    """A host span: ``name``, ``t0`` / ``t1`` (``perf_counter_ns``),
    ``parent`` (its index in the trace's ``spans``, -1 at the top), the
    request id ``rid`` (an id or a list of them) and ``args``."""
    __slots__ = ("trace", "name", "t0", "t1", "parent", "rid", "args")

    def __init__(self, trace: "Trace", name: str, rid=None):
        self.trace, self.name, self.rid = trace, name, rid
        self.t0 = self.t1 = None
        self.parent = -1
        self.args = {}

    def __enter__(self) -> "Span":
        tr = self.trace
        self.parent = tr._open[-1] if tr._open else -1
        tr._open.append(len(tr.spans))
        tr.spans.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter_ns()
        self.trace._open.pop()


class Region:
    """A device region on the host timeline: ``name``, ``t0`` / ``t1``
    (ns) and the enclosing ``Region`` (``parent``, None at the top)."""
    __slots__ = ("name", "t0", "t1", "parent")

    def __init__(self, name, t0, parent):
        self.name, self.t0, self.t1, self.parent = name, t0, None, parent

    @property
    def ns(self) -> float:
        return self.t1 - self.t0


class _Stamps:
    """The two stamps of one region (``GraphSet.region``), inside a host
    span of the same name where the region runs eagerly."""
    __slots__ = ("trace", "device", "code", "span")

    def __init__(self, trace, device, code, host_span):
        self.trace, self.device, self.code = trace, device, code
        self.span = host_span

    def __enter__(self) -> None:
        if self.span is not None:
            self.span.__enter__()
        self.trace._stamp(self.device, self.code)

    def __exit__(self, *exc) -> None:
        self.trace._stamp(self.device, self.code + 1)
        if self.span is not None:
            self.span.__exit__()


class Trace:
    """What one ``tracing`` block recorded (module docstring). Host records
    are plain lists. On a card the stamps go to ``ring`` ([capacity, 2]
    int64 (code, ns), ``code`` = 2 x region id + edge), ``head`` counting
    them; off the card ``ring`` is one element, the key of the graphs
    captured under the trace, and the regions take the host clock."""

    def __init__(self, device=None, capacity: int = CAPACITY):
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.capacity = capacity
        self.spans: list = []
        self._open: list = []       # indices of the open spans
        self.events: list = []      # (name, ns, rid)
        self.counts: list = []      # (name, ns, value)
        self.marks: Dict[str, int] = {}
        self.names: list = []       # region names by id
        self._ids: Dict[str, int] = {}
        self.issued = 0             # stamps launched (or captured) or taken
        self._host: list = []       # (code, ns) of regions on the host clock
        self.regions: list = []     # every ``Region``, at ``finish``
        self.stamps = 0             # stamps recorded (device and host)
        self.dropped = 0            # device stamps past the ring's end
        self.clock: dict = {}
        self.t_start = time.perf_counter_ns()
        self.t_end = None
        if self.device.type == "cuda":
            i64 = dict(dtype=torch.int64, device=self.device)
            self.ring = torch.zeros((capacity, 2), **i64)
            self.head = torch.zeros((1,), **i64)
            self._cal = torch.zeros((2 * CAL_ROUNDS, 2), **i64)
            self._cal_head = torch.zeros((1,), **i64)
            self._cal_host: list = []
            self._calibrate()
        else:
            self.ring = torch.zeros((1,), dtype=torch.int64)
            self.head = None

    # -- recording --------------------------------------------------------

    def mark(self, name: str) -> None:
        """A named instant on the host clock (``window_start`` and
        ``window_end`` bound ``summary``)."""
        self.marks[name] = time.perf_counter_ns()

    def region(self, name: str, device, host_span: bool) -> _Stamps:
        """The stamps of a region ``name`` run on ``device``; with
        ``host_span`` inside a host span of the same name (the region runs
        now, not into a capture)."""
        rid = self._ids.get(name)
        if rid is None:
            rid = self._ids[name] = len(self.names)
            self.names.append(name)
        return _Stamps(self, device, 2 * rid,
                       Span(self, name) if host_span else None)

    def _stamp(self, device: torch.device, code: int) -> None:
        self.issued += 1
        if device.type != "cuda":
            self._host.append((code, time.perf_counter_ns()))
            return
        if device != self.device:
            raise ValueError(f"the trace stamps {self.device}; a region "
                             f"ran on {device}")
        self._launch(self.head, self.ring, code)

    def _launch(self, head, ring, code: int) -> None:
        lib = _build.lib("graph_cond.cu")
        stream = torch.cuda.current_stream(self.device).cuda_stream
        _build.check(lib.tf_stamp(stream, head.data_ptr(), ring.data_ptr(),
                                  ring.shape[0], code), "stamp")

    def _calibrate(self) -> None:
        """``CAL_ROUNDS`` rounds of (host ns, one stamp, synchronise, host
        ns) into the calibration ring."""
        torch.cuda.synchronize(self.device)
        for _ in range(CAL_ROUNDS):
            h0 = time.perf_counter_ns()
            self._launch(self._cal_head, self._cal, -1)
            torch.cuda.synchronize(self.device)
            self._cal_host.append((h0, time.perf_counter_ns()))

    def finish(self) -> None:
        """Calibrate again, read the ring back (once) and build the
        regions on the host timeline. The ring is dropped, and with it
        the graphs captured under the trace (their keys die)."""
        if self.t_end is not None:
            return
        regions = []
        if self.device.type == "cuda":
            self._calibrate()
            n = int(self.head[0])
            self.dropped = max(n - self.capacity, 0)
            stamps = self.ring[:n - self.dropped].cpu().tolist()
            self.stamps = len(stamps)
            cal = self._cal.cpu().tolist()
            self._fit_clock(cal, [ns for _, ns in stamps + cal])
            (d0, o0), (d1, o1) = self.clock.pop("fit")
            slope = (o1 - o0) / (d1 - d0) if d1 != d0 else 0.0
            regions = self._nest((code, ns - o0 - slope * (ns - d0))
                                 for code, ns in stamps)
            self._cal = self._cal_head = None
        self.ring = self.head = None
        self.t_end = time.perf_counter_ns()
        self.stamps += len(self._host)
        regions += self._nest(self._host)
        regions.sort(key=lambda r: r.t0)
        self.regions = regions
        self._host = []

    def _fit_clock(self, cal, times) -> None:
        """The clock from the calibration ring: each end's offset (device
        - host ns, ``fit``), their drift, each end's half interval (the
        offset's uncertainty) and, from every device time read, the
        clock's tick (the greatest common divisor of the differences
        between distinct readings) and its smallest step."""
        r = CAL_ROUNDS
        fit, half = [], []
        for dev, host in ((cal[:r], self._cal_host[:r]),
                          (cal[r:], self._cal_host[r:])):
            i = min(range(r), key=lambda j: host[j][1] - host[j][0])
            h0, h1 = host[i]
            fit.append((dev[i][1], dev[i][1] - (h0 + h1) / 2))
            half.append((h1 - h0) / 2)
        times = sorted(set(times))
        steps = [b - a for a, b in zip(times, times[1:])]
        (d0, o0), (d1, o1) = fit
        self.clock = dict(
            fit=fit, drift_ns=o1 - o0,
            drift_ppm=1e6 * (o1 - o0) / max(d1 - d0, 1),
            halfwidth_ns=half, tick_ns=functools.reduce(math.gcd, steps, 0),
            min_step_ns=min(steps) if steps else 0)

    def _nest(self, stamps) -> list:
        """Regions from (code, host ns) stamps in the order they ran: a
        begin opens a region inside the one open, its end closes it (an
        unmatched begin is dropped)."""
        out, stack = [], []
        for code, ns in stamps:
            rid, edge = divmod(int(code), 2)
            if not edge:
                stack.append((rid, Region(self.names[rid], ns,
                                          stack[-1][1] if stack else None)))
                continue
            while stack and stack[-1][0] != rid:
                stack.pop()
            if stack:
                reg = stack.pop()[1]
                reg.t1 = ns
                out.append(reg)
        return out

    # -- reading ----------------------------------------------------------

    def window(self) -> tuple:
        """(start, end) host ns: the marks, else the whole trace."""
        end = self.t_end if self.t_end is not None else time.perf_counter_ns()
        return (self.marks.get("window_start", self.t_start),
                self.marks.get("window_end", end))

    def summary(self, top: int = 10) -> dict:
        """Plain numbers over the window (``window``): ``regions`` (count
        and device ms by name), ``step`` (``step_split``), ``counters``
        and ``events`` (the window's sums), ``spans`` (count and host ms
        by name), ``live_slot_pct`` (live row-steps over slot-steps, the
        scheduler's counters), ``admit_device_pct`` (device time of the
        admission regions that start inside ``admission`` spans over
        those spans' host time), ``idle`` (``gaps``), the ``clock`` and
        the stamps the whole trace recorded and dropped."""
        w0, w1 = self.window()
        regs = [r for r in self.regions if r.t0 >= w0 and r.t1 <= w1]
        spans = [s for s in self.spans
                 if s.t1 is not None and s.t0 >= w0 and s.t1 <= w1]
        out = {"window_s": (w1 - w0) / 1e9, "stamps": self.stamps,
               "dropped": self.dropped, "clock": dict(self.clock)}
        out["regions"] = _tally((r.name, r.ns) for r in regs)
        out["step"] = step_split(regs)
        counters = defaultdict(int)
        for name, ns, v in self.counts:
            if w0 <= ns <= w1:
                counters[name] += v
        out["counters"] = dict(counters)
        out["events"] = _tally((name, 0) for name, ns, _ in self.events
                               if w0 <= ns <= w1)
        out["spans"] = _tally((s.name, s.t1 - s.t0) for s in spans)
        if counters.get("slot_steps"):
            out["live_slot_pct"] = 100.0 * counters["live_row_steps"] \
                / counters["slot_steps"]
        admission = [s for s in spans if s.name == "admission"]
        if admission:
            out["admit_device_pct"] = 100.0 * _inside(
                [r for r in regs if r.name in ADMIT_REGIONS], admission) \
                / sum(s.t1 - s.t0 for s in admission)
        out["idle"] = self.gaps(regs, top)
        return out

    def gaps(self, regs, top: int = 10) -> dict:
        """The device time between stamped regions (top-level ones, on
        the host timeline): ``busy_ms`` covered, ``gap_ms`` between them
        and the ``top`` longest gaps as [name, ms, s after the window's
        start], each named by its host span (``span_name``)."""
        ivs = sorted((r.t0, r.t1) for r in regs if r.parent is None)
        busy, holes, end = 0.0, [], None
        for a, b in ivs:
            if end is None or a > end:
                if end is not None:
                    holes.append((a - end, end, a))
                busy, end = busy + b - a, b
            elif b > end:
                busy, end = busy + b - end, b
        holes.sort(reverse=True)
        w0 = self.window()[0]
        return {"busy_ms": busy / 1e6,
                "gap_ms": sum(h[0] for h in holes) / 1e6,
                "gaps": [[self.span_name(g0, g1), ns / 1e6, (g0 - w0) / 1e9]
                         for ns, g0, g1 in holes[:top]]}

    def span_name(self, t0, t1) -> str:
        """The host span a gap [t0, t1] belongs to, as the path of span
        names from the top with the nearest request id on it: the
        innermost span open over at least half of it, else the span open
        over most of it."""
        best, key = -1, None
        for i, s in enumerate(self.spans):
            if s.t1 is None:
                continue
            over = min(s.t1, t1) - max(s.t0, t0)
            if over <= 0:
                continue
            k = (1, self._depth(i), s.t0) if 2 * over >= t1 - t0 \
                else (0, over, s.t0)
            if key is None or k > key:
                best, key = i, k
        names, rid = [], None
        while best >= 0:
            s = self.spans[best]
            names.append(s.name)
            rid = s.rid if rid is None else rid
            best = s.parent
        path = "/".join(reversed(names)) or "(no span)"
        return path if rid is None else f"{path} rid={rid}"

    def _depth(self, i: int) -> int:
        d = 0
        while self.spans[i].parent >= 0:
            d, i = d + 1, self.spans[i].parent
        return d

    def export_chrome(self, path: str) -> None:
        """Host spans (pid 0), device regions (pid 1), request events,
        counters and marks on one timeline, in microseconds since the
        trace's start, as a Chrome trace (JSON)."""
        base = self.t_start

        def us(ns):
            return (ns - base) / 1e3

        ev = [dict(name="process_name", ph="M", pid=0,
                   args=dict(name="host")),
              dict(name="process_name", ph="M", pid=1,
                   args=dict(name=f"device {self.device}"))]
        for s in self.spans:
            if s.t1 is not None:
                args = dict(s.args, **({} if s.rid is None
                                       else {"rid": s.rid}))
                ev.append(dict(name=s.name, ph="X", pid=0, tid=0,
                               ts=us(s.t0), dur=(s.t1 - s.t0) / 1e3,
                               args=args))
        for r in self.regions:
            ev.append(dict(name=r.name, ph="X", pid=1, tid=0, ts=us(r.t0),
                           dur=r.ns / 1e3))
        for name, ns, rid in self.events:
            ev.append(dict(name=name, ph="i", s="p", pid=0, tid=0,
                           ts=us(ns), args={"rid": rid}))
        totals = defaultdict(int)
        for name, ns, v in self.counts:
            totals[name] += v
            ev.append(dict(name=name, ph="C", pid=0, ts=us(ns),
                           args={name: totals[name]}))
        for name, ns in self.marks.items():
            ev.append(dict(name=name, ph="i", s="g", pid=0, tid=0,
                           ts=us(ns)))
        with open(path, "w") as f:
            json.dump({"traceEvents": ev, "displayTimeUnit": "ms",
                       "otherData": {"clock": self.clock,
                                     "dropped": self.dropped}}, f,
                      default=_plain)


def step_split(regs) -> Optional[dict]:
    """The ``step`` regions among ``regs`` split by their direct children:
    ``steps``, then a step's mean device ms (``step_ms``), its
    ``verify_ms``, ``middle_ms`` and ``draft_ms`` (each summed over the
    step's regions of that name) and ``rest_ms`` (the step less the
    three: samples, accept walks, rollback, refresh, eviction, buffer
    writes), with each part's region count (``<part>_count``)."""
    steps = [r for r in regs if r.name == "step"]
    if not steps:
        return None
    ids = {id(r) for r in steps}
    ns, n = dict.fromkeys(STEP_PARTS, 0.0), dict.fromkeys(STEP_PARTS, 0)
    for r in regs:
        if r.name in ns and r.parent is not None and id(r.parent) in ids:
            ns[r.name] += r.ns
            n[r.name] += 1
    k = len(steps)
    out = {"steps": k, "step_ms": sum(r.ns for r in steps) / k / 1e6}
    for part in STEP_PARTS:
        out[part + "_ms"] = ns[part] / k / 1e6
        out[part + "_count"] = n[part]
    out["rest_ms"] = out["step_ms"] - sum(out[p + "_ms"] for p in STEP_PARTS)
    return out


def _tally(pairs) -> dict:
    """{name: {"count", "ms"}} of (name, ns) pairs."""
    out = {}
    for name, ns in pairs:
        t = out.setdefault(name, {"count": 0, "ms": 0.0})
        t["count"] += 1
        t["ms"] += ns / 1e6
    return out


def _inside(regs, spans) -> float:
    """ns of the regions whose start lies inside one of ``spans``
    (disjoint host spans)."""
    spans = sorted((s.t0, s.t1) for s in spans)
    starts = [a for a, _ in spans]
    total = 0.0
    for r in regs:
        i = bisect.bisect_right(starts, r.t0) - 1
        if i >= 0 and r.t0 <= spans[i][1]:
            total += r.ns
    return total


def _plain(o):
    return o.item() if hasattr(o, "item") else str(o)


# ---------------------------------------------------------------------------
# torch.profiler, the planner's measurements
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (CPU activity, and CUDA where a
    card is present); yields the profiler, so the caller can read
    ``key_averages()``, and writes ``<log_dir>/trace.json`` (Chrome trace
    format) at the end."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _time_calls(fn, dev: torch.device, iters: int, warm: int = 2) -> float:
    """Seconds per ``fn()``: on a card, CUDA events around ``iters`` calls
    after ``warm`` of them; on the CPU, the host clock."""
    for _ in range(warm):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        return max(e0.elapsed_time(e1) * 1e-3 / iters, 1e-9)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return max((time.perf_counter() - t0) / iters, 1e-9)


@contextlib.contextmanager
def _slots_restored(kv, n: int, offset: int = 0):
    """Put the full cache's slots ``[seq_len, seq_len + n)``, which a
    forward_append of n tokens writes, back as they were afterwards.
    ``offset``: the global slot of ``kv``'s first one (a rank's shard of a
    cache split over ``sp``); the slots of the window it does not hold are
    left to their ranks."""
    s0 = int(kv.seq_len) - offset
    lo, hi = max(s0, 0), min(max(s0 + n, 0), kv.max_len)
    planes = [p for p in (kv.k, kv.v, kv.k_scale, kv.v_scale)
              if p is not None]
    saved = [p[:, :, :, lo:hi].clone() for p in planes]
    try:
        yield
    finally:
        for p, x in zip(planes, saved):
            p[:, :, :, lo:hi] = x


def measure_phase_times(engine, state, iters: int = 20) -> Dict[str, float]:
    """Per-phase seconds for a prefilled engine state. Keys:
    ``target_verify`` (full-cache forward of gamma+2 tokens),
    ``middle_step`` (one retrieval-cache verify of gamma+1 tokens),
    ``ar_step``, ``retrieval_build`` (the 1-token forward that builds the
    retrieval cache, into a scratch copy of it) and, with a drafter,
    ``draft_step``. Each is timed over ``iters`` calls after a warm-up (on
    a graphed engine the warm-up captures, and the timed calls are
    replays); ``state`` is left as it was. Over a mesh every rank calls
    it and times its own forwards, collectives included."""
    from . import engine as engine_mod
    from . import graphs as graphs_mod
    cfg, sp = engine.target_cfg, engine.spec
    dev = engine.device
    gamma = sp.gamma
    kv = state.kv
    ids = {t: torch.zeros((1, t), dtype=torch.int64, device=dev)
           for t in (1, gamma + 1, gamma + 2)}
    out: Dict[str, float] = {}

    def phase(name, region, inputs, cache):
        return lambda: engine.graphs.run("phase " + name, region, inputs,
                                         caches=graphs_mod.planes(cache))

    def verify(t):
        return phase(f"verify {t}", lambda x, n: llama.forward_append(
            cfg, engine.t_params, x, engine_mod._kv_at(kv, n),
            **engine.fwd)[:1], (ids[t], kv.seq_len), kv)

    offset = engine.mesh.index("sp") * kv.max_len if engine.shard_seq else 0
    with _slots_restored(kv, gamma + 2, offset):
        out["target_verify"] = _time_calls(verify(gamma + 2), dev, iters)
        out["ar_step"] = _time_calls(verify(1), dev, iters)
        scratch = state.rkv.clone()
        out["retrieval_build"] = _time_calls(
            lambda: engine._build(kv, scratch, ids[1]), dev,
            max(2, iters // 2))
        del scratch
    out["middle_step"] = _time_calls(phase(
        "middle", lambda x, n: llama.forward_spec(
            cfg, engine.t_params, x, state.rkv, n, sp.budget, commit=False,
            act_quant=sp.mid_act_quant, mesh=engine.mesh)[:1],
        (ids[gamma + 1], kv.seq_len), state.rkv), dev, iters)
    if engine.draft_cfg is not None:
        out["draft_step"] = _time_calls(phase(
            "draft", lambda x: llama.draft_forward_spec(
                engine.draft_cfg, engine.d_params, x, state.dkv, sp,
                commit=False)[:1],
            (ids[gamma + 1],), state.dkv), dev, iters)
    return out


def _accept_walk(q, p, cand, rs):
    """The SpecTree accept chain over P real (q, p) rows at once: the
    candidates ``cand`` [P, K] (drawn from q without replacement) are
    rejection-tested in order against p with residual updates. Returns
    [P] the 1-based index of the first accept (0 = none)."""
    rows = torch.arange(q.shape[0], device=q.device)
    accepted = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    for b in range(cand.shape[1]):
        tok = cand[:, b]
        ok = (accepted == 0) & (p[rows, tok]
                                > rs[:, b] * q[rows, tok].clamp_min(1e-37))
        accepted = torch.where(ok, b + 1, accepted)
        upd = (accepted == 0)[:, None]              # rejected: update dists
        resid = (p - q).clamp_min(0)
        p2 = resid / resid.sum(-1, keepdim=True).clamp_min(1e-37)
        q2 = q.clone()
        q2[rows, tok] = 0.0
        q2 = q2 / q2.sum(-1, keepdim=True).clamp_min(1e-37)
        q = torch.where(upd, q2, q)
        p = torch.where(upd, p2, p)
    return accepted


def measure_acceptance_vector(engine, input_ids, max_branch: int = 4,
                              steps: int = 32, seed: int = 0,
                              state=None) -> np.ndarray:
    """Empirical per-branch acceptance vector for the tree planner, from
    the real hierarchy: ``steps`` retrieval-speculation steps, each
    exposing the middle (q) and target (p) rows of its gamma proposal
    positions (``return_probs``). For every real (q, p) pair ``max_branch``
    candidates are drawn from q without replacement (Gumbel top-k) and
    rejection-tested in order against p with residual updates; p[b] is
    the share of positions whose first accept was candidate b. The draws
    come from a ``torch.Generator`` seeded from ``seed``, so the result is
    deterministic. A ``state`` passed in is prefilled and consumed (its
    caches are updated in place)."""
    from . import engine as engine_mod
    if state is None:
        state = engine.init_state(seed)
        state = engine.prefill_target(state, input_ids)
    gamma = engine.spec.gamma
    dev = engine.device
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    wins = torch.zeros(max_branch + 1, dtype=torch.float32, device=dev)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(steps):
        state, _stats, (_toks, q_rows, p_rows) = \
            engine_mod._retrieval_spec_step(engine, state,
                                            return_probs=True)
        q = q_rows[:gamma].float()
        p = p_rows[:gamma].float()
        cand = sampling.gumbel_topk_without_replacement(q, max_branch, gen)
        rs = torch.rand((gamma, max_branch), generator=gen, device=dev)
        acc = _accept_walk(q, p, cand, rs)
        valid = (q.sum(-1) > 0).float()
        wins.index_add_(0, acc, valid)
        total += valid.sum()
    wins = wins.double().cpu().numpy()
    wins[0] = 0.0        # bucket 0 = no accept: counts only in the total
    return wins / max(float(total), 1.0)
