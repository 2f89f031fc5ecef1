"""CUDA-graph capture and replay of the fixed-shape decode and prefill
programs — the counterpart of the ``jax.jit`` programs of
``triforce_tpu/engine.py:160-311`` (``_ar_step``, ``_triforce_step``,
``_retrieval_spec_step``) and of its prefill programs (``:175-241``: the
target's chunk scan, the retrieval build, the drafter's chunk scan), of
the tree engine's (``triforce_tpu/tree/spectree.py:126-223``) and of the
batched steps' (``triforce_tpu/batched_spec.py:203-221``).

A JAX engine compiles each of those programs once and runs it with one
dispatch. Here a *region* is a Python function of device tensors that
makes no host decision (no read-back, no host-to-device copy); a
``GraphSet`` runs it:

  * the first call of a key runs the region eagerly: its results are real
    and its generator draws count, so nothing is discarded; kernels build,
    cuBLAS initialises and the per-shape caches (RoPE tables, masks, split
    plans) fill outside any capture;
  * the second call captures it into a ``torch.cuda.CUDAGraph`` on the
    set's own stream and memory pool, then replays it; every later call
    replays it.

The key of a graph is everything that changes its addresses or shapes: the
region's name, its inputs' shapes and dtypes, the cache planes it reads or
writes (by storage address, shape and strides), the generators it draws
from, and the host values the region's Python branches on (``extra``). A
key whose planes or generators have been freed is dead: its graph is
dropped and the next call starts over (a new state, or a ``clone``, gets
its own graphs).

Inputs are staged: each replay copies the caller's tensors into the
graph's static input buffers (host ints and floats are written with
``fill_``, so they never cross as a copy from host memory). Outputs are
handed back as COPIES of the graph's static outputs, so no caller ever holds
memory that the next replay overwrites. Regions must not write their
inputs in place (the write would land in the static buffer, not in the
caller's tensor); the cache planes they write are not inputs but captured
addresses, which is why they are part of the key.

Generators: every generator a region draws from is registered with its
graph (``CUDAGraph.register_generator_state``); a replay then advances it
by exactly what the eager calls would, so a graphed run draws the numbers
an eager run with the same seed draws.

Launch counters: the kernel wrappers count launches in Python
(``flash_decode_append.launches`` and the others, ``COUNTED``), which runs
only at capture. A graph records how many launches of each wrapper it
captured, takes them back off the counters, and adds them on every replay
(the first replay right after the capture included).

One memory pool per set: all of an engine's graphs share it. A set is an
attribute of its engine and nothing at module level refers to it, so the
pool goes with the engine; ``release`` drops the graphs at once (then
``torch.cuda.empty_cache`` can return the pool).

No fallback: on the card a failed capture or replay raises. An engine runs
eagerly only where its caller passed ``graphs=False``.

Conditional bodies (``GraphSet.cond``): a region may run part of its work
only where a 0-d bool device tensor holds, the counterpart of JAX's
``lax.cond`` and of a ``while_loop`` bounded by its trip count. Under a
capture the body becomes a CUDA if-node (``torch.cuda.CUDAGraph.
begin_capture_to_if_node``), so a replay decides on the device and reads
nothing back; an eager set (and a region's first, eager call) reads the
predicate back and runs the body or not. A body draws no random numbers
(a replay advances a registered generator by every draw it captured,
skipped bodies' too); its launches are kept apart from its region's: each
captured body adds one to its own device counter, and ``read`` (the one
read-back of a generation) adds count x the body's captured launches to
the wrappers' counters. A region reached while its set is already running
one is called inline, so it is captured into the outer graph.

Loops (``run(..., capture_first=True)``): a region that keeps its state in
place (``buffers``: tensors made once per key, like its graph) takes no
inputs and returns nothing, so a replay needs no copies; its first call
captures at once, since an eager first call would read its predicates
back. The per-shape device caches its forwards read must then exist
before the capture (the engines build them at construction); one built
under a capture raises.

Tracing (``profiling.tracing``): ``region(name)`` brackets a region's
work with the current trace's stamps (``profiling.py``), which a capture
takes into the graph and its if-node bodies; with no trace current it is
a shared null context, so a graph captured then holds no stamp. The
trace's ring is part of every key (``run``), as a cache plane is: a graph
captured under a trace dies with its ring, and turning tracing on or off
captures anew instead of replaying a graph of the other kind.

``staged(device)`` is a test-only set for the CPU: the same keys, staging
and counter bookkeeping, with the capture replaced by a direct call of the
region through the static buffers, so that an output that aliases a static
buffer, or a key that misses a state change, shows on the CPU too. Its
``cond`` reads the predicate (standing in for an if-node, it counts no
read-back) and keeps each body's launches apart as a graph does. It
refuses a CUDA device.
"""

from __future__ import annotations

import collections
import time
import weakref
from typing import Optional

import torch

from . import _build
from . import profiling
from .ops import flash_decode as _fd
from .ops import retrieval_kernel as _rk

# every kernel wrapper with a Python launch counter
COUNTED = [_fd.flash_decode_append, _fd.flash_decode_append_int8,
           _fd.flash_decode_partials, _fd.flash_decode_partials_int8,
           _fd.flash_decode_append_batched,
           _fd.flash_decode_append_batched_int8,
           _rk.chunk_scores, _rk.chunk_scores_int8]


def _counts() -> list:
    return [fn.launches for fn in COUNTED]


def _set_counts(values) -> None:
    for fn, v in zip(COUNTED, values):
        fn.launches = v


def _add_counts(delta, times: int = 1) -> None:
    for fn, d in zip(COUNTED, delta):
        fn.launches += d * times


def _diff(a, b) -> list:
    return [x - y for x, y in zip(a, b)]


def _stamps_issued() -> int:
    tr = profiling.current()
    return 0 if tr is None else tr.issued


MAX_BODIES = 4096     # captured if-node bodies a set can count
MAX_DEPTH = 4         # if-node bodies nested in one another
_COND_SOURCE = "graph_cond.cu"
# the if-node bodies' memory pool, one per device for the process: what a
# body allocates on its stream can be kept by process-wide caches (cuBLAS
# keeps a workspace per stream), so the pool outlives every graph set
_BODY_POOLS: dict = {}


def _body_pool(device: torch.device):
    pool = _BODY_POOLS.get(device.index)
    if pool is None:
        pool = _BODY_POOLS[device.index] = torch.cuda.MemPool()
    return pool


def resolve(graphs: Optional[bool], device: torch.device) -> bool:
    """``graphs=None``: on for a CUDA device, off on the CPU. ``True`` on
    the CPU raises (there is nothing to capture)."""
    if graphs is None:
        return device.type == "cuda"
    if graphs and device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, the engine is on "
                         f"{device}")
    return bool(graphs)


def planes(*caches) -> tuple:
    """The buffers of caches (``KVCache``, ``RetrievalCache``,
    ``StreamingCache``) a region reads or writes, for its key."""
    out = []
    for c in caches:
        if c is None:
            continue
        out += [p for p in (c.k, c.v, getattr(c, "k_scale", None),
                            getattr(c, "v_scale", None)) if p is not None]
    return tuple(out)


def _plane_key(t: torch.Tensor):
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)


def _in_key(x):
    if torch.is_tensor(x):
        return (tuple(x.shape), x.dtype, x.device)
    return type(x)


class _Seen:
    """A key whose first (eager) call has run; the next call captures.
    It holds its cache planes weakly (a dead state's caches are freed and
    the key dies with them) and its generators strongly (a CUDA
    generator takes no weak reference; holding it keeps its id, which is
    in the key, from being reused)."""
    __slots__ = ("refs", "gens")

    def __init__(self, caches, gens):
        self.refs = [weakref.ref(c) for c in caches]
        self.gens = tuple(gens)

    def alive(self) -> bool:
        return all(r() is not None for r in self.refs)


class _Graph(_Seen):
    """A captured region: the graph, its static inputs and outputs, the
    launches of each counted wrapper it holds outside its if-node bodies,
    the indices of those bodies' counters and the trace stamps it holds
    (``stamps``: 0 where no trace was current at its capture)."""
    __slots__ = ("graph", "static_in", "static_out", "delta", "bodies",
                 "stamps")

    def __init__(self, seen, graph, static_in, static_out, delta,
                 bodies=(), stamps=0):
        self.refs, self.gens = seen.refs, seen.gens
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.delta = delta
        self.bodies = bodies
        self.stamps = stamps


class GraphSet:
    """The graphs of one engine (see the module docstring); ``graphs`` is
    the engine's option (``resolve``). ``mode`` is ``"graph"`` (a CUDA
    device), ``"eager"`` (every call runs the region directly) or
    ``"staged"`` (the CPU test stand-in, ``staged``).

    ``captures`` counts the graphs captured, ``capture_s`` the seconds
    their captures took (device synchronised at both edges, so that a
    caller can take them out of a decode time), ``pool_bytes`` the device
    memory the pool reserved while capturing, ``replays`` the replays and
    ``replays_by`` them by region name and first input's shape (as
    ``"prefill 1x512"``), ``readbacks`` the host read-backs the set made
    (``read``; an eager set's ``cond`` predicates) and ``bodies`` the
    if-node bodies captured."""

    def __init__(self, device, graphs: Optional[bool] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.mode = "graph" if resolve(graphs, self.device) else "eager"
        self._entries: dict = {}
        self._pool = None
        self._stream = None
        if self.mode == "graph":
            self._stream = torch.cuda.Stream(device)
        self.captures = 0
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.replays = 0
        self.replays_by = collections.Counter()
        self.readbacks = 0
        self._active = 0           # region calls in progress
        self._graph = None         # the CUDAGraph being captured
        self._bodies: list = []    # captured if-node bodies' launches
        self._free: list = []      # body counters no live graph uses
        self._captured: list = []  # the bodies of the capture under way
        self._body_counts = None   # their device counters [MAX_BODIES]
        self._pending = None       # staged: launches of the bodies run
        self._buffers: dict = {}
        self._depth = 0            # if-node bodies being captured
        self._body_streams = []    # a capture stream per nesting depth
        if self.mode == "graph":
            self._body_streams = [torch.cuda.Stream(device)
                                  for _ in range(MAX_DEPTH)]

    @property
    def enabled(self) -> bool:
        return self.mode != "eager"

    def stats(self) -> dict:
        return dict(captures=self.captures, capture_s=self.capture_s,
                    pool_bytes=self.pool_bytes, replays=self.replays,
                    replays_by=dict(self.replays_by),
                    readbacks=self.readbacks,
                    bodies=len(self._bodies) - len(self._free),
                    graphs=sum(isinstance(e, _Graph)
                               for e in self._entries.values()))

    def release(self) -> None:
        """Drop every graph (and with them the pool's blocks) and every
        kept buffer; launches of bodies not yet read are settled first."""
        if self._bodies:
            self.read(torch.zeros(0, dtype=torch.int64, device=self.device))
            self.readbacks -= 1
        self._entries.clear()
        self._buffers.clear()
        self._bodies.clear()
        self._free.clear()

    def buffers(self, name: str, caches, make, extra=()) -> dict:
        """Tensors a loop region keeps in place between its replays (its
        lengths, counters and token buffer): ``make()`` once per (name,
        cache planes, ``extra``); dropped with the planes, as a key's graph
        is. Pass them to ``run`` among its ``caches``."""
        key = (name, tuple(_plane_key(c) for c in caches), extra)
        ent = self._buffers.get(key)
        if ent is not None and all(r() is not None for r in ent[0]):
            return ent[1]
        for k in [k for k, (refs, _) in self._buffers.items()
                  if not all(r() is not None for r in refs)]:
            del self._buffers[k]
        bufs = make()
        self._buffers[key] = ([weakref.ref(c) for c in caches], bufs)
        return bufs

    def region(self, name: str):
        """A context manager that brackets device work with the current
        trace's stamps (``profiling.Trace.region``; inside a host span of
        the same name where the work runs now, not into a capture), or
        ``profiling.NULL`` with no trace current."""
        tr = profiling.current()
        if tr is None:
            return profiling.NULL
        return tr.region(name, self.device, self._graph is None)

    def read(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (int64) on the host: one read-back, which also brings the
        captured bodies' device counters and adds count x launches of each
        body to the wrappers' counters (then zeroes them)."""
        self.readbacks += 1
        n = len(self._bodies)
        if not n:
            return t.cpu()
        both = torch.cat([t.reshape(-1), self._body_counts[:n]]).cpu()
        for delta, k in zip(self._bodies, both[t.numel():].tolist()):
            if k and delta is not None:
                _add_counts(delta, k)
        self._body_counts[:n].zero_()
        return both[:t.numel()].reshape(t.shape)

    def cond(self, pred: torch.Tensor, body) -> None:
        """``body()`` where the 0-d bool device tensor ``pred`` holds (see
        the module docstring): an if-node under a capture, else a
        read-back of ``pred``. ``body`` takes no arguments and writes its
        results into tensors it closes over."""
        if self._graph is not None:
            self._if_node(pred, body)
            return
        hit = bool(pred)
        if self.mode != "staged":
            self.readbacks += 1
        if not hit:
            return
        if self.mode != "staged" or not self._active:
            body()
            return
        before = _counts()
        body()
        self._pending = _diff(_counts(), before) if self._pending is None \
            else [p + d for p, d in zip(self._pending,
                                        _diff(_counts(), before))]
        _set_counts(before)

    def _if_node(self, pred, body) -> None:
        """Capture ``body`` into an if-node of the graph being captured
        (``csrc/graph_cond.cu``): the node follows the work captured so
        far on the current stream; the body is captured on the set's stream
        of this nesting depth, its allocations routed to the bodies' pool
        (``_capture``, ``_body_pool``)."""
        if pred.dtype != torch.bool or pred.dim() != 0 \
                or pred.device != self.device:
            raise TypeError("a condition is a 0-d bool tensor on the set's "
                            "device")
        if not self._free and len(self._bodies) >= MAX_BODIES:
            raise RuntimeError(f"more than {MAX_BODIES} captured bodies; "
                               f"release the graphs")
        if self._depth >= len(self._body_streams):
            raise RuntimeError(f"conditional bodies nest deeper than "
                               f"{len(self._body_streams)}")
        lib = _build.lib(_COND_SOURCE)
        child = self._body_streams[self._depth]
        parent = torch.cuda.current_stream(self.device)
        _build.check(lib.tf_cond_begin(parent.cuda_stream, pred.data_ptr(),
                                       child.cuda_stream), "if-node")
        if self._free:
            idx = self._free.pop()
        else:
            idx = len(self._bodies)
            self._bodies.append(None)
        self._captured.append(idx)
        before = _counts()
        self._depth += 1
        try:
            with torch.cuda.stream(child):
                self._body_counts[idx:idx + 1].add_(1)
                body()
        finally:
            self._depth -= 1
            err = lib.tf_cond_end(child.cuda_stream)
        _build.check(err, "if-node body")
        # the body's own launches (its nested bodies took theirs back)
        self._bodies[idx] = _diff(_counts(), before)
        _set_counts(before)

    def run(self, name: str, fn, inputs, *, caches=(), gens=(), extra=(),
            capture_first: bool = False):
        """``fn(*inputs)`` through this set: eager on a set that is off;
        else the first call of the key eagerly, the second a capture and
        a replay, the rest replays. ``inputs`` are device tensors, ints or
        floats (an int reaches ``fn`` as a 0-d int64 tensor, a float as a
        0-d fp32 tensor); ``caches`` the buffers ``fn`` reads or writes
        beside its inputs (``planes``); ``gens`` the generators it draws
        from; ``extra`` hashable host values its Python branches on.
        ``fn`` returns a tuple of tensors; the caller gets copies.
        ``capture_first``: the key's first call captures (a loop region,
        module docstring). A call reached inside a running region runs
        ``fn`` inline."""
        if self.mode == "eager" or self._active:
            return self._call(fn, self._tensors(inputs))
        tr = profiling.current()
        if tr is not None:
            caches = caches + (tr.ring,)
        key = (name, tuple(_in_key(x) for x in inputs),
               tuple(_plane_key(c) for c in caches),
               tuple(id(g) for g in gens), extra)
        ent = self._entries.get(key)
        if ent is not None and not ent.alive():
            self._drop(key)
            ent = None
        if ent is None:
            self._prune()
            ent = _Seen(caches, gens)
            if not capture_first:
                self._entries[key] = ent
                out = self._first(fn, inputs)
                self._settle_pending()
                return out
        x = inputs[0] if inputs else None
        self.replays_by[name + (" " + "x".join(map(str, x.shape))
                                if torch.is_tensor(x) else "")] += 1
        if isinstance(ent, _Graph):
            return self._replay(ent, fn, inputs)
        ent = self._capture(key, ent, fn, inputs, gens)
        if self.mode == "staged":     # the stand-in's capture ran the region
            _add_counts(ent.delta)
            self._settle_pending()
            self.replays += 1
            return _copies(ent.static_out)
        return self._replay(ent, fn, inputs)

    def _call(self, fn, args):
        self._active += 1
        try:
            return fn(*args)
        finally:
            self._active -= 1

    def _settle_pending(self) -> None:
        if self._pending is not None:
            _add_counts(self._pending)
            self._pending = None

    def _prune(self) -> None:
        for k in [k for k, e in self._entries.items() if not e.alive()]:
            self._drop(k)

    def _drop(self, key) -> None:
        """Drop a dead key; its graph's body counters go back to the free
        list (read at its last generation, so zero but for launches no
        caller read)."""
        ent = self._entries.pop(key)
        for i in getattr(ent, "bodies", ()):
            self._bodies[i] = None
            self._body_counts[i:i + 1].zero_()
            self._free.append(i)

    def _tensors(self, inputs):
        out = []
        for x in inputs:
            if torch.is_tensor(x):
                out.append(x)
            else:
                dt = torch.int64 if isinstance(x, int) else torch.float32
                out.append(torch.full((), x, dtype=dt, device=self.device))
        return out

    def _first(self, fn, inputs):
        if self.mode == "staged":
            return self._call(fn, self._tensors(inputs))
        # on the capture stream, so that everything the capture will touch
        # (cuBLAS's workspace for the stream among it) exists before it
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out = self._call(fn, self._tensors(inputs))
        cur.wait_stream(self._stream)
        return out

    def _capture(self, key, seen, fn, inputs, gens):
        static_in = [x.clone() if torch.is_tensor(x) else x
                     for x in self._tensors(inputs)]
        before = _counts()
        stamps = _stamps_issued()
        if self.mode == "staged":
            out = self._call(fn, static_in)
            delta = [a - b for a, b in zip(_counts(), before)]
            _set_counts(before)
            ent = _Graph(seen, None, static_in, _outputs(out), delta,
                         stamps=_stamps_issued() - stamps)
            self._entries[key] = ent
            self.captures += 1
            return ent
        graph = torch.cuda.CUDAGraph()
        for g in gens:
            graph.register_generator_state(g)
        if not any(isinstance(e, _Graph) for e in self._entries.values()):
            self._pool = None     # no graph holds the pool: start a new one
        if self._body_counts is None:
            self._body_counts = torch.zeros(MAX_BODIES, dtype=torch.int64,
                                            device=self.device)
            _body_pool(self.device)
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        reserved = torch.cuda.memory_reserved(self.device)
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        self._captured = []
        with torch.cuda.stream(self._stream):
            # the first graph makes the pool, the others share it (a pool
            # id is valid while a graph of it lives)
            graph.capture_begin(self._pool)
            self._graph = graph
            dev = self.device.index
            pool_on = False
            try:
                # what the if-node bodies allocate on their own streams
                # goes to the body pool (the capture's own pool takes this
                # stream's)
                torch._C._cuda_beginAllocateCurrentThreadToPool(
                    dev, _body_pool(self.device).id)
                pool_on = True
                out = self._call(fn, static_in)
            except BaseException:
                self._graph = None
                for i in self._captured:
                    self._bodies[i] = None
                    self._free.append(i)
                if pool_on:
                    self._end_body_pool(dev)
                try:
                    graph.capture_end()
                except Exception:      # the capture is already invalid
                    pass
                _set_counts(before)
                raise
            self._graph = None
            self._end_body_pool(dev)
            graph.capture_end()
        cur.wait_stream(self._stream)
        torch.cuda.synchronize(self.device)
        self._pool = graph.pool()
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        self.capture_s += time.perf_counter() - t0
        delta = [a - b for a, b in zip(_counts(), before)]
        _set_counts(before)
        ent = _Graph(seen, graph, static_in, _outputs(out), delta,
                     tuple(self._captured), _stamps_issued() - stamps)
        self._entries[key] = ent
        self.captures += 1
        return ent

    def _end_body_pool(self, dev) -> None:
        pool = _body_pool(self.device)
        torch._C._cuda_endAllocateToPool(dev, pool.id)
        torch._C._cuda_releasePool(dev, pool.id)

    def _replay(self, ent, fn, inputs):
        for st, x in zip(ent.static_in, inputs):
            if torch.is_tensor(x):
                st.copy_(x)
            else:
                st.fill_(x)
        if self.mode == "staged":
            before = _counts()
            out = _outputs(self._call(fn, ent.static_in))
            _set_counts(before)
            for st, o in zip(ent.static_out, out):
                if st is not None:
                    st.copy_(o)
        else:
            ent.graph.replay()
        _add_counts(ent.delta)
        self._settle_pending()
        self.replays += 1
        return _copies(ent.static_out)


def _outputs(out) -> tuple:
    if not isinstance(out, tuple):
        raise TypeError("a graphed region returns a tuple of tensors")
    return out


def _copies(static_out) -> tuple:
    return tuple(None if o is None else o.clone() for o in static_out)


def staged(device) -> GraphSet:
    """The CPU test stand-in for a graph set (module docstring); raises on
    a CUDA device."""
    if torch.device(device).type == "cuda":
        raise ValueError("the staged set is the CPU stand-in; a CUDA device "
                         "captures real graphs")
    out = GraphSet(device, False)
    out.mode = "staged"
    return out
