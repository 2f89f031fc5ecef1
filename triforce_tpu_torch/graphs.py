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

``staged(device)`` is a test-only set for the CPU: the same keys, staging
and counter bookkeeping, with the capture replaced by a direct call of the
region through the static buffers, so that an output that aliases a static
buffer, or a key that misses a state change, shows on the CPU too. It
refuses a CUDA device.
"""

from __future__ import annotations

import collections
import time
import weakref
from typing import Optional

import torch

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


def _add_counts(delta) -> None:
    for fn, d in zip(COUNTED, delta):
        fn.launches += d


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
    """A captured region: the graph, its static inputs and outputs, and
    the launches of each counted wrapper it holds."""
    __slots__ = ("graph", "static_in", "static_out", "delta")

    def __init__(self, seen, graph, static_in, static_out, delta):
        self.refs, self.gens = seen.refs, seen.gens
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.delta = delta


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
    ``"prefill 1x512"``)."""

    def __init__(self, device, graphs: Optional[bool] = None):
        self.device = torch.device(device)
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

    @property
    def enabled(self) -> bool:
        return self.mode != "eager"

    def stats(self) -> dict:
        return dict(captures=self.captures, capture_s=self.capture_s,
                    pool_bytes=self.pool_bytes, replays=self.replays,
                    replays_by=dict(self.replays_by),
                    graphs=sum(isinstance(e, _Graph)
                               for e in self._entries.values()))

    def release(self) -> None:
        """Drop every graph (and with them the pool's blocks)."""
        self._entries.clear()

    # ------------------------------------------------------------------

    def run(self, name: str, fn, inputs, *, caches=(), gens=(), extra=()):
        """``fn(*inputs)`` through this set: eager on a set that is off;
        else the first call of the key eagerly, the second a capture and
        a replay, the rest replays. ``inputs`` are device tensors, ints or
        floats (an int reaches ``fn`` as a 0-d int64 tensor, a float as a
        0-d fp32 tensor); ``caches`` the buffers ``fn`` reads or writes
        beside its inputs (``planes``); ``gens`` the generators it draws
        from; ``extra`` hashable host values its Python branches on.
        ``fn`` returns a tuple of tensors; the caller gets copies."""
        if self.mode == "eager":
            return fn(*self._tensors(inputs))
        key = (name, tuple(_in_key(x) for x in inputs),
               tuple(_plane_key(c) for c in caches),
               tuple(id(g) for g in gens), extra)
        ent = self._entries.get(key)
        if ent is not None and not ent.alive():
            del self._entries[key]
            ent = None
        if ent is None:
            self._prune()
            self._entries[key] = _Seen(caches, gens)
            return self._first(fn, inputs)
        x = inputs[0] if inputs else None
        self.replays_by[name + (" " + "x".join(map(str, x.shape))
                                if torch.is_tensor(x) else "")] += 1
        if isinstance(ent, _Graph):
            return self._replay(ent, fn, inputs)
        ent = self._capture(key, ent, fn, inputs, gens)
        if self.mode == "staged":     # the stand-in's capture ran the region
            _add_counts(ent.delta)
            self.replays += 1
            return _copies(ent.static_out)
        return self._replay(ent, fn, inputs)

    def _prune(self) -> None:
        for k in [k for k, e in self._entries.items() if not e.alive()]:
            del self._entries[k]

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
            return fn(*self._tensors(inputs))
        # on the capture stream, so that everything the capture will touch
        # (cuBLAS's workspace for the stream among it) exists before it
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out = fn(*self._tensors(inputs))
        cur.wait_stream(self._stream)
        return out

    def _capture(self, key, seen, fn, inputs, gens):
        static_in = [x.clone() if torch.is_tensor(x) else x
                     for x in self._tensors(inputs)]
        before = _counts()
        if self.mode == "staged":
            out = fn(*static_in)
            delta = [a - b for a, b in zip(_counts(), before)]
            _set_counts(before)
            ent = _Graph(seen, None, static_in, _outputs(out), delta)
            self._entries[key] = ent
            self.captures += 1
            return ent
        graph = torch.cuda.CUDAGraph()
        for g in gens:
            graph.register_generator_state(g)
        if not any(isinstance(e, _Graph) for e in self._entries.values()):
            self._pool = None     # no graph holds the pool: start a new one
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        reserved = torch.cuda.memory_reserved(self.device)
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            # the first graph makes the pool, the others share it (a pool
            # id is valid while a graph of it lives)
            graph.capture_begin(self._pool)
            try:
                out = fn(*static_in)
            except BaseException:
                try:
                    graph.capture_end()
                except Exception:      # the capture is already invalid
                    pass
                _set_counts(before)
                raise
            graph.capture_end()
        cur.wait_stream(self._stream)
        torch.cuda.synchronize(self.device)
        self._pool = graph.pool()
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        self.capture_s += time.perf_counter() - t0
        delta = [a - b for a, b in zip(_counts(), before)]
        _set_counts(before)
        ent = _Graph(seen, graph, static_in, _outputs(out), delta)
        self._entries[key] = ent
        self.captures += 1
        return ent

    def _replay(self, ent, fn, inputs):
        for st, x in zip(ent.static_in, inputs):
            if torch.is_tensor(x):
                st.copy_(x)
            else:
                st.fill_(x)
        if self.mode == "staged":
            before = _counts()
            out = _outputs(fn(*ent.static_in))
            _set_counts(before)
            for st, o in zip(ent.static_out, out):
                if st is not None:
                    st.copy_(o)
        else:
            ent.graph.replay()
        _add_counts(ent.delta)
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
    out = GraphSet(device, False)
    if out.device.type == "cuda":
        raise ValueError("the staged set is the CPU stand-in; a CUDA device "
                         "captures real graphs")
    out.mode = "staged"
    return out
