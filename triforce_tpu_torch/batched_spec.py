"""Batched speculative decoding: B sequences speculate together, each with
its own acceptance count, rollback and retrieval tail refresh — the port
of ``triforce_tpu/batched_spec.py``.

The JAX package vmaps its batch-1 step over a stacked state. Here the step
has a real batch dimension (``engine.triforce_step_rows`` /
``retrieval_spec_step_rows``): every forward of a step runs ONCE for all
rows, so the weights are read once per forward whatever B is, and every
target layer attends through one launch of the row-batched flash-decode
kernel. Each row keeps its own cache row, its own generator and its own
control flow, and emits exactly what its batch-1 run with the same seed
emits.

``SpecScheduler`` serves requests through a fixed pool of such rows: chunked
admission interleaved with decode segments, retirement on EOS or length,
dead slots gated by ``kv.seq_len == 0`` (their attention reads no cache).
The control loop is ``batching.SchedulerBase``, shared with the AR
scheduler.

``BatchedSpecEngine.decode`` is the JAX package's ``_decode_fused``:
``steps`` calls of one loop region (``engine.decode_rows``) on the batch-1
engine's graph set (``graphs.py``), captured at its first call as one CUDA
graph on a card (the lockstep middle trips and their drafter forwards are
if-nodes) and replayed, and ONE host read-back at the end of the call. A
``SpecScheduler`` decode segment is one such call. Admission writes a slot
in place (``write_row``), copies the row's generator state into the
slot's generator and replaces the length vectors, so the loop graph
captured on the pool replays for every request: its key holds the pool's
caches and generators, which live as long as the pool.

Over a mesh (``BatchedSpecEngine(mesh=)``, ``SpecScheduler(mesh=)``) the
rows split in contiguous blocks over the mesh's ``dp`` axis
(``sharding.row_block``, JAX's ``P("dp")``): each rank prefills and holds
its own rows, and a ``decode`` call gathers every row's tokens and counts
over ``dp`` once, after its loop, before its one read-back
(``engine.decode_rows``), so every rank returns the global [B, ...]
result. Two shapes, as in the JAX package (``batched_spec.py:114-160``):
dp alone, a dp mesh beside a meshless engine (the rows' steps then issue no
collective), and the composed dp x tp x sp mesh, which the engine carries
(each dp index's (tp, sp) group runs its rows' forwards over its heads and
slots).
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch

from . import batching, profiling
from .cache import (KVCache, RetrievalCache, StreamingCache, init_kv_rows,
                    init_retrieval_rows, init_streaming_rows, row_view,
                    set_entry, stack_rows, write_row)
from .engine import (_COUNTS, BatchedStepStats, Engine, StackedState,
                     TriForceState, decode_rows)
from .parallel import sharding
from .parallel.mesh import Mesh

# the columns of a batched step's counts (``engine._counts_of``)
_COLS = ("n_emitted",) + _COUNTS + ("eos",)
# ``decode``'s counters: per row (accepted, proposed, mid_verify, mid_live)
_COUNTERS = [_COLS.index(k) for k in ("accepted", "gamma2", "mid_verify",
                                      "mid_live")]
# the middle level's counts a SpecScheduler sums over its live rows
_MID = ("mid_verify", "mid_live", "mid_draft")


def stack_states(states) -> StackedState:
    """Stack B batch-1 ``TriForceState``s into one row-stacked state (a
    copy; the generators are shared with the inputs). Holds the inputs and
    the copy at once: pools are built with ``blank_stacked_state`` and
    filled row by row instead."""
    return StackedState(
        kv=stack_rows([s.kv for s in states]),
        rkv=stack_rows([s.rkv for s in states]),
        dkv=None if states[0].dkv is None
        else stack_rows([s.dkv for s in states]),
        next_token=torch.cat([s.next_token for s in states]),
        gens=[s.gen for s in states])


def blank_stacked_state(engine: Engine, b: int, seeds) -> StackedState:
    """A row-stacked BLANK pool built directly at stacked shapes, with one
    seeded generator per row: peak memory is the pool alone. Blank rows
    have ``seq_len`` 0, i.e. they are gated until ``write_state_row`` fills
    them. Over the engine's mesh the caches have this rank's shapes
    (``Engine.local_target``)."""
    dev = engine.device
    cfg, slots = engine.local_target()
    dkv = None
    if engine.draft_cfg is not None:
        dkv = init_streaming_rows(engine.draft_cfg, engine.spec, b,
                                  engine.dtype, device=dev)
    return StackedState(
        kv=init_kv_rows(cfg, slots, b, engine.dtype, device=dev,
                        quant=engine.kv_quant),
        rkv=init_retrieval_rows(cfg, engine.spec, b, engine.dtype,
                                device=dev, quant=engine.kv_quant),
        dkv=dkv,
        next_token=torch.zeros((b,), dtype=torch.int64, device=dev),
        gens=[torch.Generator(device=dev).manual_seed(s) for s in seeds])


def write_state_row(full: StackedState, row: TriForceState,
                    slot: int) -> StackedState:
    """Overwrite row ``slot`` of the pool with a batch-1 state, in place on
    the pool's buffers (one row's bytes; the pool is never copied). The
    slot's generator takes the row's generator state and stays the pool's
    object (a loop graph captured on the pool has registered it); the
    length vectors and the next tokens are replaced, not mutated."""
    full.gens[slot].set_state(row.gen.get_state())
    return StackedState(
        kv=write_row(full.kv, slot, row.kv),
        rkv=write_row(full.rkv, slot, row.rkv),
        dkv=None if full.dkv is None else write_row(full.dkv, slot, row.dkv),
        next_token=set_entry(full.next_token, slot, row.next_token[0]),
        gens=full.gens)


def unstack_state(batched: StackedState):
    """The pool's rows as batch-1 states that share its buffers."""
    return [TriForceState(
        kv=row_view(batched.kv, i), rkv=row_view(batched.rkv, i),
        dkv=None if batched.dkv is None else row_view(batched.dkv, i),
        next_token=batched.next_token[i:i + 1].clone(),
        gen=batched.gens[i])
        for i in range(batched.rows)]


def stacked_state_from_numpy(state, seeds, device,
                             dtype=torch.float32) -> StackedState:
    """The JAX package's row-stacked ``TriForceState`` as numpy arrays
    (``jax.tree.map(np.asarray, state)``: caches ``[B, L, 1, Hkv, S, D]``,
    scales ``[B, L, 1, Hkv, S]``, ``seq_len`` [B], ``next_token`` [B, 1])
    -> this package's row-stacked state on ``device``, one generator per
    row from ``seeds``. A state without a drafter cache (the JAX
    placeholder of size 0) gets ``dkv=None``."""
    def buf(a):
        a = np.asarray(a)
        if a.dtype == np.int8:
            return torch.tensor(a[:, :, 0]).to(device)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        return torch.tensor(a[:, :, 0]).to(device=device, dtype=dtype)

    def scale(a):
        return None if a is None else torch.tensor(
            np.asarray(a)[:, :, 0]).to(device=device, dtype=torch.float32)

    def length(a):
        return torch.tensor(np.asarray(a)).to(device=device,
                                              dtype=torch.int32)

    kv, rkv, dkv = state.kv, state.rkv, state.dkv
    return StackedState(
        kv=KVCache(buf(kv.k), buf(kv.v), length(kv.seq_len),
                   scale(kv.k_scale), scale(kv.v_scale)),
        rkv=RetrievalCache(buf(rkv.k), buf(rkv.v), scale(rkv.k_scale),
                           scale(rkv.v_scale)),
        dkv=None if np.asarray(dkv.k).ndim < 6
        else StreamingCache(buf(dkv.k), buf(dkv.v), length(dkv.seq_len)),
        next_token=torch.tensor(np.asarray(state.next_token)[:, 0]).to(
            device=device, dtype=torch.int64),
        gens=[torch.Generator(device=device).manual_seed(s) for s in seeds])


class BatchedSpecEngine:
    """Batched speculation steps over a row-stacked state.

    Built ON an existing batch-1 ``Engine`` (same configs, same params).
    ``mode`` is 'retrieval' (self-speculation) or 'triforce' (3-level with
    drafter). ``force_accept``: the controlled-acceptance coin of
    ``Engine.generate_forced``, applied per row.

    ``mesh``: a dp-only ``parallel.mesh.Mesh`` over whose ``dp`` axis the
    rows split, beside a meshless engine; an engine over a mesh brings its
    own (the composed dp x tp x sp case) and takes no second one. Every
    rank of the mesh makes the same calls."""

    def __init__(self, engine: Engine, mode: str = "retrieval",
                 force_accept=None, mesh=None):
        if engine.mesh is not None:
            if mesh is not None:
                raise ValueError("the engine's mesh already carries (dp, "
                                 "tp, sp); pass no second mesh")
            mesh = engine.mesh
        elif mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                                f"{type(mesh).__name__}")
            if mesh.shape["tp"] * mesh.shape["sp"] != 1:
                raise ValueError("beside a meshless engine the rows take a "
                                 "dp-only mesh; build the engine over a "
                                 "tp / sp mesh instead")
            if mesh.device != engine.device:
                raise ValueError(f"the mesh is on {mesh.device}, the engine "
                                 f"on {engine.device}")
        if mode not in ("triforce", "retrieval"):
            raise ValueError(mode)
        if mode == "triforce" and engine.draft_cfg is None:
            raise ValueError("triforce mode needs a drafter")
        self.engine = engine
        self.mode = mode
        self.force_accept = force_accept
        self.mesh = mesh
        self.steps = 0             # batched steps run so far
        self.target_forwards = 0   # batched target forwards they ran (the
        #                            device's count, read back per call;
        #                            this rank's over a mesh)

    def rows(self, n: int) -> range:
        """The rows of an ``n``-row batch this rank holds
        (``sharding.row_block``; all of them without a mesh)."""
        return sharding.row_block(self.mesh, n)

    def prefill_rows(self, prompts, seeds) -> StackedState:
        """Prefill each row through the batch-1 engine and write it into a
        blank stacked pool (prefill is compute-bound: batching it buys
        little; decode is where rows share the weights). Writing row by
        row keeps the peak at the pool plus ONE row. Over a mesh the rows
        must divide over ``dp`` (``batched_spec.py:241-242``), and each
        rank prefills and holds only its own block of them."""
        eng = self.engine
        mine = self.rows(len(prompts))
        state = blank_stacked_state(eng, len(mine),
                                    [seeds[i] for i in mine])
        for j, i in enumerate(mine):
            st = eng.init_state(seeds[i])
            st = eng.prefill_target(st, prompts[i])
            if self.mode == "triforce":
                st = eng.prefill_draft(st, prompts[i])
            state = write_state_row(state, st, j)
            del st
        return state

    def _decode(self, state: StackedState, steps: int):
        state, toks, counts, forwards = decode_rows(
            self.engine, state, self.mode, steps, self.force_accept,
            self.mesh)
        self.steps += steps
        self.target_forwards += forwards
        return state, toks, counts, forwards

    def step(self, state: StackedState):
        """One speculation step for EVERY row (a ``decode`` call of one
        step: one read-back). Returns (state, ``BatchedStepStats``; over a
        mesh, every row's). The caches of ``state`` are updated in
        place."""
        state, toks, counts, forwards = self._decode(state, 1)
        c = dict(zip(_COLS, counts[:, 0].unbind(-1)))
        eos = c.pop("eos") != 0
        return state, BatchedStepStats(tokens=toks[:, 0], eos=eos,
                                       target_forwards=forwards, **c)

    def decode(self, state: StackedState, steps: int):
        """Run ``steps`` steps as the JAX package's ``_decode_fused``:
        ``steps`` replays of one loop graph on a card and ONE host
        read-back (``engine.decode_rows``). Returns (state, tokens [B,
        steps, gamma+2], n_emitted [B, steps], counters [B, 4] = per-row
        (accepted, proposed, mid_verify, mid_live), eos [B, steps]), the
        last four as numpy arrays over every row of the batch (over a
        mesh, gathered over ``dp``; ``state`` stays this rank's rows)."""
        state, toks, counts, _ = self._decode(state, steps)
        counts = counts.numpy()
        return (state, toks.numpy(), counts[..., 0],
                counts[..., _COUNTERS].sum(1), counts[..., -1] != 0)


class SpecScheduler(batching.SchedulerBase):
    """Speculative continuous batching: requests flow through a fixed pool
    of B speculative slots — admit (CHUNKED batch-1 prefill interleaved
    with decode segments, then a row write into the stacked state) ->
    decode segments of batched speculation steps -> retire on EOS /
    length.

    Per-row trajectories are the batch-1 runs with the same seeds (a
    request's seed is its ``rid``): admission replays the engine's own
    prefill, and rows never interact.

    Dead slots are GATED: a retired or never-filled slot has
    ``kv.seq_len == 0``, which the forwards use as the live flag — the
    flash-decode kernel reads no cache for it and ``forward_spec_rows``
    collapses its retrieval read to zero columns. Dead rows still run the
    small matmul compute, sharing the batch's weight stream. Admission
    overwrites the slot wholesale.

    Admission is CHUNKED: each scheduler cycle advances the pending prefill
    by ``admit_chunks`` prefill chunks, then a decode segment runs, so live
    slots keep decoding while a long prompt streams in. Every request is
    prefilled into one reused batch-1 row (``_reset_row``), so the
    prefill's graphs, the retrieval build's among them, replay from the
    second request on. A decode segment is one ``BatchedSpecEngine.decode``
    call: one loop graph per pool, captured at the first segment and
    replayed after every admission, and one read-back a segment.

    ``mesh`` (a dp-only mesh beside a meshless engine; an engine over a
    dp x tp x sp mesh brings its own): the slots split over ``dp`` in
    contiguous blocks (``batched_spec.py:345-355``). Every rank runs the
    same loop and takes the same decisions: a request's admission slices
    follow from its length (``Engine.prefill_slice``), so only the ranks
    holding its slot prefill it, and one collective over ``dp`` gives
    every rank its first token when the admission completes; retirement
    reads the segment's tokens, gathered over ``dp`` by the decode call,
    so every rank (rank 0 among them) holds every request's output."""

    @staticmethod
    def required_headroom(gen_len: int, segment: int, gamma: int) -> int:
        """Cache capacity (beyond prefill) a LIVE slot can consume: it
        emits >= 1 token per step (<= gen_len + segment-overshoot steps to
        retirement), each step appending <= gamma+2 entries; retirement
        clears the row (seq_len -> 0)."""
        return (gen_len + 2 * segment + 2) * (gamma + 2)

    def __init__(self, engine: Engine, mode: str = "retrieval", *,
                 slots: int = 4, segment: int = 4, seed: int = 0,
                 force_accept=None, mesh=None, bat=None,
                 admit_chunks: int = 8):
        super().__init__(slots, engine.eos_token_id, engine.device,
                         engine.graphs)
        self.engine = engine
        self.mode = mode
        self.segment = segment
        self.admit_chunks = admit_chunks
        if bat is not None:
            if bat.engine is not engine or bat.mode != mode:
                raise ValueError("a shared BatchedSpecEngine must wrap the "
                                 "same engine and mode")
            self.bat = bat
        else:
            self.bat = BatchedSpecEngine(engine, mode=mode,
                                         force_accept=force_accept,
                                         mesh=mesh)
        # this rank's blank rows (seq_len 0 -> gated until admission)
        self._mine = self.bat.rows(slots)
        self.state = blank_stacked_state(
            engine, len(self._mine), [seed * 1000 + i for i in self._mine])
        self._pending = None   # in-flight chunked admission
        # the batch-1 row every request is prefilled into: one set of cache
        # planes, so the prefill's graphs (chunks, build, drafter chunks)
        # are captured once and replay for every later request
        self._row = engine.init_state(0)

    @staticmethod
    def _blank_stats() -> dict:
        """``SchedulerBase``'s, and the middle level's counts summed over
        the live rows of every decode segment: ``mid_verify`` (middle
        verifies a row took part in), ``mid_live`` (those that read its
        retrieval cache) and ``mid_draft`` (drafter proposals)."""
        return dict(batching.SchedulerBase._blank_stats(),
                    **dict.fromkeys(_MID, 0))

    def _admitting(self) -> bool:
        return self._pending is not None

    def _local(self, slot: int):
        """``slot``'s row in this rank's pool, or None where another rank
        holds it."""
        return slot - self._mine.start if slot in self._mine else None

    def _admit_one(self, slot: int, req) -> bool:
        eng = self.engine
        local = self._local(slot)
        if self._pending is None or self._pending["req"] is not req:
            ids = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int64,
                                  device=eng.device)
            if ids.dim() == 1:
                ids = ids[None]
            self._pending = {"req": req, "ids": ids, "pos": 0,
                             "row": None if local is None
                             else self._reset_row(req.rid)}
        p = self._pending
        pos = p["pos"]
        if local is None:        # another rank's slot: follow its slices
            stop = eng.prefill_slice(p["pos"], self.admit_chunks)
            done = stop >= eng.prefill - 1
            p["pos"] = eng.prefill if done else stop
        else:
            row, p["pos"], done = eng.prefill_target_partial(
                p["row"], p["ids"], p["pos"], self.admit_chunks)
            p["row"] = row
        profiling.note("tokens", (pos, p["pos"]))
        if not done:
            return False
        self.stats["prefill_tokens"] += int(p["ids"].shape[-1])
        first = torch.zeros((1,), dtype=torch.int64, device=eng.device)
        if local is not None:
            if self.mode == "triforce":
                row = eng.prefill_draft(row, p["ids"])
            with self.graphs.region("row_write"):
                self.state = write_state_row(self.state, row, local)
            first = row.next_token[:1].clone()
        if self.bat.mesh is not None:   # the holder's sample, on every rank
            self.bat.mesh.all_reduce(first, "dp")
        req.out = [int(first[0])]       # the prefill sample
        self._pending = None
        return True

    def _reset_row(self, rid: int) -> TriForceState:
        """The admission row, reset for request ``rid``: zero lengths and
        its generator seeded with ``rid`` (the slot takes its state).
        The engine fixes the prompt's length, so every request's prefill
        writes the same slots of each cache (the retrieval budget whole)
        and the row then holds what a fresh state would: nothing of the
        request before survives."""
        row = self._row
        dkv = row.dkv
        if dkv is not None:
            dkv = dataclasses.replace(dkv, seq_len=torch.zeros_like(
                dkv.seq_len))
        return TriForceState(
            kv=dataclasses.replace(row.kv, seq_len=torch.zeros_like(
                row.kv.seq_len)),
            rkv=row.rkv, dkv=dkv, next_token=torch.zeros_like(
                row.next_token),
            gen=row.gen.manual_seed(rid))

    def _decode_segment(self):
        before = self.bat.target_forwards
        self.state, toks, counts, _ = self.bat._decode(self.state,
                                                       self.segment)
        toks, counts = toks.numpy(), counts.numpy()
        ns = counts[..., 0]
        self.stats["steps"] += self.segment
        self.stats["target_forwards"] += self.bat.target_forwards - before
        live = [s for s, r in enumerate(self.slot_req) if r is not None]
        for name in _MID:
            n = int(counts[live][..., _COLS.index(name)].sum())
            self.stats[name] += n
            profiling.count(name, n)
        new_tokens = []
        for slot, req in enumerate(self.slot_req):
            if req is None:
                new_tokens.append([])
                continue
            new_tokens.append([int(t) for s in range(self.segment)
                               for t in toks[slot, s, :ns[slot, s]]])
        return new_tokens, [False] * self.slots

    def _release_slot(self, slot: int) -> None:
        """Gate a retired slot: zero its kv/dkv lengths; the stale cache
        contents are unreachable behind the zero length."""
        slot = self._local(slot)
        if slot is None:
            return
        st = self.state
        kv = dataclasses.replace(st.kv,
                                 seq_len=set_entry(st.kv.seq_len, slot, 0))
        dkv = st.dkv
        if dkv is not None:
            dkv = dataclasses.replace(
                dkv, seq_len=set_entry(dkv.seq_len, slot, 0))
        self.state = dataclasses.replace(st, kv=kv, dkv=dkv)
