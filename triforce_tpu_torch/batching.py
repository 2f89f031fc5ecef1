"""Continuous batching: slot-based batched autoregressive decode with
per-row sequence lengths and rolling admission — the port of
``triforce_tpu/batching.py``.

  * a fixed pool of B slots shares one ``[B, L, H, S, D]`` cache (no
    reallocation on admission);
  * ``seq_lens`` is a [B] vector; attention bounds each row by its own
    length, so rows at different positions decode together, each layer
    through ONE launch of the row-batched flash-decode kernel
    (``ops/attention.py::append_attention_rows``);
  * prefill fills ONE slot at a time, in chunks, straight into that row of
    the pool; decode steps advance ALL live rows in one pass over the
    weights;
  * the ``Scheduler`` admits queued requests into free slots between
    decode segments and retires rows on EOS / length.

``SchedulerBase`` is the control loop shared with the speculative
scheduler (``batched_spec.SpecScheduler``). Where the JAX package runs a
decode segment as one compiled program (``_seg``), the port runs it as a
host loop over ``batched_ar_step`` with one read-back of the output buffer
per segment (``GraphSet.read``, counted in ``stats["readbacks"]``); on a
CUDA device each step (forward, commit, sample, output append: no host
decision) is the replay of one captured CUDA graph (``graphs.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from . import graphs as graphs_mod
from . import profiling
from .cache import KVCache, init_kv_rows, row_view, set_entry
from .config import ModelConfig, SpecConfig, resolve_device
from .engine import _as_eos_tuple, append_graphed, prefill_chunks
from .models import llama
from .ops import sampling


@dataclasses.dataclass
class BatchState:
    """Slot pool state: one shared cache, per-row lengths and tokens. The
    cache buffers are updated in place; the small vectors are replaced."""
    kv: KVCache               # row-stacked: k/v [B, L, H, S, D], seq_len [B]
    tokens: torch.Tensor      # [B] int64 — last sampled token per row
    live: torch.Tensor        # [B] bool — row actively decoding
    out_buf: torch.Tensor     # [B, cap] int64 — generated tokens per row
    n_out: torch.Tensor       # [B] int64 — fill level of out_buf
    gen: torch.Generator      # one random stream for the pool

    @property
    def seq_lens(self) -> torch.Tensor:
        return self.kv.seq_len


def init_batch(cfg: ModelConfig, batch: int, max_len: int, seed: int = 0,
               dtype=torch.bfloat16, out_cap: int = 1024,
               device=None) -> BatchState:
    """A blank pool of ``batch`` slots. ``device=None`` means the first
    CUDA card and raises without one."""
    device = resolve_device(device)
    return BatchState(
        kv=init_kv_rows(cfg, max_len, batch, dtype, device=device),
        tokens=torch.zeros((batch,), dtype=torch.int64, device=device),
        live=torch.zeros((batch,), dtype=torch.bool, device=device),
        out_buf=torch.zeros((batch, out_cap), dtype=torch.int64,
                            device=device),
        n_out=torch.zeros((batch,), dtype=torch.int64, device=device),
        gen=torch.Generator(device=device).manual_seed(seed))


def batched_ar_step(cfg: ModelConfig, spec: SpecConfig, params,
                    state: BatchState,
                    graphs: Optional[graphs_mod.GraphSet] = None
                    ) -> BatchState:
    """One decode token for every live row, in one pass over the weights.

    Each row attends its own live prefix and writes its new KV at its own
    ``seq_lens[b]``; dead rows are masked out of the length advance, so
    their caches stay frozen (the slot they overwrite is past their
    length). With ``graphs`` the step runs through that set (one graph
    region on a CUDA device)."""
    if graphs is None:
        return _ar_rows(cfg, spec, params, state)

    def region(tokens, live, out_buf, n_out, seq_len):
        st = _ar_rows(cfg, spec, params, dataclasses.replace(
            state, kv=dataclasses.replace(state.kv, seq_len=seq_len),
            tokens=tokens, live=live, out_buf=out_buf, n_out=n_out))
        return st.tokens, st.out_buf, st.n_out, st.kv.seq_len

    tokens, out_buf, n_out, seq_len = graphs.run(
        "ar_rows", region, (state.tokens, state.live, state.out_buf,
                            state.n_out, state.kv.seq_len),
        caches=graphs_mod.planes(state.kv), gens=(state.gen,))
    return dataclasses.replace(
        state, kv=dataclasses.replace(state.kv, seq_len=seq_len),
        tokens=tokens, out_buf=out_buf, n_out=n_out)


def _ar_rows(cfg: ModelConfig, spec: SpecConfig, params,
             state: BatchState) -> BatchState:
    kv = state.kv
    positions = kv.seq_len
    logits, nk, nv = llama.forward_append_rows(cfg, params,
                                               state.tokens[:, None], kv)
    # per-row commit of the one new token at each row's own position
    rows = torch.arange(positions.shape[0], device=positions.device)
    at = positions.to(torch.int64).clamp(0, kv.max_len - 1)
    kv.k[rows, :, :, at] = nk[:, :, :, 0].to(kv.k.dtype)
    kv.v[rows, :, :, at] = nv[:, :, :, 0].to(kv.v.dtype)

    probs = sampling.norm_logits(logits[:, -1], spec.temperature, spec.top_k,
                                 spec.top_p)
    toks = torch.where(state.live, sampling.sample(probs, state.gen),
                       state.tokens)
    # append to each live row's output buffer; a row at buffer capacity
    # stops recording AND stops counting (the scheduler retires it)
    cap = state.out_buf.shape[1]
    can_write = state.live & (state.n_out < cap)
    idx = state.n_out.clamp(0, cap - 1)
    out_buf = state.out_buf.clone()
    out_buf[rows, idx] = torch.where(can_write, toks, out_buf[rows, idx])
    return dataclasses.replace(
        state,
        kv=dataclasses.replace(
            kv, seq_len=positions + state.live.to(positions.dtype)),
        tokens=toks, out_buf=out_buf,
        n_out=state.n_out + can_write.to(state.n_out.dtype))


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [T] int
    max_new_tokens: int = 128
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class SchedulerBase:
    """ONE continuous-batching control loop for both step kinds.
    Subclasses provide three hooks:

      _admit_one(slot, req) -> bool
          admit (or CONTINUE admitting — chunked admission may span calls)
          ``req`` into ``slot``; return True once the slot is live. A False
          return stops this cycle's admission sweep so a decode segment
          can interleave with a long prefill.
      _decode_segment() -> (new_tokens, force_retire)
          one decode segment for every slot; per-slot lists of the NEW
          tokens it produced, plus a per-slot bool forcing retirement
          (e.g. output-buffer capacity).
      _release_slot(slot)
          gate a retired slot (stop paying for its decode work).

    Retirement is shared: trim at the first EOS (inclusive; EOS is a
    static id tuple like the engines'), trim to ``max_new_tokens``, retire
    on EOS / length / force.

    Over a mesh whose ``dp`` axis splits the slots
    (``batched_spec.SpecScheduler(mesh=)``) every rank runs this loop:
    admission depends only on the queue and the free slots, and
    ``_decode_segment`` returns every slot's tokens, gathered over ``dp``
    by the decode call, so every rank takes the same decisions and holds
    every request's output."""

    def __init__(self, slots: int, eos_token_id, device: torch.device,
                 graphs: graphs_mod.GraphSet):
        self.graphs = graphs      # the set the decode segments replay from
        self.slots = slots
        self.device = device
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.queue: List[Request] = []
        self._eos_ids = _as_eos_tuple(eos_token_id)
        self.stats = self._blank_stats()

    @staticmethod
    def _blank_stats() -> dict:
        """Wall seconds in admission and in decode segments, each without
        the seconds of the CUDA graphs captured in it (``admit_capture_s``
        / ``capture_s``, counted in ``admit_captures`` / ``captures``),
        prompt tokens prefilled, batched decode steps, the rows live at
        each summed over them (``live_row_steps``: slots holding a
        request), the target forwards they ran and the host read-backs of
        the decode segments (``GraphSet.readbacks``: one a segment where
        they replay graphs; an eager speculative segment reads each
        condition back too)."""
        return {"admit_s": 0.0, "decode_s": 0.0, "prefill_tokens": 0,
                "steps": 0, "live_row_steps": 0, "target_forwards": 0,
                "capture_s": 0.0, "captures": 0, "admit_capture_s": 0.0,
                "admit_captures": 0, "readbacks": 0}

    def submit(self, req: Request) -> None:
        profiling.event("submit", req.rid)
        self.queue.append(req)

    def _admit(self) -> None:
        for slot in range(self.slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue[0]
            with profiling.span("admit", req.rid):   # one slice
                admitted = self._admit_one(slot, req)
            if admitted:
                profiling.event("first_token", req.rid)
                self.queue.pop(0)
                self.slot_req[slot] = req
            else:
                return   # admission slice spent; decode a segment first

    def _admitting(self) -> bool:
        """True while a chunked admission is mid-flight."""
        return False

    def _sync(self) -> None:
        """Wait for the device, so that the clock brackets the work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, max_wall_s: float = 600.0) -> List[Request]:
        """Drive until queue + slots drain (or the wall clock expires);
        returns finished requests in completion order. ``self.stats``
        afterwards splits the wall into admission (prefill work) and decode
        segments: at long prompts the wall is prefill-dominated, and the
        decode-segment throughput is the number to hold against a
        fixed-batch run."""
        done: List[Request] = []
        self.stats = self._blank_stats()
        t0 = time.perf_counter()
        while (self.queue or self._admitting()
               or any(r is not None for r in self.slot_req)) \
                and time.perf_counter() - t0 < max_wall_s:
            with profiling.span("cycle"):
                self._cycle(done)
        return done

    def _cycle(self, done: List[Request]) -> None:
        """One cycle of ``run``: an admission sweep, then (with a slot
        live) one decode segment and the retirements it brings; the host
        spans ``admission`` (the sweep, its ``admit`` slices and the wait
        for the device), ``decode_segment`` (the live slots' request ids)
        and ``retire``."""
        with profiling.span("admission"):
            ta = time.perf_counter()
            c0, s0 = self.graphs.captures, self.graphs.capture_s
            self._admit()
            self._sync()
            cap = self.graphs.capture_s - s0
            self.stats["admit_s"] += time.perf_counter() - ta - cap
            self.stats["admit_capture_s"] += cap
            self.stats["admit_captures"] += self.graphs.captures - c0
        live = [r.rid for r in self.slot_req if r is not None]
        if not live:
            return   # nothing live yet (admission still chunking)
        with profiling.span("decode_segment", live):
            td = time.perf_counter()
            c0, s0 = self.graphs.captures, self.graphs.capture_s
            r0, steps0 = self.graphs.readbacks, self.stats["steps"]
            new_tokens, force = self._decode_segment()
            cap = self.graphs.capture_s - s0
            self.stats["decode_s"] += time.perf_counter() - td - cap
            self.stats["capture_s"] += cap
            self.stats["captures"] += self.graphs.captures - c0
            self.stats["readbacks"] += self.graphs.readbacks - r0
            steps = self.stats["steps"] - steps0
            self.stats["live_row_steps"] += len(live) * steps
            profiling.count("live_row_steps", len(live) * steps)
            profiling.count("slot_steps", self.slots * steps)
        with profiling.span("retire"):
            for slot, req in enumerate(self.slot_req):
                if req is None:
                    continue
                req.out.extend(new_tokens[slot])
                eos_pos = [i for i, t in enumerate(req.out)
                           if t in self._eos_ids]
                if eos_pos:
                    req.out = req.out[: eos_pos[0] + 1]
                if len(req.out) >= req.max_new_tokens:
                    # trim the segment overshoot to the requested limit
                    # (the EOS path above already trims)
                    req.out = req.out[: req.max_new_tokens]
                if eos_pos or len(req.out) >= req.max_new_tokens \
                        or force[slot]:
                    req.done = True
                    profiling.event("done", req.rid)
                    done.append(req)
                    self.slot_req[slot] = None
                    self._release_slot(slot)


class Scheduler(SchedulerBase):
    """AR continuous batching: admit -> prefill into a free slot ->
    batched decode segments -> retire. Host-side control, device-side
    compute. ``device=None`` means the first CUDA card and raises without
    one; ``graphs`` as ``Engine``'s (None: the decode steps replay a CUDA
    graph on a card, eager on the CPU; False: eager on the card too). The
    prompt is prefilled in ``prefill_chunk``-token forwards
    straight into the slot's row of the pool (the JAX class takes
    ``prefill_chunk`` too but runs the prompt as one forward; in chunks a
    long prompt needs no [T, vocab] logits and no T x T new-token block)."""

    def __init__(self, cfg: ModelConfig, spec: SpecConfig, params, *,
                 batch: int = 4, max_len: int = 4096,
                 prefill_chunk: int = 256, eos_token_id: int = 2,
                 dtype=torch.bfloat16, segment: int = 16, seed: int = 0,
                 out_cap: int = 1024, device=None, graphs=None):
        dev = resolve_device(device)
        super().__init__(batch, eos_token_id, dev,
                         graphs_mod.GraphSet(dev, graphs))
        if params["embed"].device != self.device:
            raise ValueError(f"params are on {params['embed'].device}, "
                             f"scheduler on {self.device}")
        self.cfg, self.spec, self.params = cfg, spec, params
        self.batch, self.max_len = batch, max_len
        self.prefill_chunk = prefill_chunk
        self.segment = segment
        self.state = init_batch(cfg, batch, max_len, seed, dtype,
                                out_cap=out_cap, device=self.device)
        # each slot's row of the pool as a batch-1 cache, made once: its
        # planes (views of the pool) key the slot's prefill graphs
        self._rows = [row_view(self.state.kv, s) for s in range(batch)]

    def _admit_one(self, slot: int, req: Request) -> bool:
        ids = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int64,
                              device=self.device)[None]
        self.stats["prefill_tokens"] += int(ids.shape[-1])
        st = self.state
        # slot-local prefill: the row's buffers are views of the pool, so
        # admission writes O(row) bytes in place and copies nothing. Every
        # chunk but the last is a graph region per (slot, width); the last
        # one, which returns logits, a key of its own
        row = dataclasses.replace(
            self._rows[slot],
            seq_len=torch.zeros((), dtype=torch.int32, device=self.device))
        c = self.prefill_chunk
        last = (ids.shape[1] - 1) // c * c
        row = prefill_chunks(self.graphs, self.cfg, self.params, row,
                             ids[:, :last], c)
        logits, row = append_graphed(self.graphs, self.cfg, self.params, row,
                                     ids[:, last:])
        probs = sampling.norm_logits(logits[:, -1], self.spec.temperature,
                                     self.spec.top_k, self.spec.top_p)
        tok = sampling.sample(probs, st.gen)[0]
        self.state = dataclasses.replace(
            st, kv=dataclasses.replace(
                st.kv, seq_len=set_entry(st.kv.seq_len, slot, row.seq_len)),
            tokens=set_entry(st.tokens, slot, tok),
            live=set_entry(st.live, slot, True),
            n_out=set_entry(st.n_out, slot, 0))
        req.out.append(int(tok))
        return True

    def _decode_segment(self):
        for _ in range(self.segment):
            self.state = batched_ar_step(self.cfg, self.spec, self.params,
                                         self.state, graphs=self.graphs)
        self.stats["steps"] += self.segment
        self.stats["target_forwards"] += self.segment
        st = self.state
        cap = st.out_buf.shape[1]
        host = self.graphs.read(torch.cat(
            [st.out_buf, st.n_out[:, None]], 1)).numpy()  # the one read-back
        out, n_out = host[:, :cap], host[:, cap]
        new_tokens, force = [], []
        for slot, req in enumerate(self.slot_req):
            if req is None:
                new_tokens.append([])
                force.append(False)
                continue
            # drain newly generated tokens (req.out[0] is the prefill
            # sample, the buffer holds only decode-step tokens)
            new_tokens.append(out[slot, len(req.out) - 1:
                                  n_out[slot]].tolist())
            force.append(bool(n_out[slot] >= cap))
        return new_tokens, force

    def _release_slot(self, slot: int) -> None:
        self.state = dataclasses.replace(
            self.state, live=set_entry(self.state.live, slot, False))
