"""Execution engine — the port of ``triforce_tpu/engine.py``.

The JAX engine compiles each whole speculation round, and whole
generations, into one XLA program with ``lax.while_loop``s. Here a step is
a function of device tensors that makes no host decision: its
data-dependent loops are conditional bodies (``GraphSet.cond``: the
middle trips, each trip's drafter forwards) and the rest is
``torch.where`` and writes at device offsets, down to the commit
(rollback, retrieval tail refresh, drafter replay and window compaction
take device counts). ``Engine.generate`` runs the whole generation as
``max_len`` calls of one loop region that holds the step as a
conditional body, with the token buffer, ``n``, the counters, the kv
length and the next token kept in place; it reads back once, at its end.

On a CUDA device the loop region is captured as one CUDA graph at its
first call (``graphs.py``; the bodies become if-nodes) and replayed, so a
generation is ``max_len`` graph launches and one read-back, as the JAX
engine's is one dispatch. ``Engine(graphs=False)`` runs the same code
eagerly (the witness a graphed run is held against: its conditions are
read back), and so does the CPU. ``_step_fn`` runs one step at a time
(one region, one read-back of its counts); the AR loop replays its
one-token graph with no read-back until the end.

Random draws come from the state's ``torch.Generator``: each step draws
all its uniforms in one call of fixed shape at its top (``_draws``), and
its samples and coins take their shares, so that which bodies run never
changes what is drawn (the JAX engine splits its key at fixed points).
The caches are updated in place (see ``cache.py``); a state is not
reusable after a step unless it was cloned first
(``TriForceState.clone``).

The prefills are graphed too (``append_graphed``, ``prefill_chunks``):
each target chunk width is one region, the retrieval build (the last
prompt token's forward) another, each drafter chunk width (the window
slide and the forward) a third; so the JAX package's prefill scans and
its build jit become one graph per width, replayed chunk after chunk.
The first-token sample stays eager, outside the build, as in the JAX
package.

The batched steps (``triforce_step_rows``, ``retrieval_spec_step_rows``)
run the same step for B rows of a ``StackedState`` at once: every forward
runs once for all rows, where the JAX package vmaps its batch-1 step. The
counts are [B] device tensors and the per-row choices ``torch.where``; the
lockstep middle trips and their drafter forwards are conditional bodies
while any row needs them. ``decode_rows`` runs ``steps`` of them as
``steps`` calls of one loop region with one read-back, as the JAX
package's ``_decode_fused``. Each row owns a generator and draws from it
the block of uniforms the batch-1 step draws, and takes the same shares,
so a batched row emits what its batch-1 run with the same seed emits.

``Engine(mesh=, shard_seq=)`` runs the batch-1 engine as one rank of a
``parallel.mesh.Mesh``, as the JAX engine runs under a device mesh: its
params are this rank's shards (``parallel/sharding.py``), its caches hold
this rank's KV heads and, with ``shard_seq``, its slots of the full cache,
and the forwards issue the collectives (``models/llama.py``,
``ops/sp_attention.py``) over ``tp`` and ``sp`` alone. Every rank runs the
same steps with the same generator, so every rank emits the same tokens
and nothing is broadcast. A mesh with ``dp`` above 1 is the composed
mesh of batched rows (``batched_spec.py``): each ``dp`` index's (tp, sp)
group runs its own batch-1 prefills and its block of rows, and
``decode_rows`` gathers the rows over ``dp`` once a call.

A hybrid model (``config.HybridConfig``: sliding-window layers beside
full ones, expert MLPs) runs the batch-1 engine as a plain one does. Its
full cache holds the full layers and a ring a sliding layer
(``cache.KVCache``), both rolled back by the one ``seq_len``; the ring
takes the window plus the most tokens one forward appends
(``ring_slack``). The retrieval build, the retrieval cache and its tail
refresh cover the full layers only, and the middle verify's sliding
layers read the target's rings exactly. ``moe_counts`` [3, 3] (int64 on
the device) adds up the expert layers' counts (``ops/moe.py``: experts
read, pairs routed, layer calls) of target forwards (verifies and AR
steps), middle verifies and prefill forwards (``MOE_KINDS``), inside the
graphs. The batched rows, the serving schedulers, the tree, the mesh and
the int8 caches and weights refuse such a model.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from . import graphs as graphs_mod
from . import profiling
from .cache import (KVCache, RetrievalCache, StreamingCache,
                    batched_commit_and_refresh, device_scalar, init_kv,
                    init_retrieval, init_streaming, retrieval_tail_refresh,
                    streaming_evict_for_spec, streaming_evict_for_spec_rows,
                    streaming_evict_prefill, write_at)
from .config import ModelConfig, SpecConfig, refuse_hybrid, resolve_device
from .models import llama
from .ops import moe, sampling
from .ops.flash_decode import causal_mask
from .parallel import sharding
from .parallel.mesh import Mesh, gather_rows

JUNK_TOKEN = 100  # the reference pads spec buffers with token id 100
MOE_KINDS = ("target", "middle", "prefill")   # rows of Engine.moe_counts


def _as_eos_tuple(eos_token_id) -> tuple:
    """Normalize an EOS spec to a tuple of ids."""
    if isinstance(eos_token_id, (tuple, list)):
        return tuple(int(e) for e in eos_token_id)
    return (int(eos_token_id),)


def _is_eos(tok, eos_ids: tuple):
    """Elementwise membership of ``tok`` in the EOS id tuple."""
    m = tok == eos_ids[0]
    for e in eos_ids[1:]:
        m = m | (tok == e)
    return m


def _clone_generator(gen: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


@dataclasses.dataclass
class TriForceState:
    """All mutable decode state."""
    kv: KVCache                        # target full cache
    rkv: RetrievalCache                # target retrieval cache
    dkv: Optional[StreamingCache]      # drafter cache (None without one)
    next_token: torch.Tensor           # [1] int64, sampled, not yet in kv
    gen: torch.Generator               # random stream of every draw

    def clone(self, seed: Optional[int] = None) -> "TriForceState":
        """Deep copy; with ``seed`` the copy draws from a fresh generator
        seeded with it, else from a copy of this state's generator."""
        if seed is None:
            gen = _clone_generator(self.gen)
        else:
            gen = torch.Generator(device=self.gen.device).manual_seed(seed)
        return TriForceState(
            kv=self.kv.clone(), rkv=self.rkv.clone(),
            dkv=None if self.dkv is None else self.dkv.clone(),
            next_token=self.next_token.clone(), gen=gen)


@dataclasses.dataclass
class StepStats:
    """Per-step outputs of ``Engine._step_fn``: ``tokens`` and ``eos``
    stay on the device; the counts are host ints (the step's one
    read-back)."""
    tokens: torch.Tensor      # [gamma + 2] emitted tokens, junk-padded
    n_emitted: int            # count_acc + resampled + bonus
    gamma2: int               # middle tokens proposed to the target
    accepted: int             # outer accepts
    resampled: int            # 1 if outer rejection resampled
    bonus: int                # 1 if all-accepted bonus sampled
    eos: torch.Tensor         # bool: EOS emitted this step (device)
    mid_draft: int = 0        # drafter proposals in the middle loop
    mid_accept: int = 0       # drafter proposals the middle accepted
    mid_verify: int = 0       # middle (retrieval-cache) verify forwards run
    mid_live: int = 0         # middle verifies that read the retrieval cache


@dataclasses.dataclass
class StackedState:
    """Decode state of B sequences, row-stacked (``cache.py``): caches
    [B, L, Hkv, S, D] with ``kv.seq_len`` / ``dkv.seq_len`` [B]. A row
    whose ``kv.seq_len`` is 0 is a dead slot: its forwards read no cache
    and it stays at 0."""
    kv: KVCache
    rkv: RetrievalCache
    dkv: Optional[StreamingCache]
    next_token: torch.Tensor           # [B] int64
    gens: list                         # one torch.Generator per row

    @property
    def rows(self) -> int:
        return self.next_token.shape[0]

    def clone(self) -> "StackedState":
        return StackedState(
            kv=self.kv.clone(), rkv=self.rkv.clone(),
            dkv=None if self.dkv is None else self.dkv.clone(),
            next_token=self.next_token.clone(),
            gens=[_clone_generator(g) for g in self.gens])


@dataclasses.dataclass
class BatchedStepStats:
    """Per-step outputs of a batched step, a leading row axis on each
    field, read back once at the end of the step's call
    (``BatchedSpecEngine.step``)."""
    tokens: torch.Tensor      # [B, gamma + 2] emitted tokens, junk-padded
    n_emitted: torch.Tensor   # [B]
    gamma2: torch.Tensor
    accepted: torch.Tensor
    resampled: torch.Tensor
    bonus: torch.Tensor
    eos: torch.Tensor         # [B] bool
    mid_draft: torch.Tensor
    mid_accept: torch.Tensor
    mid_verify: torch.Tensor  # middle verifies each row took part in
    mid_live: torch.Tensor    # ... that read its retrieval cache
    target_forwards: int = 0  # batched target forwards the step ran


class Engine:
    """Holds params and drives batch-1 decoding for one (target, drafter)
    pair on one device. ``device=None`` means the first CUDA card and
    raises when there is none.

    ``kv_quant``: the target's full and retrieval caches hold int8 codes
    with per-token scales (the drafter's cache never does).
    ``weight_quant``: the target's and the drafter's matmul weights are
    quantized to int8 per output channel here (``engine.py:141-150``); the
    target prefill's chunks run over a bf16 copy converted exactly from
    the codes (``dense_weights``), since its wide chunks would convert
    every weight per chunk (``engine.py:226-231``): once per call on an
    eager engine, once per engine while graphs are on.
    With ``spec.mid_act_quant`` the middle verify then runs int8 weights
    against int8 activations (``llama._wmm(aq=True)``).

    ``graphs``: None captures the decode regions as CUDA graphs on a CUDA
    device and runs them eagerly on the CPU; False runs them eagerly on
    the card too (the eager witness); True on the CPU raises. The graphs
    are ``self.graphs`` (``graphs.GraphSet``); ``release_graphs`` drops
    them, and the prefill's converted weights with them.

    ``mesh`` (a ``parallel.mesh.Mesh``): this process is one rank of it,
    on ``mesh.device``; the forwards run over its ``tp`` and ``sp`` axes
    (its ``dp`` axis splits the rows of ``batched_spec``). The target
    params may be the full weights (cut here, ``sharding.shard_params``)
    or this rank's shards (loaded with ``shardings=``); the drafter is
    replicated.
    ``shard_seq`` splits the full cache's slots over ``sp``; its length is
    then padded to a multiple of ``sp * chunk_size``, so that every shard
    holds whole retrieval chunks. A mesh whose collectives cannot be
    captured (gloo on a card) needs ``graphs=False``."""

    def __init__(self, target_cfg: ModelConfig, spec: SpecConfig,
                 target_params, *, draft_cfg: Optional[ModelConfig] = None,
                 draft_params=None, prefill: int, max_cache_len: int,
                 eos_token_id: int = 2, dtype=torch.bfloat16,
                 prefill_chunk: int = 512, draft_prefill_chunk: int = 64,
                 kv_quant: bool = False, weight_quant: bool = False,
                 mesh=None, shard_seq: bool = False, device=None,
                 graphs=None):
        if prefill % spec.chunk_size:
            raise ValueError("prefill must be a multiple of chunk_size")
        if mesh is not None:
            refuse_hybrid(target_cfg, "the mesh")
        if kv_quant or weight_quant:
            refuse_hybrid(target_cfg, "int8 caches and weights")
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                                f"{type(mesh).__name__}")
            device = mesh.device if device is None else device
            if shard_seq:
                unit = mesh.shape["sp"] * spec.chunk_size
                max_cache_len = -(-max_cache_len // unit) * unit
        self.device = resolve_device(device)
        if mesh is not None and self.device != mesh.device:
            raise ValueError(f"the engine is on {self.device}, its mesh on "
                             f"{mesh.device}")
        self.mesh = mesh
        self.shard_seq = bool(shard_seq) and mesh is not None
        self.graphs = graphs_mod.GraphSet(self.device, graphs)
        if mesh is not None and self.graphs.mode == "graph" \
                and not mesh.capturable:
            raise ValueError(f"{mesh.backend} collectives cannot be captured "
                             f"in a CUDA graph: pass graphs=False")
        if target_params["embed"].device != self.device:
            raise ValueError(f"target params are on "
                             f"{target_params['embed'].device}, engine on "
                             f"{self.device}")
        if draft_params is not None \
                and draft_params["embed"].device != self.device:
            raise ValueError("draft params are not on the engine's device")
        self.target_cfg = target_cfg
        self.draft_cfg = draft_cfg
        self.spec = spec
        self.prefill = prefill
        self.max_cache_len = max_cache_len
        self.eos_token_id = _as_eos_tuple(eos_token_id)
        self.dtype = dtype
        self.prefill_chunk = prefill_chunk
        # eviction keeps recent - chunk tokens, so the chunk cannot exceed
        # the recent window
        self.draft_prefill_chunk = min(draft_prefill_chunk,
                                       spec.draft_recent_size)
        self.kv_quant = kv_quant
        if mesh is not None and not sharding.is_local(target_params, mesh,
                                                      target_cfg):
            target_params = sharding.shard_params(target_params, mesh,
                                                  target_cfg)
        if weight_quant:
            target_params = llama.quantize_weights(target_params, mesh,
                                                   target_cfg)
            if draft_params is not None:
                draft_params = llama.quantize_weights(draft_params)
        self.t_params = target_params
        self.d_params = draft_params
        self._dense = None     # the prefill's converted weights (graphed)
        self.ring_slack = max(prefill_chunk, spec.gamma + 2)
        if target_cfg.windowed \
                and self.ring_slack > target_cfg.sliding_window:
            raise ValueError(f"prefill chunks of {prefill_chunk} would "
                             f"overwrite ring slots a window of "
                             f"{target_cfg.sliding_window} still reads")
        self.moe_counts = torch.zeros(
            (len(MOE_KINDS), 3), dtype=torch.int64,
            device=self.device) if target_cfg.moe else None
        if self.device.type == "cuda":
            # the decode forwards' causal masks (the target's kernel rows:
            # AR, middle verify, target verify; the drafter's chain and
            # replay), built before a loop region captures them
            g = target_cfg.num_heads // target_cfg.num_kv_heads
            for t, groups in ((1, g), (spec.gamma + 1, g),
                              (spec.gamma + 2, g), (spec.gamma + 1, 1),
                              (spec.gamma + 3, 1)):
                causal_mask(t, t, groups, self.device)

    # ------------------------------------------------------------------
    # state construction / prefill
    # ------------------------------------------------------------------

    @property
    def fwd(self) -> dict:
        """The mesh arguments of the target's full-cache forwards."""
        return dict(mesh=self.mesh, shard_seq=self.shard_seq)

    def counting(self, kind: str):
        """Count the expert layers of the forwards run (or captured)
        inside into ``moe_counts``'s row of ``kind`` (``MOE_KINDS``)."""
        if self.moe_counts is None:
            return profiling.NULL
        return moe.counting(self.moe_counts[MOE_KINDS.index(kind)])

    def moe_counters(self) -> dict:
        """``moe_counts`` read off the device once, by name:
        ``moe.experts_read.<kind>`` (the distinct experts each layer call
        read, added up), ``moe.tokens_routed.<kind>`` (token-expert pairs)
        and ``moe.layer_calls.<kind>``, a ``MOE_KINDS`` kind each; {} for a
        model with no expert layers."""
        if self.moe_counts is None:
            return {}
        return {f"moe.{name}.{kind}": v
                for kind, row in zip(MOE_KINDS, self.moe_counts.tolist())
                for name, v in zip(("experts_read", "tokens_routed",
                                    "layer_calls"), row)}

    def local_target(self):
        """(target config with this rank's KV heads, this rank's full-cache
        slots): the shapes of its target caches
        (``sharding.state_shardings``; the whole ones without a mesh)."""
        cfg, slots = self.target_cfg, self.max_cache_len
        if self.mesh is not None:
            sh = sharding.state_shardings(self.mesh, cfg, self.draft_cfg,
                                          self.shard_seq)
            _, _, hkv, slots, _ = sh.kv["k"].local_shape(
                (cfg.num_layers, 1, cfg.num_kv_heads, slots, cfg.head_dim))
            cfg = cfg.with_(num_kv_heads=hkv)
        return cfg, slots

    def init_state(self, seed: int) -> TriForceState:
        """A fresh state; over a mesh its target caches have this rank's
        local shapes (``local_target``)."""
        dev = self.device
        cfg, slots = self.local_target()
        kv = init_kv(cfg, slots, 1, self.dtype, device=dev,
                     quant=self.kv_quant, ring_slack=self.ring_slack)
        rkv = init_retrieval(cfg, self.spec, 1, self.dtype, device=dev,
                             quant=self.kv_quant)
        dkv = None
        if self.draft_cfg is not None:
            dkv = init_streaming(self.draft_cfg, self.spec, 1, self.dtype,
                                 device=dev)
        return TriForceState(
            kv=kv, rkv=rkv, dkv=dkv,
            next_token=torch.zeros((1,), dtype=torch.int64, device=dev),
            gen=torch.Generator(device=dev).manual_seed(seed))

    def prefill_body(self, kv: KVCache, body: torch.Tensor) -> KVCache:
        """Chunked prefill of ``body`` [1, P] into ``kv``: full
        ``prefill_chunk`` chunks, then the ragged remainder
        (``prefill_chunks``), over weights converted out of int8
        (``dense_weights``; bit-identical)."""
        with self.counting("prefill"):
            return prefill_chunks(self.graphs, self.target_cfg,
                                  dense_weights(self, self.t_params), kv,
                                  body, self.prefill_chunk, **self.fwd)

    def _sample_next(self, logits, gen):
        sp = self.spec
        probs = sampling.norm_logits(logits[:, -1], sp.temperature,
                                     sp.top_k, sp.top_p)
        return sampling.sample(probs, gen)

    def prefill_target(self, state: TriForceState,
                       input_ids: torch.Tensor) -> TriForceState:
        """Chunked prefill of all but the last token, then a 1-token
        forward that also builds the retrieval cache."""
        if input_ids.shape[1] != self.prefill:
            raise ValueError(f"prompt has {input_ids.shape[1]} tokens, the "
                             f"engine was built for {self.prefill}")
        kv = self.prefill_body(state.kv, input_ids[:, :-1])
        return self._build_and_sample(state, kv, input_ids)

    def _build_and_sample(self, state: TriForceState, kv: KVCache,
                          input_ids: torch.Tensor) -> TriForceState:
        """The last prompt token's forward: builds the retrieval cache and
        samples the first generated token (eagerly, outside the build's
        region)."""
        logits, kv = self._build(kv, state.rkv, input_ids[:, -1:])
        return dataclasses.replace(
            state, kv=kv, next_token=self._sample_next(logits, state.gen))

    def _build(self, kv: KVCache, rkv: RetrievalCache, last: torch.Tensor):
        """The retrieval build: ``last`` [1, 1] appended to ``kv`` while
        every layer's budget region of ``rkv`` is built in place; one
        graph region. Returns (logits [1, 1, V], kv)."""
        sp = self.spec
        with self.counting("prefill"):
            return append_graphed(self.graphs, self.target_cfg,
                                  self.t_params, kv, last, build_rkv=rkv,
                                  prefill=self.prefill,
                                  chunk_size=sp.chunk_size,
                                  budget=sp.budget, **self.fwd)

    def prefill_target_partial(self, state: TriForceState,
                               input_ids: torch.Tensor, pos: int,
                               max_chunks: int):
        """Advance a chunked target prefill by up to ``max_chunks`` full
        chunks from token offset ``pos``, running the ragged remainder and
        the final build-token forward when the prompt is exhausted.
        Returns ``(state, new_pos, done)``. This is the serving
        scheduler's admission slice; chaining slices to completion equals
        ``prefill_target`` (the same chunk boundaries)."""
        if input_ids.shape[1] != self.prefill:
            raise ValueError(f"prompt has {input_ids.shape[1]} tokens, the "
                             f"engine was built for {self.prefill}")
        body = input_ids[:, :-1]
        stop = self.prefill_slice(pos, max_chunks)
        kv = state.kv
        if stop > pos:
            # whole chunks, then the remainder (if any) as prefill_body's
            kv = self.prefill_body(kv, body[:, pos:stop])
        if stop < body.shape[1]:
            return dataclasses.replace(state, kv=kv), stop, False
        return (self._build_and_sample(state, kv, input_ids), self.prefill,
                True)

    def prefill_slice(self, pos: int, max_chunks: int) -> int:
        """Where ``prefill_target_partial`` from token offset ``pos`` stops:
        up to ``max_chunks`` full chunks, the ragged remainder with them
        when it fits in the slice; at ``prefill - 1`` (the whole body) the
        build runs too. A host computation: ranks that do not hold the
        row follow the admission with it."""
        c, body = self.prefill_chunk, self.prefill - 1
        n = min(max_chunks, (body - pos) // c)
        stop = pos + n * c
        if n < max_chunks and stop < body:
            stop = body            # the remainder fits in the same slice
        return stop

    def prefill_draft(self, state: TriForceState, input_ids: torch.Tensor,
                      mode: str = "full") -> TriForceState:
        """Drafter prefill with StreamingLLM eviction. ``mode='full'``
        replays the whole prompt in chunks; ``mode='fast'`` only the sink
        chunk and the tokens that can survive eviction."""
        c = self.draft_prefill_chunk
        sp = self.spec
        if mode == "fast":
            cap = sp.draft_start_size + sp.draft_recent_size
            keep = (cap // c) * c
            if input_ids.shape[1] > keep:
                input_ids = torch.cat([input_ids[:, :c],
                                       input_ids[:, -(keep - c):]], dim=1)
        dkv = state.dkv
        d_cfg, d_params = self.draft_cfg, self.d_params

        def region(ids, seq_len):
            with self.graphs.region("draft_prefill"):
                d = streaming_evict_prefill(_kv_at(dkv, seq_len), sp, c)
                _, d = llama.draft_forward(d_cfg, d_params, ids, d,
                                           need_logits=False)
            return (d.seq_len,)

        caches = graphs_mod.planes(dkv) + param_planes(d_params)
        seq_len = dkv.seq_len
        for s in range(0, input_ids.shape[1], c):
            seq_len, = self.graphs.run("draft_prefill", region,
                                       (input_ids[:, s:s + c], seq_len),
                                       caches=caches)
        return dataclasses.replace(state, dkv=_kv_at(dkv, seq_len))

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def release_graphs(self) -> None:
        """Drop this engine's CUDA graphs and the prefill's converted
        weights (``torch.cuda.empty_cache`` can then return their
        memory)."""
        self.graphs.release()
        self._dense = None

    def ar_step(self, kv: KVCache, token: torch.Tensor,
                gen: torch.Generator):
        """One autoregressive token: (next token [1], kv). One graph: the
        forward, the filter and the sample."""
        def region(token, seq_len):
            logits, kv_out, _ = llama.forward_append(
                self.target_cfg, self.t_params, token[:, None],
                dataclasses.replace(kv, seq_len=seq_len), **self.fwd)
            return self._sample_next(logits, gen), kv_out.seq_len

        with self.counting("target"):
            tok, seq_len = self.graphs.run("ar", region, (token, kv.seq_len),
                                           caches=graphs_mod.planes(kv),
                                           gens=(gen,))
        return tok, dataclasses.replace(kv, seq_len=seq_len)

    def generate_ar(self, kv: KVCache, token: torch.Tensor,
                    gen: torch.Generator, max_len: int):
        """Autoregressive generation of ``max_len`` tokens with no host
        read-back. Returns (kv, last token, gen, token buffer [max_len])."""
        buf = torch.full((max_len,), JUNK_TOKEN, dtype=torch.int64,
                         device=self.device)
        for i in range(max_len):
            token, kv = self.ar_step(kv, token, gen)
            buf[i] = token[0]
        return kv, token, gen, buf

    def _gen(self, mode: str, force_accept, max_len: int,
             stop_on_eos: bool, state: TriForceState):
        """The generation loop on the device, as the JAX engine's
        ``while_loop`` (``triforce_tpu/engine.py:247-271``): ``max_len``
        calls of one region (a loop region of ``graphs``: captured at its
        first call, then replayed) that draws the step's uniforms and runs
        the step as a conditional body while ``n < max_len + 1`` and no
        stop; the step writes the token buffer at the device offset ``n``,
        adds the counters and leaves the kv length and the next token in
        place. A step emits at least one token, so ``max_len`` calls
        suffice, and the host reads nothing back until the end: once,
        the buffer, ``n`` and the counters (with the bodies' launch
        counts, ``GraphSet.read``)."""
        if mode not in _BODIES:
            raise ValueError(mode)
        if mode == "triforce" and self.draft_cfg is None:
            raise ValueError("triforce mode needs a drafter")
        with profiling.span("generate"):
            return self._gen_loop(mode, force_accept, max_len, stop_on_eos,
                                  state)

    def _gen_loop(self, mode: str, force_accept, max_len: int,
                  stop_on_eos: bool, state: TriForceState):
        dev, g = self.device, self.graphs
        slack = self.spec.gamma + 2
        caches = graphs_mod.planes(state.kv, state.rkv, state.dkv)
        i64 = dict(dtype=torch.int64, device=dev)
        lb = g.buffers("gen " + mode, caches, lambda: dict(
            buf=torch.empty((max_len + slack,), **i64),
            n=torch.empty((), **i64),
            stop=torch.empty((), dtype=torch.bool, device=dev),
            counters=torch.empty((9,), **i64),
            seq_len=torch.empty_like(state.kv.seq_len),
            next_token=torch.empty_like(state.next_token)), extra=(max_len,))
        lb["buf"].fill_(JUNK_TOKEN)
        lb["buf"][:1] = state.next_token[:1]
        lb["n"].fill_(1)
        lb["stop"].fill_(False)
        lb["counters"].zero_()
        lb["seq_len"].copy_(state.kv.seq_len)
        lb["next_token"].copy_(state.next_token)
        body = _BODIES[mode]
        parts = _draw_parts(self.spec, self.target_cfg.vocab_size, mode)
        gen = state.gen
        st = dataclasses.replace(state, kv=_kv_at(state.kv, lb["seq_len"]),
                                 next_token=lb["next_token"])

        def region():
            # the loop's turn: draws, then the step where it holds
            with g.region("loop"):
                u = _draws(parts, gen, dev)

                def step():
                    with g.region("step"):
                        o = body(self, st, u, force_accept)
                        write_at(lb["buf"], o["tokens"], lb["n"], 0)
                        lb["n"].add_(o["n_emitted"])
                        # the step count made in the step (a tensor made
                        # per call would be read by address on every
                        # replay)
                        counts = _counts_of(o)[:9]
                        counts[:1] = 1
                        lb["counters"].add_(counts)
                        lb["seq_len"].copy_(o["seq_len"])
                        lb["next_token"].copy_(o["next_token"])
                        if stop_on_eos:
                            lb["stop"].copy_(o["eos"])
                g.cond((lb["n"] < max_len + 1) & ~lb["stop"], step)
            return ()

        for _ in range(max_len):
            g.run("gen " + mode, region, (), caches=caches + tuple(
                lb.values()), gens=(gen,),
                extra=(force_accept, stop_on_eos, max_len),
                capture_first=True)
        with profiling.span("readback"):
            host = g.read(torch.cat([lb["buf"], lb["n"].reshape(1),
                                     lb["counters"]]))   # the read-back
        size = max_len + slack
        if profiling.current() is not None:
            for name, v in zip(("steps",) + _COUNTS,
                               host[size + 1:].tolist()):
                profiling.count(name, v)
        state = dataclasses.replace(
            state, kv=_kv_at(state.kv, lb["seq_len"].clone()),
            next_token=lb["next_token"].clone())
        return state, host[:size], int(host[size]), host[size + 1:].numpy()

    def generate(self, state: TriForceState, max_len: int,
                 mode: str = "triforce", stop_on_eos: bool = False):
        """Speculative generation until ``max_len`` tokens past the first
        (``_gen``). Returns (state, token_buf (host), n, counters) with
        counters = [steps, accepted, proposed, resampled, bonus, mid_draft,
        mid_accept, mid_verify, mid_live]."""
        return self._gen(mode, None, max_len, stop_on_eos, state)

    def generate_forced(self, state: TriForceState, max_len: int,
                        alpha: float, mode: str = "retrieval",
                        stop_on_eos: bool = False):
        """Controlled-acceptance generation: every accept test becomes a
        coin flip at rate ``alpha`` while all real compute runs (drafter
        forwards, middle verifies, full-cache verify, rollback, tail
        refresh). The output is NOT target-distributed."""
        return self._gen(mode, alpha, max_len, stop_on_eos, state)

    def _step_fn(self, mode: str, force_accept):
        """One step of ``mode`` at a time, each reading its counts back:
        ``state -> (state, StepStats)``."""
        if mode not in _BODIES:
            raise ValueError(mode)
        if mode == "triforce" and self.draft_cfg is None:
            raise ValueError("triforce mode needs a drafter")
        return lambda s: _step(self, s, mode, force_accept)


# ---------------------------------------------------------------------------
# Graphed prefill (every engine's and scheduler's)
# ---------------------------------------------------------------------------

def _kv_at(kv, seq_len: torch.Tensor):
    return dataclasses.replace(kv, seq_len=seq_len)


def param_planes(params) -> tuple:
    """Every tensor of ``params``, for a region's key beside its cache
    planes: a graph then never replays over weights that were freed or
    replaced (a new converted copy has new addresses, so a new key)."""
    return tuple(params["layers"].values()) + tuple(
        v for k, v in params.items() if k != "layers")


def dense_weights(eng, params):
    """``params`` with int8 matmul weights converted to ``eng.dtype``
    (``llama.dequant_weights``, exact) for the prefill's wide chunks. An
    eager engine converts per call (the copy is freed after the call); with
    graphs on, the copy is made once and kept in ``eng._dense`` until
    ``release_graphs``, because a captured chunk reads its addresses."""
    if not eng.graphs.enabled:
        return llama.dequant_weights(params, eng.dtype)
    if eng._dense is None:
        eng._dense = llama.dequant_weights(params, eng.dtype)
    return eng._dense


def append_graphed(graphs: graphs_mod.GraphSet, cfg: ModelConfig, params,
                   kv: KVCache, ids: torch.Tensor, *, need_logits=True,
                   build_rkv: Optional[RetrievalCache] = None,
                   prefill: int = 0, chunk_size: int = 8, budget: int = 0,
                   mesh=None, shard_seq: bool = False):
    """``llama.forward_append`` of ``ids`` into ``kv`` as one region of
    ``graphs`` ("build" with ``build_rkv``, else "prefill"): its inputs are
    ``(ids, kv.seq_len)``, its key holds the planes of ``kv`` and
    ``build_rkv`` and every tensor of ``params`` (``param_planes``), and
    ``need_logits`` and the build's sizes are its ``extra``. So one graph
    serves every chunk of a width (the kernels plan from shapes and read
    ``k_len`` on the device). ``mesh``/``shard_seq``: the forward runs over
    the mesh (a set of one mesh: it belongs to one engine). Returns (logits
    or None, kv at its new length)."""
    name = "build" if build_rkv is not None else "prefill"

    def region(ids, seq_len):
        with graphs.region(name):
            logits, out, _ = llama.forward_append(
                cfg, params, ids, _kv_at(kv, seq_len), build_rkv=build_rkv,
                prefill=prefill, chunk_size=chunk_size, budget=budget,
                need_logits=need_logits, mesh=mesh, shard_seq=shard_seq)
        return (logits, out.seq_len) if need_logits else (out.seq_len,)

    out = graphs.run(name, region, (ids, kv.seq_len),
                     caches=graphs_mod.planes(kv, build_rkv)
                     + param_planes(params),
                     extra=(need_logits, prefill, chunk_size, budget))
    return (out[0] if need_logits else None), _kv_at(kv, out[-1])


def prefill_chunks(graphs: graphs_mod.GraphSet, cfg: ModelConfig, params,
                   kv: KVCache, body: torch.Tensor, chunk: int,
                   **fwd) -> KVCache:
    """Prefill of ``body`` [1, P] into ``kv`` in ``chunk``-token forwards
    (the last one ragged), no logits, each through ``append_graphed``
    (``fwd``: its mesh arguments): the full chunks replay one graph, the
    remainder is a key of its own."""
    for s in range(0, body.shape[1], chunk):
        _, kv = append_graphed(graphs, cfg, params, kv,
                               body[:, s:s + chunk], need_logits=False,
                               **fwd)
    return kv


# ---------------------------------------------------------------------------
# The step's random draws
# ---------------------------------------------------------------------------


def _chain_len(sp: SpecConfig) -> int:
    gamma = sp.gamma
    return max(1, min(sp.middle_chain if sp.middle_chain > 0 else gamma,
                      gamma))


def _trip_slots(sp: SpecConfig) -> int:
    """The middle trips a TriForce step can take: ``middle_trips``, else
    gamma (a live trip consumes at least one proposal)."""
    return sp.middle_trips if sp.middle_trips > 0 else sp.gamma


def _draw_parts(sp: SpecConfig, vocab: int, mode: str) -> tuple:
    """The named blocks of one step's uniforms (``_draws``): per middle
    trip the drafter samples, the chain's coins, the reject sample and the
    bonus sample (TriForce), or the gamma middle samples (retrieval); then
    the outer verify's coins, its residual sample and its bonus sample."""
    gamma = sp.gamma
    if mode == "triforce":
        t, k = _trip_slots(sp), _chain_len(sp)
        mid = (("drafts", (t, k, vocab)), ("mid_coins", (t, k)),
               ("mid_res", (t, vocab)), ("mid_bonus", (t, vocab)))
    else:
        mid = (("mid", (gamma, vocab)),)
    return mid + (("coins", (gamma + 1,)), ("res", (vocab,)),
                  ("bonus", (vocab,)))


def _draws(parts, gens, dev) -> dict:
    """A step's uniforms: one ``torch.rand`` of fixed shape from a
    generator (from each of a list of generators: one per row, stacked on
    a leading axis), cut into ``parts``. Every step draws all of them,
    whichever samples and coins it uses (the JAX engine splits its key at
    fixed points alike), so that a graph whose conditional bodies were
    skipped has drawn what an eager run draws."""
    n = sum(math.prod(shape) for _, shape in parts)
    if isinstance(gens, torch.Generator):
        u = torch.rand((n,), generator=gens, device=dev)
    else:
        u = torch.stack([torch.rand((n,), generator=g, device=dev)
                         for g in gens])
    out, o = {}, 0
    for name, shape in parts:
        size = math.prod(shape)
        out[name] = u[..., o:o + size].reshape(u.shape[:-1] + shape)
        o += size
    return out


def _row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d device index (a 0-d tensor as an index would be
    read back)."""
    return x.index_select(0, i.reshape(1))[0]


# ---------------------------------------------------------------------------
# The batch-1 steps, on the device
# ---------------------------------------------------------------------------
#
# A step is a function of the state's caches (updated in place) and of its
# uniforms; it makes no host decision. Its counts are 0-d device tensors
# and its data-dependent branches are ``GraphSet.cond`` bodies or
# ``torch.where``, as the JAX engine's are ``while_loop``s and
# ``jnp.where`` (``triforce_tpu/engine.py:567-603``, ``:757-818``).


def _middle_spec(eng: Engine, state: TriForceState, u, force_accept=None):
    """Drafter <-> middle speculation loop, generalized to drafter CHAINS
    of ``middle_chain`` tokens per middle verify: k drafter forwards propose
    a chain, ONE middle verify (target weights over the retrieval cache)
    scores every position, and the accept walk applies the per-proposal
    test in order; the first reject samples from that position's middle
    distribution and stops; a fully accepted chain earns a bonus token.

    The trips are ``_trip_slots`` bodies: with ``middle_trips == 0`` trip
    t runs while n < gamma (a conditional body); with ``middle_trips > 0``
    every trip runs, a dead one (n >= gamma) drafting nothing and reading
    zero retrieval columns. Each of a trip's k drafter forwards is a
    conditional body that runs while n0 + i <= gamma - 1. The rest is
    masked on the device; the counts are 0-d int64 tensors."""
    t_cfg, d_cfg, sp = eng.target_cfg, eng.draft_cfg, eng.spec
    gamma, k, vocab = sp.gamma, _chain_len(sp), t_cfg.vocab_size
    dev = state.next_token.device
    cond, region = eng.graphs.cond, eng.graphs.region
    kv_len = state.kv.seq_len
    i64 = dict(dtype=torch.int64, device=dev)
    gen_tokens = torch.full((gamma + 1,), JUNK_TOKEN, **i64)
    gen_probs = torch.zeros((gamma + 1, vocab), dtype=torch.float32,
                            device=dev)
    c = {name: torch.zeros((), **i64)
         for name in ("n", "mid_draft", "mid_accept", "trips", "live_trips")}
    pos = torch.arange(gamma + 1, device=dev)
    js = torch.arange(k, device=dev)

    def trip(t):
        n0 = c["n"].clone()
        live = n0 < gamma
        vt = torch.cat([state.next_token[:1], gen_tokens[:gamma]])[None]
        chain_toks = torch.full((k,), JUNK_TOKEN, **i64)
        chain_q = torch.zeros((k,), dtype=torch.float32, device=dev)

        def draft(i):
            # the drafter at its fixed width gamma+1, the proposal sampled
            # from row n0 + i
            with region("draft"):
                d_logits, _ = llama.draft_forward_spec(
                    d_cfg, eng.d_params, vt, state.dkv, sp, commit=False)
                q = sampling.norm_logits(
                    d_logits[0].index_select(0, (n0 + i).reshape(1)),
                    sp.temperature, -1, sp.top_p)[0]
                tok = sampling.sample_u(q, u["drafts"][t, i]).reshape(1)
                chain_toks[i:i + 1] = tok
                chain_q[i:i + 1] = q.gather(0, tok)
                vt[0].index_copy_(0, (n0 + i + 1).reshape(1), tok)

        for i in range(k):
            cond(n0 + i <= gamma - 1, functools.partial(draft, i))
        i_fin = (gamma - n0).clamp(0, k)       # the drafter forwards run
        # --- ONE middle verify over the whole chain (read-only rkv)
        with region("middle"), eng.counting("middle"):
            m_logits, _ = llama.forward_spec(
                t_cfg, eng.t_params, vt, state.rkv,
                torch.where(live, kv_len, torch.zeros_like(kv_len)),
                sp.budget, commit=False, act_quant=sp.mid_act_quant,
                mesh=eng.mesh, ring=state.kv)
        rows_idx = (n0 + torch.arange(k + 1, device=dev)).clamp(0, gamma)
        p_rows = sampling.norm_logits(m_logits[0].index_select(0, rows_idx),
                                      sp.temperature, -1, sp.top_p)
        # --- the chain's accept tests, all coins at once
        rs = u["mid_coins"][t]
        if force_accept is None:
            ratios = p_rows[js, chain_toks.clamp(0, vocab - 1)] \
                / chain_q.clamp_min(1e-37)
            ok_v = rs < ratios.clamp(max=1.0)
        else:
            ok_v = rs < force_accept
        rej_v = (js < i_fin) & ~ok_v
        any_rej = rej_v.any()
        j_rej = torch.argmax(rej_v.to(torch.int32))
        used = torch.where(any_rej, j_rej + 1, i_fin)     # proposals taken
        # reject: sample from that position's middle distribution
        res = sampling.sample_u(_row(p_rows, j_rej), u["mid_res"][t])
        final = torch.where((js == j_rej) & any_rej, res, chain_toks)
        # commit positions [n0, n0 + used): tokens and their middle rows
        # (the q the OUTER test consumes, accepted and rejected alike)
        jj = pos - n0
        sel = (jj >= 0) & (jj < used)
        jc = jj.clamp(0, k - 1)
        gen_tokens.copy_(torch.where(sel, final[jc], gen_tokens))
        gen_probs.copy_(torch.where(sel[:, None], p_rows[jc], gen_probs))
        n = n0 + used
        # --- bonus on a fully accepted chain: sample from the middle row
        # after the last accepted token
        bonus = ~any_rej & (n <= gamma) & live
        b_row = _row(p_rows, used.clamp(0, k))
        b_tok = sampling.sample_u(b_row, u["mid_bonus"][t])
        at = (pos == n) & bonus
        gen_tokens.copy_(torch.where(at, b_tok, gen_tokens))
        gen_probs.copy_(torch.where(at[:, None], b_row, gen_probs))
        c["n"].copy_(n + bonus.long())
        c["mid_accept"].add_(used - any_rej.long())
        c["mid_draft"].add_(used)
        c["trips"].add_(1)
        c["live_trips"].add_(live.long())

    for t in range(_trip_slots(sp)):
        if sp.middle_trips > 0:
            trip(t)
        else:
            cond(c["n"] < gamma, functools.partial(trip, t))
    return dict(c, gen_tokens=gen_tokens, gen_probs=gen_probs)


def _verify_and_commit(eng: Engine, state: TriForceState, u, gamma2,
                       gen_tokens, gen_probs, has_draft: bool,
                       force_accept=None) -> dict:
    """Target full-cache verify + exact rejection sampling + cache commit,
    on the device: one gamma+2-token forward over ``[next_token] +
    gen_tokens`` (written into kv in place), every accept test at once,
    the residual and the bonus both sampled and chosen between, then the
    rollback (a new length), the retrieval tail refresh and, with a
    drafter, its replay at the fixed width gamma+3 and the window
    compaction, all at device offsets. ``gamma2`` (int or 0-d tensor)
    counts the proposals. Returns the emitted tokens [gamma+2], the
    step's counts (0-d tensors), the new kv length and next token, and
    ``gen_tokens``, ``gen_probs`` and the filtered target rows ``p_all``
    [gamma+2, V] (``return_probs``)."""
    t_cfg, sp = eng.target_cfg, eng.spec
    gamma, vocab = sp.gamma, t_cfg.vocab_size
    dev = gen_tokens.device
    eos = eng.eos_token_id
    gamma2 = device_scalar(gamma2, dev)
    old = state.kv.seq_len
    verify_in = torch.cat([state.next_token[:1], gen_tokens[:gamma + 1]])[None]
    with eng.graphs.region("verify"), eng.counting("target"):
        logits, _, _ = llama.forward_append(t_cfg, eng.t_params, verify_in,
                                            state.kv, **eng.fwd)
    p_all = sampling.norm_logits(logits[0], sp.temperature, sp.top_k,
                                 sp.top_p)                    # [gamma+2, V]
    pos = torch.arange(gamma + 1, device=dev)
    toks = gen_tokens[:gamma + 1]
    tok_c = toks.clamp(0, vocab - 1)
    q_sel = gen_probs[pos, tok_c]
    p_sel = p_all[pos, tok_c]
    if force_accept is None:
        accept_v = u["coins"] < (p_sel / q_sel.clamp_min(1e-37)).clamp(max=1.0)
    else:
        accept_v = u["coins"] < force_accept
    # the walk stops at the first rejection OR the first ACCEPTED EOS
    stop_v = (pos < gamma2) & (~accept_v | (accept_v & _is_eos(toks, eos)))
    any_stop = stop_v.any()
    j_stop = torch.argmax(stop_v.to(torch.int32)).to(torch.int64)
    stop_acc = _row(accept_v, j_stop)
    count = torch.where(any_stop, j_stop + stop_acc.long(), gamma2)
    rejected = any_stop & ~stop_acc
    bonus = count == gamma2
    res = sampling.sample_u(sampling.max_fn(_row(p_all, j_stop)
                                            - _row(gen_probs, j_stop)),
                            u["res"])
    bonus_tok = sampling.sample_u(_row(p_all, gamma2), u["bonus"])
    pred = torch.where(bonus, bonus_tok,
                       torch.where(rejected, res, _row(toks, j_stop)))
    has_final = rejected | bonus
    # EOS on any emitting path: accepted proposal, residual, bonus
    eos_acc = any_stop & stop_acc
    eos_hit = eos_acc | (has_final & _is_eos(pred, eos))

    # --- rollback + retrieval tail refresh: keep old + count + 1 slots.
    # An accepted EOS with no resample/bonus stays the next token, so it
    # keeps one slot fewer (next_token is never in kv).
    keep = count + 1 - (eos_acc & ~has_final).long()
    seq_len = (old + keep).to(old.dtype)
    retrieval_tail_refresh(state.rkv, _kv_at(state.kv, seq_len), sp,
                           eng.prefill, old,
                           mesh=eng.mesh if eng.shard_seq else None)

    pos2 = torch.arange(gamma + 2, device=dev)
    emitted = torch.where(
        pos2 < count, gen_tokens[pos2.clamp(max=gamma)],
        torch.where((pos2 == count) & has_final, pred, JUNK_TOKEN))
    if has_draft:
        ppos = torch.arange(gamma + 3, device=dev)
        pass_tokens = torch.where(
            ppos == 0, state.next_token[:1],
            torch.where(ppos <= count, gen_tokens[(ppos - 1).clamp(0, gamma)],
                        torch.where((ppos == count + 1) & has_final, pred,
                                    JUNK_TOKEN)))
        with eng.graphs.region("draft"):
            llama.draft_forward_spec(eng.draft_cfg, eng.d_params,
                                     pass_tokens[None], state.dkv, sp)
        # the reference's count includes the bonus but NOT a resample — it
        # drops the last accepted token from the window on rejection
        streaming_evict_for_spec(state.dkv, sp, count + bonus.long())
    return dict(tokens=emitted, n_emitted=count + has_final.long(),
                accepted=count, gamma2=gamma2, resampled=rejected.long(),
                bonus=bonus.long(), eos=eos_hit, seq_len=seq_len,
                next_token=pred.reshape(1), gen_tokens=gen_tokens,
                gen_probs=gen_probs, p_all=p_all)


def _triforce_body(eng: Engine, state: TriForceState, u,
                   force_accept=None) -> dict:
    """One full TriForce outer iteration: middle loop, then the outer
    verify and commit."""
    mid = _middle_spec(eng, state, u, force_accept)
    out = _verify_and_commit(eng, state, u, mid["n"], mid["gen_tokens"],
                             mid["gen_probs"], True, force_accept)
    out.update(mid_draft=mid["mid_draft"], mid_accept=mid["mid_accept"],
               mid_verify=mid["trips"], mid_live=mid["live_trips"])
    return out


def _retrieval_body(eng: Engine, state: TriForceState, u,
                    force_accept=None) -> dict:
    """Self-speculation step: the middle model (target weights over the
    retrieval cache) drafts gamma tokens autoregressively, then the
    full-cache target verifies them."""
    t_cfg, sp = eng.target_cfg, eng.spec
    gamma = sp.gamma
    dev = state.next_token.device
    verify_tokens = torch.full((1, gamma + 1), JUNK_TOKEN, dtype=torch.int64,
                               device=dev)
    verify_tokens[0, :1] = state.next_token[:1]
    gen_tokens = torch.full((gamma + 1,), JUNK_TOKEN, dtype=torch.int64,
                            device=dev)
    gen_probs = torch.zeros((gamma + 1, t_cfg.vocab_size),
                            dtype=torch.float32, device=dev)
    for n in range(gamma):
        with eng.counting("middle"):
            m_logits, _ = llama.forward_spec(
                t_cfg, eng.t_params, verify_tokens, state.rkv,
                state.kv.seq_len, sp.budget, commit=False,
                act_quant=sp.mid_act_quant, mesh=eng.mesh, ring=state.kv)
        p_n = sampling.norm_logits(m_logits[0, n][None], sp.temperature,
                                   -1, sp.top_p)[0]
        tok = sampling.sample_u(p_n, u["mid"][n])
        gen_tokens[n] = tok
        gen_probs[n] = p_n
        verify_tokens[0, n + 1] = tok
    out = _verify_and_commit(eng, state, u, gamma, gen_tokens, gen_probs,
                             False, force_accept)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    out.update(mid_draft=zero, mid_accept=zero, mid_verify=zero + gamma,
               mid_live=zero + gamma)
    return out


_BODIES = {"triforce": _triforce_body, "retrieval": _retrieval_body}
# a step's counts, in ``Engine.generate``'s counter order after the steps
_COUNTS = ("accepted", "gamma2", "resampled", "bonus", "mid_draft",
           "mid_accept", "mid_verify", "mid_live")


def _counts_of(out: dict) -> torch.Tensor:
    """[n_emitted, the ``_COUNTS``, eos] of a step, one int64 vector (a
    batched step's: one per row, [B, 10])."""
    return torch.stack([out["n_emitted"]] + [out[k] for k in _COUNTS]
                       + [out["eos"]], -1).to(torch.int64)


def _step(eng: Engine, state: TriForceState, mode: str, force_accept=None,
          return_probs=False):
    """One step of ``mode`` as one graph region (its conditional bodies
    if-nodes once captured), then one read-back of its counts: the single
    step a caller drives itself (``Engine._step_fn``). ``return_probs``:
    also return ``(gen_tokens, gen_probs, p_all)``, the step's real middle
    (q) and target (p) distribution rows, for acceptance measurement
    (``profiling.measure_acceptance_vector``)."""
    body = _BODIES[mode]
    parts = _draw_parts(eng.spec, eng.target_cfg.vocab_size, mode)
    gen = state.gen

    def region(next_token, seq_len):
        u = _draws(parts, gen, next_token.device)
        with eng.graphs.region("step"):
            o = body(eng, dataclasses.replace(
                state, kv=_kv_at(state.kv, seq_len), next_token=next_token),
                u, force_accept)
        out = (o["tokens"], _counts_of(o), o["seq_len"], o["next_token"])
        if return_probs:
            out += (o["gen_tokens"], o["gen_probs"], o["p_all"])
        return out

    out = eng.graphs.run(mode, region, (state.next_token, state.kv.seq_len),
                         caches=graphs_mod.planes(state.kv, state.rkv,
                                                  state.dkv),
                         gens=(gen,), extra=(force_accept, return_probs))
    c = eng.graphs.read(out[1]).tolist()          # the step's read-back
    new_state = dataclasses.replace(state, kv=_kv_at(state.kv, out[2]),
                                    next_token=out[3])
    stats = StepStats(tokens=out[0], n_emitted=c[0], accepted=c[1],
                      gamma2=c[2], resampled=c[3], bonus=c[4],
                      eos=out[1][9] != 0, mid_draft=c[5], mid_accept=c[6],
                      mid_verify=c[7], mid_live=c[8])
    if return_probs:
        return new_state, stats, tuple(out[4:])
    return new_state, stats


def _triforce_step(eng: Engine, state: TriForceState, force_accept=None):
    """One TriForce step (``_step``)."""
    return _step(eng, state, "triforce", force_accept)


def _retrieval_spec_step(eng: Engine, state: TriForceState,
                         force_accept=None, return_probs=False):
    """One self-speculation step (``_step``); with ``return_probs`` it
    returns (state, stats, (tokens, q, p))."""
    return _step(eng, state, "retrieval", force_accept, return_probs)


# ---------------------------------------------------------------------------
# The batched steps: B rows of a StackedState at once
# ---------------------------------------------------------------------------
#
# The batch-1 step with a leading row axis, as the JAX package vmaps it
# (``triforce_tpu/batched_spec.py``): every count is a [B] device tensor,
# every per-row choice a ``torch.where``, and the lockstep middle trips and
# their drafter forwards are conditional bodies on "any row still needs
# it". A row that does not need a trip or a forward rides along masked, as
# a vmapped ``while_loop`` runs a finished row's body and keeps its state.


def _middle_spec_rows(eng: Engine, state: StackedState, u,
                      force_accept=None) -> dict:
    """``_middle_spec`` for every row at once. The trips run in lockstep:
    trip t is a conditional body while any row has fewer than gamma
    proposals (or runs for each of ``middle_trips`` trips); a row that is
    done rides along drafting nothing, with a zero-column retrieval read,
    and counts nothing that its batch-1 run would not (in the open-ended
    loop a finished row takes no part: no count). Drafter forward i of a
    trip is a conditional body while any row takes proposal i. Lockstep
    trip t uses each row's trip-t uniforms of ``u`` (``_draws`` of every
    row's generator), as the row's batch-1 trip t does. Returns [B] device
    counts (``trips``, the lockstep trips run, 0-d)."""
    t_cfg, d_cfg, sp = eng.target_cfg, eng.draft_cfg, eng.spec
    gamma, k, vocab = sp.gamma, _chain_len(sp), t_cfg.vocab_size
    dev = state.next_token.device
    cond, region = eng.graphs.cond, eng.graphs.region
    rows = state.rows
    fixed = sp.middle_trips > 0
    kv_len = state.kv.seq_len
    i64 = dict(dtype=torch.int64, device=dev)
    gen_tokens = torch.full((rows, gamma + 1), JUNK_TOKEN, **i64)
    gen_probs = torch.zeros((rows, gamma + 1, vocab), dtype=torch.float32,
                            device=dev)
    c = {name: torch.zeros((rows,), **i64)
         for name in ("n", "mid_draft", "mid_accept", "row_trips",
                      "live_trips")}
    c["trips"] = torch.zeros((), **i64)
    pos = torch.arange(gamma + 1, device=dev)
    js = torch.arange(k, device=dev)
    ar = torch.arange(rows, device=dev)

    def trip(t):
        n0 = c["n"].clone()
        live = n0 < gamma
        vt = torch.cat([state.next_token[:, None], gen_tokens[:, :gamma]], 1)
        chain_toks = torch.full((rows, k), JUNK_TOKEN, **i64)
        chain_q = torch.zeros((rows, k), dtype=torch.float32, device=dev)

        def draft(i):
            # the drafter at its fixed width gamma+1 for every row; row b
            # takes proposal i, sampled from its row n0[b] + i, while
            # n0[b] + i stays under the gamma-1 cap
            with region("draft"):
                d_logits, _ = llama.draft_forward_spec_rows(
                    d_cfg, eng.d_params, vt, state.dkv, sp, commit=False)
                q = sampling.norm_logits(
                    d_logits[ar, (n0 + i).clamp(max=gamma)],
                    sp.temperature, -1, sp.top_p)                 # [B, V]
                tok = sampling.sample_u(q, u["drafts"][:, t, i])
                act = n0 + i <= gamma - 1
                chain_toks[:, i] = torch.where(act, tok, chain_toks[:, i])
                chain_q[:, i] = torch.where(
                    act, q.gather(1, tok[:, None])[:, 0], chain_q[:, i])
                at = (n0 + i + 1).clamp(max=gamma)[:, None]
                vt.scatter_(1, at, torch.where(act[:, None], tok[:, None],
                                               vt.gather(1, at)))

        for i in range(k):
            cond((n0 + i <= gamma - 1).any(), functools.partial(draft, i))
        i_fin = (gamma - n0).clamp(0, k)       # the proposals each row took
        # --- ONE middle verify over every row's chain (read-only rkv)
        with region("middle"):
            m_logits = llama.forward_spec_rows(
                t_cfg, eng.t_params, vt, state.rkv,
                torch.where(live, kv_len, torch.zeros_like(kv_len)),
                sp.budget, act_quant=sp.mid_act_quant, mesh=eng.mesh)
        rows_idx = (n0[:, None] + torch.arange(k + 1, device=dev)).clamp(
            0, gamma)
        p_rows = sampling.norm_logits(m_logits[ar[:, None], rows_idx],
                                      sp.temperature, -1,
                                      sp.top_p)              # [B, k+1, V]
        # --- accept walk, all rows' coins at once
        rs = u["mid_coins"][:, t]
        if force_accept is None:
            p_tok = p_rows[:, :k].gather(
                2, chain_toks.clamp(0, vocab - 1)[..., None])[..., 0]
            ok_v = rs < (p_tok / chain_q.clamp_min(1e-37)).clamp(max=1.0)
        else:
            ok_v = rs < force_accept
        rej_v = (js[None, :] < i_fin[:, None]) & ~ok_v
        any_rej = rej_v.any(1)
        j_rej = torch.argmax(rej_v.to(torch.int32), 1)
        used = torch.where(any_rej, j_rej + 1, i_fin)     # proposals taken
        # reject: sample from that position's middle distribution
        res = sampling.sample_u(p_rows[ar, j_rej], u["mid_res"][:, t])
        final = torch.where((js[None, :] == j_rej[:, None])
                            & any_rej[:, None], res[:, None], chain_toks)
        # commit positions [n0, n0 + used) of each row: tokens and their
        # middle rows (the q the OUTER test consumes)
        jj = pos[None, :] - n0[:, None]
        sel = (jj >= 0) & (jj < used[:, None])
        jc = jj.clamp(0, k - 1)
        gen_tokens.copy_(torch.where(sel, final.gather(1, jc), gen_tokens))
        gen_probs.copy_(torch.where(sel[..., None], p_rows[ar[:, None], jc],
                                    gen_probs))
        n = n0 + used
        # --- bonus on a fully accepted chain: sample from the middle row
        # after the last accepted token
        bonus = ~any_rej & (n <= gamma) & live
        b_row = p_rows[ar, used.clamp(0, k)]
        b_tok = sampling.sample_u(b_row, u["mid_bonus"][:, t])
        at = (pos[None, :] == n[:, None]) & bonus[:, None]
        gen_tokens.copy_(torch.where(at, b_tok[:, None], gen_tokens))
        gen_probs.copy_(torch.where(at[..., None], b_row[:, None], gen_probs))
        c["n"].copy_(n + bonus.long())
        c["mid_accept"].add_(used - any_rej.long())
        c["mid_draft"].add_(used)
        c["row_trips"].add_(torch.ones_like(n0) if fixed else live.long())
        c["live_trips"].add_(live.long())
        c["trips"].add_(1)

    for t in range(_trip_slots(sp)):
        if fixed:
            trip(t)
        else:
            cond((c["n"] < gamma).any(), functools.partial(trip, t))
    return dict(c, gen_tokens=gen_tokens, gen_probs=gen_probs)


def _outer_verify_and_commit_rows(eng: Engine, state: StackedState, u,
                                  gamma2, gen_tokens, gen_probs,
                                  has_draft: bool, force_accept=None) -> dict:
    """``_verify_and_commit`` for every row at once, on the device: one
    gamma+2-token forward over all rows' full caches (read only), every
    row's accept tests, the residual and the bonus both sampled and chosen
    between per row, then the rollback, the commit and retrieval tail
    refresh (``batched_commit_and_refresh``) and, with a drafter, the
    replay and window compaction, all at device offsets. ``gamma2`` [B]
    counts each row's proposals. A row whose pre-step length is 0 stays at
    0. Returns the emitted tokens [B, gamma+2], [B] counts, the new kv
    length and next token."""
    t_cfg, sp = eng.target_cfg, eng.spec
    gamma = sp.gamma
    dev = gen_tokens.device
    old = state.kv.seq_len
    ar = torch.arange(state.rows, device=dev)

    verify_in = torch.cat([state.next_token[:, None], gen_tokens], 1)
    with eng.graphs.region("verify"):
        logits, nk, nv = llama.forward_append_rows(
            t_cfg, eng.t_params, verify_in, state.kv, **eng.fwd)
    p_all = sampling.norm_logits(logits, sp.temperature, sp.top_k,
                                 sp.top_p)                # [B, gamma+2, V]

    pos = torch.arange(gamma + 1, device=dev)
    tok_c = gen_tokens.clamp(0, t_cfg.vocab_size - 1)[..., None]
    q_sel = gen_probs.gather(2, tok_c)[..., 0]
    p_sel = p_all[:, :gamma + 1].gather(2, tok_c)[..., 0]
    rs = u["coins"]
    if force_accept is None:
        accept_v = rs < (p_sel / q_sel.clamp_min(1e-37)).clamp(max=1.0)
    else:
        accept_v = rs < force_accept
    # the walk stops at the first rejection OR the first ACCEPTED EOS
    stop_v = (pos[None, :] < gamma2[:, None]) & (
        ~accept_v | (accept_v & _is_eos(gen_tokens, eng.eos_token_id)))
    any_stop = stop_v.any(1)
    j_stop = torch.argmax(stop_v.to(torch.int32), 1)
    stop_acc = accept_v[ar, j_stop]
    count = torch.where(any_stop, j_stop + stop_acc.long(), gamma2)
    rejected = any_stop & ~stop_acc
    eos_acc = any_stop & stop_acc
    bonus = count == gamma2
    has_final = rejected | bonus

    # every row samples the residual at its stop and the target row after
    # its last proposal; bonus rows take the second, rejected rows the
    # first, the rest keep the accepted EOS (as the batch-1 step)
    res = sampling.sample_u(sampling.max_fn(p_all[ar, j_stop]
                                            - gen_probs[ar, j_stop]),
                            u["res"])
    b_tok = sampling.sample_u(p_all[ar, gamma2], u["bonus"])
    pred = torch.where(bonus, b_tok,
                       torch.where(rejected, res, gen_tokens[ar, j_stop]))
    eos_hit = eos_acc | (has_final & _is_eos(pred, eng.eos_token_id))

    # --- rollback + commit + retrieval tail refresh: row b keeps old +
    # count + 1 slots, one fewer when an accepted EOS stays its next token
    keep = count + 1 - (eos_acc & ~has_final).long()
    kv = _kv_at(state.kv, (old + keep).to(old.dtype))
    kv, _ = batched_commit_and_refresh(
        kv, state.rkv, nk, nv, old, sp, eng.prefill,
        mesh=eng.mesh if eng.shard_seq else None)
    # dead-slot freeze: a row that started the step empty stays empty
    seq_len = torch.where(old == 0, torch.zeros_like(old), kv.seq_len)

    pos2 = torch.arange(gamma + 2, device=dev)[None, :]
    emitted = torch.where(
        pos2 < count[:, None], gen_tokens[:, pos2[0].clamp(max=gamma)],
        torch.where((pos2 == count[:, None]) & has_final[:, None],
                    pred[:, None], JUNK_TOKEN))

    if has_draft:
        ppos = torch.arange(gamma + 3, device=dev)[None, :]
        pass_tokens = torch.where(
            ppos == 0, state.next_token[:, None],
            torch.where(ppos <= count[:, None],
                        gen_tokens[:, (ppos[0] - 1).clamp(0, gamma)],
                        torch.where((ppos == count[:, None] + 1)
                                    & has_final[:, None], pred[:, None],
                                    JUNK_TOKEN)))
        with eng.graphs.region("draft"):
            llama.draft_forward_spec_rows(eng.draft_cfg, eng.d_params,
                                          pass_tokens, state.dkv, sp)
        # the reference's count includes the bonus but NOT a resample
        streaming_evict_for_spec_rows(state.dkv, sp, count + bonus.long())
    return dict(tokens=emitted, n_emitted=count + has_final.long(),
                accepted=count, gamma2=gamma2, resampled=rejected.long(),
                bonus=bonus.long(), eos=eos_hit, seq_len=seq_len,
                next_token=pred)


def triforce_step_rows(eng: Engine, state: StackedState, u,
                       force_accept=None) -> dict:
    """One full TriForce outer iteration for every row of ``state`` on the
    rows' uniforms ``u`` (``_draws`` of ``state.gens``): the lockstep
    middle loop, then the outer verify and commit. Returns [B] device
    counts (``_counts_of``), the emitted tokens, the new kv length and next
    token, and ``target_forwards`` (0-d: the lockstep trips + 1)."""
    mid = _middle_spec_rows(eng, state, u, force_accept)
    out = _outer_verify_and_commit_rows(eng, state, u, mid["n"],
                                        mid["gen_tokens"], mid["gen_probs"],
                                        True, force_accept)
    out.update(mid_draft=mid["mid_draft"], mid_accept=mid["mid_accept"],
               mid_verify=mid["row_trips"], mid_live=mid["live_trips"],
               target_forwards=mid["trips"] + 1)
    return out


def retrieval_spec_step_rows(eng: Engine, state: StackedState, u,
                             force_accept=None) -> dict:
    """Self-speculation step for every row of ``state``: gamma middle
    forwards over all rows' retrieval caches, then the full-cache verify
    (``triforce_step_rows``' outputs)."""
    t_cfg, sp = eng.target_cfg, eng.spec
    gamma = sp.gamma
    dev = state.next_token.device
    rows = state.rows
    i64 = dict(dtype=torch.int64, device=dev)
    verify_tokens = torch.full((rows, gamma + 1), JUNK_TOKEN, **i64)
    verify_tokens[:, 0] = state.next_token
    gen_tokens = torch.full((rows, gamma + 1), JUNK_TOKEN, **i64)
    gen_probs = torch.zeros((rows, gamma + 1, t_cfg.vocab_size),
                            dtype=torch.float32, device=dev)
    for n in range(gamma):
        m_logits = llama.forward_spec_rows(
            t_cfg, eng.t_params, verify_tokens, state.rkv, state.kv.seq_len,
            sp.budget, act_quant=sp.mid_act_quant, mesh=eng.mesh)
        p_n = sampling.norm_logits(m_logits[:, n], sp.temperature, -1,
                                   sp.top_p)
        tok = sampling.sample_u(p_n, u["mid"][:, n])
        gen_tokens[:, n] = tok
        gen_probs[:, n] = p_n
        verify_tokens[:, n + 1] = tok
    out = _outer_verify_and_commit_rows(
        eng, state, u, torch.full((rows,), gamma, **i64), gen_tokens,
        gen_probs, False, force_accept)
    zero = torch.zeros((rows,), **i64)
    out.update(mid_draft=zero, mid_accept=zero, mid_verify=zero + gamma,
               mid_live=zero + gamma,
               target_forwards=torch.full((), gamma + 1, **i64))
    return out


_ROWS_BODIES = {"triforce": triforce_step_rows,
                "retrieval": retrieval_spec_step_rows}


def decode_rows(eng: Engine, state: StackedState, mode: str, steps: int,
                force_accept=None, mesh: Optional[Mesh] = None):
    """``steps`` batched steps of ``mode`` on the device, as the JAX
    package's ``_decode_fused`` (``triforce_tpu/batched_spec.py:37-64``, a
    ``fori_loop`` over the vmapped step): ``steps`` calls of one loop
    region of ``eng.graphs`` (captured at its first call, then replayed)
    that draws every row's uniforms and runs the step, writing its tokens
    and per-row counts at the device step index ``at`` and leaving the kv
    length and the next token in place (``GraphSet.buffers``: the pool's
    are copied in at the top of the call, so a slot written or gated
    between calls lands, and out at its end). A batched step always runs,
    as a ``fori_loop``'s body does. One read-back, at the end: the
    tokens, the counts and the target forwards (with the bodies' launch
    counts, ``GraphSet.read``). Returns (state, tokens [B, steps, gamma+2],
    counts [B, steps, 10] in ``_counts_of``'s order, target forwards),
    the last three on the host (``BatchedSpecEngine`` checks ``mode``).

    ``mesh``: ``state`` holds this rank's block of the rows split over the
    mesh's ``dp`` axis (``sharding.row_block``); after the loop its tokens
    and counts go into the global [B, ...] on every rank by one collective
    over ``dp`` (``mesh.gather_rows``, outside the loop region, so a step
    that issues no collective of its own is captured even over gloo), then
    the one read-back. The target forwards are this rank's."""
    dev, g = eng.device, eng.graphs
    rows, gamma = state.rows, eng.spec.gamma
    ncount = len(_COUNTS) + 2
    name = "rows " + mode
    caches = graphs_mod.planes(state.kv, state.rkv, state.dkv)
    i64 = dict(dtype=torch.int64, device=dev)
    lb = g.buffers(name, caches, lambda: dict(
        tokens=torch.empty((rows, steps, gamma + 2), **i64),
        counts=torch.empty((rows, steps, ncount), **i64),
        at=torch.empty((1,), **i64),
        forwards=torch.empty((1,), **i64),
        seq_len=torch.empty_like(state.kv.seq_len),
        next_token=torch.empty_like(state.next_token)), extra=(steps,))
    lb["tokens"].fill_(JUNK_TOKEN)
    lb["counts"].zero_()
    lb["at"].zero_()
    lb["forwards"].zero_()
    lb["seq_len"].copy_(state.kv.seq_len)
    lb["next_token"].copy_(state.next_token)
    body = _ROWS_BODIES[mode]
    parts = _draw_parts(eng.spec, eng.target_cfg.vocab_size, mode)
    gens = tuple(state.gens)
    st = dataclasses.replace(state, kv=_kv_at(state.kv, lb["seq_len"]),
                             next_token=lb["next_token"])

    def region():
        with g.region("step"):
            o = body(eng, st, _draws(parts, gens, dev), force_accept)
            lb["tokens"].index_copy_(1, lb["at"], o["tokens"][:, None])
            lb["counts"].index_copy_(1, lb["at"], _counts_of(o)[:, None])
            lb["forwards"].add_(o["target_forwards"])
            lb["seq_len"].copy_(o["seq_len"])
            lb["next_token"].copy_(o["next_token"])
            lb["at"].add_(1)
        return ()

    with profiling.span("generate"):
        for _ in range(steps):
            g.run(name, region, (), caches=caches + tuple(lb.values()),
                  gens=gens, extra=(force_accept, steps), capture_first=True)
        nt = steps * (gamma + 2)
        out = torch.cat([lb["tokens"].reshape(rows, -1),
                         lb["counts"].reshape(rows, -1),
                         lb["forwards"].expand(rows, 1)], 1)
        mine = 0
        if mesh is not None:
            mine = mesh.index("dp") * rows
            rows *= mesh.shape["dp"]
            out = gather_rows(mesh, out, rows)
        with profiling.span("readback"):
            host = g.read(out)                          # the read-back
    profiling.count("steps", steps)
    state = dataclasses.replace(
        state, kv=_kv_at(state.kv, lb["seq_len"].clone()),
        next_token=lb["next_token"].clone())
    return (state, host[:, :nt].reshape(rows, steps, gamma + 2),
            host[:, nt:-1].reshape(rows, steps, ncount),
            int(host[mine, -1]))
