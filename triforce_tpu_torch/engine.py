"""Execution engine — the port of ``triforce_tpu/engine.py``.

The JAX engine compiles each whole speculation round (and whole
generations) into one XLA program with ``lax.while_loop``s. In eager
PyTorch those loops are host loops that launch device work and read back
only what the control flow needs:

  * the middle (drafter <-> retrieval-cache) loop reads its accept outcome
    once per trip (``middle_trips=0`` loops until gamma proposals);
  * the outer verify reads its accept outcome once per step;
  * the autoregressive loop reads nothing until the end.

Random draws come from the state's ``torch.Generator``. The caches are
updated in place (see ``cache.py``); a state is not reusable after a step
unless it was cloned first (``TriForceState.clone``).

On a CUDA device every forward of the decode path, with the sampling
that needs no host decision, runs as the replay of a captured CUDA graph
(``graphs.py``, where the JAX engine runs its jitted programs): the AR
step whole; the retrieval step's gamma middle forwards with the target
verify up to the outer read-back; in the TriForce step the drafter
forward, the middle verify, the target verify and the drafter replay. The
host loops, their read-backs and what follows a read-back (rollback,
tail refresh, window compaction: they take host counts) stay eager.
The prefills are graphed too (``append_graphed``, ``prefill_chunks``):
each target chunk width is one region, the retrieval build (the last
prompt token's forward) another, each drafter chunk width (the window
slide and the forward) a third; so the JAX package's prefill scans and
its build jit become one graph per width, replayed chunk after chunk.
The first-token sample stays eager, outside the build, as in the JAX
package. ``Engine(graphs=False)`` runs every region eagerly (the witness
a graphed run is held against); the CPU never captures.

The batched steps (``triforce_step_rows``, ``retrieval_spec_step_rows``)
run the same step for B rows of a ``StackedState`` at once: every forward
runs once for all rows, where the JAX package vmaps its batch-1 step. The
control flow stays on the host, per row, but one read-back serves all rows:
one vector per middle trip and one per outer verify. Each row owns a
generator and draws from it exactly what the batch-1 step would draw, in
the same order, so a batched row emits what its batch-1 run with the same
seed emits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import graphs as graphs_mod
from .cache import (KVCache, RetrievalCache, StreamingCache,
                    batched_commit_and_refresh, init_kv, init_retrieval,
                    init_streaming, retrieval_tail_refresh,
                    streaming_evict_for_spec, streaming_evict_for_spec_rows,
                    streaming_evict_prefill)
from .config import ModelConfig, SpecConfig, resolve_device
from .models import llama
from .ops import sampling

JUNK_TOKEN = 100  # the reference pads spec buffers with token id 100


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
    """Per-step outputs: ``tokens`` stays on the device; the counts are
    host ints (the step read them back to drive its control flow)."""
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
    """Per-step outputs of a batched step, a leading row axis on each:
    ``tokens`` and ``eos`` stay on the device, the counts are host arrays
    (the step read them back to drive its control flow)."""
    tokens: torch.Tensor      # [B, gamma + 2] emitted tokens, junk-padded
    n_emitted: np.ndarray     # [B]
    gamma2: np.ndarray
    accepted: np.ndarray
    resampled: np.ndarray
    bonus: np.ndarray
    eos: torch.Tensor         # [B] bool (device)
    mid_draft: np.ndarray
    mid_accept: np.ndarray
    mid_verify: np.ndarray    # middle verifies each row took part in
    mid_live: np.ndarray      # ... that read its retrieval cache
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
    them, and the prefill's converted weights with them."""

    def __init__(self, target_cfg: ModelConfig, spec: SpecConfig,
                 target_params, *, draft_cfg: Optional[ModelConfig] = None,
                 draft_params=None, prefill: int, max_cache_len: int,
                 eos_token_id: int = 2, dtype=torch.bfloat16,
                 prefill_chunk: int = 512, draft_prefill_chunk: int = 64,
                 kv_quant: bool = False, weight_quant: bool = False,
                 mesh=None, device=None, graphs=None):
        if mesh is not None:
            raise NotImplementedError("sharding over a mesh is not ported "
                                      "yet")
        if prefill % spec.chunk_size:
            raise ValueError("prefill must be a multiple of chunk_size")
        self.device = resolve_device(device)
        self.graphs = graphs_mod.GraphSet(self.device, graphs)
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
        if weight_quant:
            target_params = llama.quantize_weights(target_params)
            if draft_params is not None:
                draft_params = llama.quantize_weights(draft_params)
        self.t_params = target_params
        self.d_params = draft_params
        self._dense = None     # the prefill's converted weights (graphed)

    # ------------------------------------------------------------------
    # state construction / prefill
    # ------------------------------------------------------------------

    def init_state(self, seed: int) -> TriForceState:
        dev = self.device
        kv = init_kv(self.target_cfg, self.max_cache_len, 1, self.dtype,
                     device=dev, quant=self.kv_quant)
        rkv = init_retrieval(self.target_cfg, self.spec, 1, self.dtype,
                             device=dev, quant=self.kv_quant)
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
        return prefill_chunks(self.graphs, self.target_cfg,
                              dense_weights(self, self.t_params), kv, body,
                              self.prefill_chunk)

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
        return append_graphed(self.graphs, self.target_cfg, self.t_params,
                              kv, last, build_rkv=rkv, prefill=self.prefill,
                              chunk_size=sp.chunk_size, budget=sp.budget)

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
        c = self.prefill_chunk
        body = input_ids[:, :-1]
        n = min(max_chunks, (body.shape[1] - pos) // c)
        stop = pos + n * c
        if n < max_chunks and stop < body.shape[1]:
            stop = body.shape[1]   # the remainder fits in the same slice
        kv = state.kv
        if stop > pos:
            # whole chunks, then the remainder (if any) as prefill_body's
            kv = self.prefill_body(kv, body[:, pos:stop])
        if stop < body.shape[1]:
            return dataclasses.replace(state, kv=kv), stop, False
        return (self._build_and_sample(state, kv, input_ids), self.prefill,
                True)

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
                dataclasses.replace(kv, seq_len=seq_len))
            return self._sample_next(logits, gen), kv_out.seq_len

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

    def _gen(self, step_fn, max_len: int, stop_on_eos: bool,
             state: TriForceState):
        slack = self.spec.gamma + 2
        buf = torch.full((max_len + slack,), JUNK_TOKEN, dtype=torch.int64,
                         device=self.device)
        buf[0] = state.next_token[0]
        n = 1
        counters = np.zeros(9, np.int64)
        while n < max_len + 1:
            state, st = step_fn(state)
            buf[n:n + slack] = st.tokens
            n += st.n_emitted
            counters += [1, st.accepted, st.gamma2, st.resampled, st.bonus,
                         st.mid_draft, st.mid_accept, st.mid_verify,
                         st.mid_live]
            if stop_on_eos and bool(st.eos):
                break
        return state, buf, n, counters

    def generate(self, state: TriForceState, max_len: int,
                 mode: str = "triforce", stop_on_eos: bool = False):
        """Speculative generation until ``max_len`` tokens past the first.
        Returns (state, token_buf, n, counters) with counters = [steps,
        accepted, proposed, resampled, bonus, mid_draft, mid_accept,
        mid_verify, mid_live]."""
        return self._gen(self._step_fn(mode, None), max_len, stop_on_eos,
                         state)

    def generate_forced(self, state: TriForceState, max_len: int,
                        alpha: float, mode: str = "retrieval",
                        stop_on_eos: bool = False):
        """Controlled-acceptance generation: every accept test becomes a
        coin flip at rate ``alpha`` while all real compute runs (drafter
        forwards, middle verifies, full-cache verify, rollback, tail
        refresh). The output is NOT target-distributed."""
        return self._gen(self._step_fn(mode, alpha), max_len, stop_on_eos,
                         state)

    def _step_fn(self, mode: str, force_accept):
        if mode == "triforce":
            if self.draft_cfg is None:
                raise ValueError("triforce mode needs a drafter")
            return lambda s: _triforce_step(self, s, force_accept)
        if mode == "retrieval":
            return lambda s: _retrieval_spec_step(self, s, force_accept)
        raise ValueError(mode)


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
                   prefill: int = 0, chunk_size: int = 8, budget: int = 0):
    """``llama.forward_append`` of ``ids`` into ``kv`` as one region of
    ``graphs`` ("build" with ``build_rkv``, else "prefill"): its inputs are
    ``(ids, kv.seq_len)``, its key holds the planes of ``kv`` and
    ``build_rkv`` and every tensor of ``params`` (``param_planes``), and
    ``need_logits`` and the build's sizes are its ``extra``. So one graph
    serves every chunk of a width (the kernels plan from shapes and read
    ``k_len`` on the device). Returns (logits or None, kv at its new
    length)."""
    def region(ids, seq_len):
        logits, out, _ = llama.forward_append(
            cfg, params, ids, _kv_at(kv, seq_len), build_rkv=build_rkv,
            prefill=prefill, chunk_size=chunk_size, budget=budget,
            need_logits=need_logits)
        return (logits, out.seq_len) if need_logits else (out.seq_len,)

    out = graphs.run("build" if build_rkv is not None else "prefill",
                     region, (ids, kv.seq_len),
                     caches=graphs_mod.planes(kv, build_rkv)
                     + param_planes(params),
                     extra=(need_logits, prefill, chunk_size, budget))
    return (out[0] if need_logits else None), _kv_at(kv, out[-1])


def prefill_chunks(graphs: graphs_mod.GraphSet, cfg: ModelConfig, params,
                   kv: KVCache, body: torch.Tensor, chunk: int) -> KVCache:
    """Prefill of ``body`` [1, P] into ``kv`` in ``chunk``-token forwards
    (the last one ragged), no logits, each through ``append_graphed``: the
    full chunks replay one graph, the remainder is a key of its own."""
    for s in range(0, body.shape[1], chunk):
        _, kv = append_graphed(graphs, cfg, params, kv,
                               body[:, s:s + chunk], need_logits=False)
    return kv


# ---------------------------------------------------------------------------
# The TriForce step
# ---------------------------------------------------------------------------


def _chain_len(sp: SpecConfig) -> int:
    gamma = sp.gamma
    return max(1, min(sp.middle_chain if sp.middle_chain > 0 else gamma,
                      gamma))


def _draft_region(eng: Engine, state: TriForceState):
    """The middle loop's drafter forward at its fixed width gamma+1 over
    ``vt`` [1, gamma+1], then the proposal sampled from row ``at``:
    returns (token [1], its drafter probability [1])."""
    d_cfg, sp, dkv, gen = eng.draft_cfg, eng.spec, state.dkv, state.gen

    def region(vt, at):
        d_logits, _ = llama.draft_forward_spec(d_cfg, eng.d_params, vt, dkv,
                                               sp, commit=False)
        q = sampling.norm_logits(d_logits[0].index_select(0, at.reshape(1)),
                                 sp.temperature, -1, sp.top_p)[0]
        tok = sampling.sample(q, gen).reshape(1)
        return tok, q.gather(0, tok)
    return region


def _mid_verify_region(eng: Engine, state: TriForceState, force_accept):
    """ONE middle verify (target weights over the read-only retrieval
    cache) of the chain in ``vt``, its filtered rows from ``n0`` and the
    chain's accept tests up to the trip's read-back: returns (p_rows
    [k+1, V], [any rejection, first rejection])."""
    t_cfg, sp = eng.target_cfg, eng.spec
    gamma, k, vocab = sp.gamma, _chain_len(sp), t_cfg.vocab_size
    rkv, gen = state.rkv, state.gen

    def region(vt, kv_len, n0, chain_toks, chain_q, i_fin):
        dev = vt.device
        m_logits, _ = llama.forward_spec(
            t_cfg, eng.t_params, vt, rkv, kv_len, sp.budget, commit=False,
            act_quant=sp.mid_act_quant)
        rows_idx = (n0 + torch.arange(k + 1, device=dev)).clamp(0, gamma)
        p_rows = sampling.norm_logits(m_logits[0].index_select(0, rows_idx),
                                      sp.temperature, -1, sp.top_p)
        # all per-proposal coins at once
        rs = torch.rand((k,), generator=gen, device=dev)
        js = torch.arange(k, device=dev)
        if force_accept is None:
            ratios = p_rows[js, chain_toks.clamp(0, vocab - 1)] \
                / chain_q.clamp_min(1e-37)
            ok_v = rs < ratios.clamp(max=1.0)
        else:
            ok_v = rs < force_accept
        rej_v = (js < i_fin) & ~ok_v
        return p_rows, torch.stack([rej_v.any().long(),
                                    torch.argmax(rej_v.to(torch.int32))])
    return region


def _middle_spec(eng: Engine, state: TriForceState, force_accept=None):
    """Drafter <-> middle speculation loop, generalized to drafter CHAINS
    of ``middle_chain`` tokens per middle verify: k drafter forwards propose
    a chain, ONE middle verify (target weights over the retrieval cache)
    scores every position, and the accept walk applies the per-proposal
    test in order; the first reject samples from that position's middle
    distribution and stops; a fully accepted chain earns a bonus token.

    ``middle_trips=0`` loops until gamma proposals; ``middle_trips>0`` runs
    that many trips, dead ones (n >= gamma) with a zero-column retrieval
    read. Each trip reads its outcome back once. The drafter forwards and
    the middle verify are graph regions; the rest is eager."""
    t_cfg, sp = eng.target_cfg, eng.spec
    gamma, k = sp.gamma, _chain_len(sp)
    dev = state.next_token.device
    gen = state.gen
    kv_seq_len = state.kv.seq_len
    gen_tokens = torch.full((gamma + 1,), JUNK_TOKEN, dtype=torch.int64,
                            device=dev)
    gen_probs = torch.zeros((gamma + 1, t_cfg.vocab_size),
                            dtype=torch.float32, device=dev)
    draft = _draft_region(eng, state)
    verify = _mid_verify_region(eng, state, force_accept)
    d_planes = graphs_mod.planes(state.dkv)
    r_planes = graphs_mod.planes(state.rkv)
    n = mid_draft = mid_accept = trips = live_trips = 0

    while (trips < sp.middle_trips) if sp.middle_trips > 0 else (n < gamma):
        n0 = n
        live = n0 < gamma
        # --- chain drafting: up to k drafter forwards, stopping at the
        # gamma-1 proposal cap
        vt = torch.cat([state.next_token[:1], gen_tokens[:gamma]])[None]
        chain_toks = torch.full((k,), JUNK_TOKEN, dtype=torch.int64,
                                device=dev)
        chain_q = torch.zeros((k,), dtype=torch.float32, device=dev)
        i_fin = 0
        while i_fin < k and n0 + i_fin <= gamma - 1:
            i = i_fin
            tok, q_tok = eng.graphs.run("draft", draft, (vt, n0 + i),
                                        caches=d_planes, gens=(gen,))
            chain_toks[i:i + 1] = tok
            chain_q[i:i + 1] = q_tok
            vt[0, n0 + i + 1:n0 + i + 2] = tok
            i_fin += 1

        # --- ONE middle verify over the whole chain (read-only rkv) and
        # its accept tests
        p_rows, outcome = eng.graphs.run(
            "mid_verify", verify,
            (vt, kv_seq_len if live else torch.zeros_like(kv_seq_len), n0,
             chain_toks, chain_q, i_fin),
            caches=r_planes, gens=(gen,), extra=(force_accept,))
        any_rej, j_rej = outcome.tolist()          # the trip's read-back
        used = j_rej + 1 if any_rej else i_fin          # proposals consumed

        final_toks = chain_toks
        if any_rej:
            # reject: sample from that position's middle distribution
            res = sampling.sample(p_rows[j_rej], gen)
            final_toks = chain_toks.clone()
            final_toks[j_rej] = res
        # commit consumed positions: tokens and their middle rows (the q
        # the OUTER test consumes, accepted and rejected positions alike)
        gen_tokens[n0:n0 + used] = final_toks[:used]
        gen_probs[n0:n0 + used] = p_rows[:used]
        n = n0 + used
        mid_accept += used - any_rej
        mid_draft += used

        # --- bonus on a fully accepted chain: sample from the middle row
        # after the last accepted token
        if not any_rej and n <= gamma and n0 < gamma:
            b_row = p_rows[min(max(n - n0, 0), k)]
            gen_tokens[n] = sampling.sample(b_row, gen)
            gen_probs[n] = b_row
            n += 1
        trips += 1
        live_trips += int(live)

    return {"n": n, "gen_tokens": gen_tokens, "gen_probs": gen_probs,
            "mid_draft": mid_draft, "mid_accept": mid_accept,
            "trips": trips, "live_trips": live_trips}


def _verify_body(eng: Engine, kv: KVCache, gen, next_token, gen_tokens,
                 gen_probs, gamma2, force_accept):
    """The target's full-cache verify of ``[next_token] + gen_tokens``
    (gamma+2 tokens, written into ``kv`` in place), the filtered target
    rows and every accept test, up to the outer read-back: returns (p_all
    [gamma+2, V], [any stop, first stop, accepted at it], kv length after
    the forward). ``gamma2`` (int or 0-d tensor) counts the proposals."""
    t_cfg, sp = eng.target_cfg, eng.spec
    gamma = sp.gamma
    dev = gen_tokens.device
    verify_in = torch.cat([next_token[:1], gen_tokens[:gamma + 1]])[None]
    logits, kv_out, _ = llama.forward_append(t_cfg, eng.t_params, verify_in,
                                             kv)
    p_all = sampling.norm_logits(logits[0], sp.temperature, sp.top_k,
                                 sp.top_p)                    # [gamma+2, V]
    pos = torch.arange(gamma + 1, device=dev)
    toks = gen_tokens[:gamma + 1]
    tok_c = toks.clamp(0, t_cfg.vocab_size - 1)
    q_sel = gen_probs[pos, tok_c]
    p_sel = p_all[pos, tok_c]
    rs = torch.rand((gamma + 1,), generator=gen, device=dev)
    if force_accept is None:
        accept_v = rs < (p_sel / q_sel.clamp_min(1e-37)).clamp(max=1.0)
    else:
        accept_v = rs < force_accept
    live = pos < gamma2
    # the walk stops at the first rejection OR the first ACCEPTED EOS
    stop_v = live & (~accept_v | (accept_v & _is_eos(toks, eng.eos_token_id)))
    j_stop_t = torch.argmax(stop_v.to(torch.int32)).reshape(1)
    outcome = torch.cat([stop_v.any().long().reshape(1), j_stop_t,
                         accept_v.gather(0, j_stop_t).long()])
    return p_all, outcome, kv_out.seq_len


def _verify_region(eng: Engine, state: TriForceState, force_accept):
    kv, gen = state.kv, state.gen

    def region(next_token, seq_len, gen_tokens, gen_probs, gamma2):
        return _verify_body(eng, _kv_at(kv, seq_len), gen, next_token,
                            gen_tokens, gen_probs, gamma2, force_accept)
    return region


def _outer_verify_and_commit(eng: Engine, state: TriForceState, gamma2: int,
                             gen_tokens, gen_probs, has_draft: bool,
                             force_accept=None, return_probs=False):
    """Target full-cache verify + exact rejection sampling + cache commit:
    one gamma+2-token forward, all accept tests at once (one graph region),
    one read-back of the outcome, then rollback, retrieval tail refresh and
    (with a drafter) the drafter replay and window compaction.

    ``return_probs``: also return ``(gen_tokens, gen_probs, p_all)``, the
    step's real middle (q) and target (p) distribution rows, for
    acceptance measurement (``profiling.measure_acceptance_vector``). The
    batched steps (``*_step_rows``) return no such payload."""
    p_all, outcome, seq_len = eng.graphs.run(
        "verify", _verify_region(eng, state, force_accept),
        (state.next_token, state.kv.seq_len, gen_tokens, gen_probs, gamma2),
        caches=graphs_mod.planes(state.kv), gens=(state.gen,),
        extra=(force_accept,))
    return _commit(eng, state, _kv_at(state.kv, seq_len), p_all, outcome,
                   gamma2, gen_tokens, gen_probs, has_draft, return_probs)


def _commit(eng: Engine, state: TriForceState, kv: KVCache, p_all, outcome,
            gamma2: int, gen_tokens, gen_probs, has_draft: bool,
            return_probs: bool):
    """What follows the outer read-back (eager: it takes host counts):
    the resample or bonus, rollback, retrieval tail refresh, emitted
    tokens and, with a drafter, its replay (a graph region) and window
    compaction."""
    sp = eng.spec
    gamma = sp.gamma
    dev = gen_tokens.device
    gen = state.gen
    old_seq_len = state.kv.seq_len
    toks = gen_tokens[:gamma + 1]
    any_stop, j_stop, stop_acc = outcome.tolist()      # the step's read-back
    count = j_stop + stop_acc if any_stop else gamma2
    rejected = bool(any_stop and not stop_acc)
    bonus = count == gamma2

    if bonus:
        pred = sampling.sample(p_all[gamma2], gen)
    elif rejected:
        pred = sampling.sample(sampling.max_fn(p_all[j_stop]
                                               - gen_probs[j_stop]), gen)
    else:
        pred = toks[j_stop]
    has_final = rejected or bonus
    # EOS on any emitting path: accepted proposal, residual, bonus
    eos_acc = bool(any_stop and stop_acc)
    eos_hit = torch.full((), eos_acc, dtype=torch.bool, device=dev)
    if has_final:
        eos_hit = eos_hit | _is_eos(pred, eng.eos_token_id)

    # --- rollback + retrieval tail refresh: keep old + count + 1 slots.
    # An accepted EOS with no resample/bonus stays the next token, so it
    # rolls back one more slot (next_token is never in kv).
    eos_is_pred = int(eos_acc and not has_final)
    kv = kv.rollback(gamma + 1 - count + eos_is_pred)
    rkv = retrieval_tail_refresh(state.rkv, kv, sp, eng.prefill,
                                 old_seq_len)

    emitted = torch.full((gamma + 2,), JUNK_TOKEN, dtype=torch.int64,
                         device=dev)
    emitted[:count] = gen_tokens[:count]
    if has_final:
        emitted[count] = pred

    dkv = state.dkv
    if has_draft:
        pass_tokens = torch.full((gamma + 3,), JUNK_TOKEN, dtype=torch.int64,
                                 device=dev)
        pass_tokens[0] = state.next_token[0]
        pass_tokens[1:count + 1] = gen_tokens[:count]
        if has_final:
            pass_tokens[count + 1] = pred

        def replay(pass_tokens):
            llama.draft_forward_spec(eng.draft_cfg, eng.d_params,
                                     pass_tokens[None], dkv, sp)
            return ()
        eng.graphs.run("draft_replay", replay, (pass_tokens,),
                       caches=graphs_mod.planes(dkv))
        # the reference's count includes the bonus but NOT a resample — it
        # drops the last accepted token from the window on rejection
        dkv = streaming_evict_for_spec(dkv, sp, count + int(bonus))

    new_state = dataclasses.replace(state, kv=kv, rkv=rkv, dkv=dkv,
                                    next_token=pred.reshape(1))
    stats = StepStats(tokens=emitted, n_emitted=count + int(has_final),
                      gamma2=gamma2, accepted=count,
                      resampled=int(rejected), bonus=int(bonus), eos=eos_hit)
    if return_probs:
        return new_state, stats, (gen_tokens, gen_probs, p_all)
    return new_state, stats


def _triforce_step(eng: Engine, state: TriForceState, force_accept=None):
    """One full TriForce outer iteration: middle loop, then the outer
    verify and commit."""
    mid = _middle_spec(eng, state, force_accept=force_accept)
    new_state, stats = _outer_verify_and_commit(
        eng, state, mid["n"], mid["gen_tokens"], mid["gen_probs"], True,
        force_accept=force_accept)
    stats.mid_draft = mid["mid_draft"]
    stats.mid_accept = mid["mid_accept"]
    stats.mid_verify = mid["trips"]
    stats.mid_live = mid["live_trips"]
    return new_state, stats


def _retrieval_region(eng: Engine, state: TriForceState, force_accept):
    """The self-speculation step up to its read-back, one graph region:
    the middle model (target weights over the retrieval cache) drafts
    gamma tokens autoregressively, then the full-cache target verifies
    them. Returns (gen_tokens, gen_probs) + ``_verify_body``'s outputs."""
    t_cfg, sp = eng.target_cfg, eng.spec
    gamma = sp.gamma
    kv, rkv, gen = state.kv, state.rkv, state.gen

    def region(next_token, seq_len):
        dev = next_token.device
        verify_tokens = torch.full((1, gamma + 1), JUNK_TOKEN,
                                   dtype=torch.int64, device=dev)
        verify_tokens[0, 0] = next_token[0]
        gen_tokens = torch.full((gamma + 1,), JUNK_TOKEN, dtype=torch.int64,
                                device=dev)
        gen_probs = torch.zeros((gamma + 1, t_cfg.vocab_size),
                                dtype=torch.float32, device=dev)
        for n in range(gamma):
            m_logits, _ = llama.forward_spec(t_cfg, eng.t_params,
                                             verify_tokens, rkv, seq_len,
                                             sp.budget, commit=False,
                                             act_quant=sp.mid_act_quant)
            p_n = sampling.norm_logits(m_logits[0, n][None], sp.temperature,
                                       -1, sp.top_p)[0]
            tok = sampling.sample(p_n, gen)
            gen_tokens[n] = tok
            gen_probs[n] = p_n
            verify_tokens[0, n + 1] = tok
        return (gen_tokens, gen_probs) + _verify_body(
            eng, _kv_at(kv, seq_len), gen, next_token, gen_tokens,
            gen_probs, gamma, force_accept)
    return region


def _retrieval_spec_step(eng: Engine, state: TriForceState,
                         force_accept=None, return_probs=False):
    """Self-speculation step: the middle model (target weights over the
    retrieval cache) drafts gamma tokens autoregressively with no host
    read-back, then the full-cache target verifies them, all one graph
    region up to the outer read-back. ``return_probs`` as in
    ``_outer_verify_and_commit``: (state, stats, (tokens, q, p))."""
    gamma = eng.spec.gamma
    gen_tokens, gen_probs, p_all, outcome, seq_len = eng.graphs.run(
        "retrieval", _retrieval_region(eng, state, force_accept),
        (state.next_token, state.kv.seq_len),
        caches=graphs_mod.planes(state.kv, state.rkv), gens=(state.gen,),
        extra=(force_accept,))
    out = _commit(eng, state, _kv_at(state.kv, seq_len), p_all, outcome,
                  gamma, gen_tokens, gen_probs, False, return_probs)
    stats = out[1]
    stats.mid_verify = gamma
    stats.mid_live = gamma
    return out


# ---------------------------------------------------------------------------
# The batched steps: B rows of a StackedState at once
# ---------------------------------------------------------------------------

def _on(dev, xs, dtype=torch.int64) -> torch.Tensor:
    """Host-side per-row values (a list or numpy array) as a tensor on
    ``dev``: on a card through pinned memory, queued on the stream without
    waiting for the device (a plain copy from pageable memory would
    synchronise it)."""
    t = torch.tensor(np.asarray(xs), dtype=dtype)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def _draft_rows(eng: Engine, state: StackedState, ids, commit: bool):
    """``draft_forward_spec_rows`` of every row, a graph region at the
    engine's fixed B: returns logits [B, T, V]."""
    dkv = state.dkv

    def region(ids):
        logits, _ = llama.draft_forward_spec_rows(
            eng.draft_cfg, eng.d_params, ids, dkv, eng.spec, commit=commit)
        return (logits,)
    return eng.graphs.run("draft_rows", region, (ids,),
                          caches=graphs_mod.planes(dkv), extra=(commit,))[0]


def _spec_rows(eng: Engine, state: StackedState, ids, kv_len):
    """``forward_spec_rows`` of every row over its retrieval cache, a
    graph region: returns logits [B, T, V]."""
    t_cfg, sp, rkv = eng.target_cfg, eng.spec, state.rkv

    def region(ids, kv_len):
        return (llama.forward_spec_rows(t_cfg, eng.t_params, ids, rkv, kv_len,
                                        sp.budget,
                                        act_quant=sp.mid_act_quant),)
    return eng.graphs.run("spec_rows", region, (ids, kv_len),
                          caches=graphs_mod.planes(rkv))[0]


def _append_rows(eng: Engine, state: StackedState, ids):
    """``forward_append_rows`` of every row over its full cache (read
    only), a graph region: returns (logits, new K stack, new V stack)."""
    kv = state.kv

    def region(ids, seq_len):
        return llama.forward_append_rows(eng.target_cfg, eng.t_params, ids,
                                         _kv_at(kv, seq_len))
    return eng.graphs.run("append_rows", region, (ids, kv.seq_len),
                          caches=graphs_mod.planes(kv))


def _rand_rows(n: int, gens, draws, dev) -> torch.Tensor:
    """[B, n] uniforms, row b from its own generator where ``draws[b]``
    (0.5 elsewhere: the caller ignores those rows)."""
    out = torch.full((len(gens), n), 0.5, dtype=torch.float32, device=dev)
    for b, gen in enumerate(gens):
        if draws[b]:
            out[b] = torch.rand((n,), generator=gen, device=dev)
    return out


def _middle_spec_rows(eng: Engine, state: StackedState, force_accept=None):
    """``_middle_spec`` for every row at once. The trips run in lockstep
    until every row has its gamma proposals (or for ``middle_trips``
    trips): a row that is done rides along as a dead trip, with a
    zero-column retrieval read, and draws and counts nothing that its
    batch-1 run would not. One read-back per trip serves all rows."""
    t_cfg, sp = eng.target_cfg, eng.spec
    gamma, k = sp.gamma, _chain_len(sp)
    vocab = t_cfg.vocab_size
    dev = state.next_token.device
    gens, rows = state.gens, state.rows
    fixed = sp.middle_trips > 0
    kv_seq_len = state.kv.seq_len
    gen_tokens = torch.full((rows, gamma + 1), JUNK_TOKEN, dtype=torch.int64,
                            device=dev)
    gen_probs = torch.zeros((rows, gamma + 1, vocab), dtype=torch.float32,
                            device=dev)
    js = torch.arange(k, device=dev)
    ar = torch.arange(rows, device=dev)
    n = [0] * rows
    mid_draft, mid_accept = np.zeros(rows, int), np.zeros(rows, int)
    row_trips, live_trips = np.zeros(rows, int), np.zeros(rows, int)
    trips = 0

    while (trips < sp.middle_trips) if fixed else (min(n) < gamma):
        n0 = list(n)
        live = [x < gamma for x in n0]
        # a batch-1 loop that has ended runs no trip: in the open-ended
        # loop a finished row takes no part (no draw, no count)
        takes_part = [fixed or lv for lv in live]
        # --- chain drafting: up to k drafter forwards for all rows; row b
        # takes proposal i while n0[b] + i stays under the gamma-1 cap
        vt = torch.cat([state.next_token[:, None], gen_tokens[:, :gamma]], 1)
        chain_toks = torch.full((rows, k), JUNK_TOKEN, dtype=torch.int64,
                                device=dev)
        chain_q = torch.zeros((rows, k), dtype=torch.float32, device=dev)
        i_fin = [0] * rows
        for i in range(k):
            act = [n0[b] + i <= gamma - 1 for b in range(rows)]
            if not any(act):
                break
            d_logits = _draft_rows(eng, state, vt, False)
            at = _on(dev, [min(n0[b] + i, gamma) for b in range(rows)])
            q = sampling.norm_logits(d_logits[ar, at], sp.temperature, -1,
                                     sp.top_p)                   # [B, V]
            tok = sampling.sample_rows(q, gens, act)
            rb = [b for b in range(rows) if act[b]]
            chain_toks[rb, i] = tok[rb]
            chain_q[rb, i] = q[rb, tok[rb]]
            vt[rb, [n0[b] + i + 1 for b in rb]] = tok[rb]
            for b in rb:
                i_fin[b] += 1

        # --- ONE middle verify over every row's chain (read-only rkv)
        live_t = _on(dev, live, torch.bool)
        m_logits = _spec_rows(eng, state, vt,
                              torch.where(live_t, kv_seq_len, 0))
        rows_idx = (_on(dev, n0)[:, None]
                    + torch.arange(k + 1, device=dev)).clamp(0, gamma)
        p_rows = sampling.norm_logits(m_logits[ar[:, None], rows_idx],
                                      sp.temperature, -1,
                                      sp.top_p)              # [B, k+1, V]

        # --- accept walk, all rows' coins at once
        rs = _rand_rows(k, gens, takes_part, dev)
        if force_accept is None:
            p_tok = p_rows[:, :k].gather(
                2, chain_toks.clamp(0, vocab - 1)[..., None])[..., 0]
            ok_v = rs < (p_tok / chain_q.clamp_min(1e-37)).clamp(max=1.0)
        else:
            ok_v = rs < force_accept
        rej_v = (js[None, :] < _on(dev, i_fin)[:, None]) & ~ok_v
        outcome = torch.stack([rej_v.any(1).long(),
                               torch.argmax(rej_v.to(torch.int32), 1)],
                              1).tolist()             # the trip's read-back
        any_rej = [bool(o[0]) for o in outcome]
        j_rej = [o[1] for o in outcome]
        used = [j_rej[b] + 1 if any_rej[b] else i_fin[b]
                for b in range(rows)]

        # reject: sample from that position's middle distribution
        final_toks = chain_toks
        if any(any_rej):
            res = sampling.sample_rows(p_rows[ar, _on(dev, j_rej)], gens,
                                       any_rej)
            rb = [b for b in range(rows) if any_rej[b]]
            final_toks = chain_toks.clone()
            final_toks[rb, [j_rej[b] for b in rb]] = res[rb]
        # commit consumed positions: tokens and their middle rows
        for b in range(rows):
            if used[b]:
                gen_tokens[b, n0[b]:n0[b] + used[b]] = final_toks[b, :used[b]]
                gen_probs[b, n0[b]:n0[b] + used[b]] = p_rows[b, :used[b]]
            n[b] = n0[b] + used[b]
        mid_accept += np.array(used) - np.array(any_rej, int)
        mid_draft += np.array(used)

        # --- bonus on a fully accepted chain
        bonus = [not any_rej[b] and n[b] <= gamma and n0[b] < gamma
                 for b in range(rows)]
        if any(bonus):
            b_rows = p_rows[ar, _on(dev, [min(max(n[b] - n0[b], 0), k)
                                        for b in range(rows)])]
            b_tok = sampling.sample_rows(b_rows, gens, bonus)
            for b in range(rows):
                if bonus[b]:
                    gen_tokens[b, n[b]] = b_tok[b]
                    gen_probs[b, n[b]] = b_rows[b]
                    n[b] += 1
        trips += 1
        row_trips += np.array(takes_part, int)
        live_trips += np.array(live, int)

    return {"n": n, "gen_tokens": gen_tokens, "gen_probs": gen_probs,
            "mid_draft": mid_draft, "mid_accept": mid_accept,
            "row_trips": row_trips, "live_trips": live_trips, "trips": trips}


def _outer_verify_and_commit_rows(eng: Engine, state: StackedState, gamma2,
                                  gen_tokens, gen_probs, has_draft: bool,
                                  force_accept=None):
    """``_outer_verify_and_commit`` for every row at once: one gamma+2-token
    forward over all rows' full caches, every row's accept tests, ONE
    read-back of the outcomes, then per row the rollback, the commit and
    retrieval tail refresh (``batched_commit_and_refresh``) and, with a
    drafter, the replay and window compaction. ``gamma2`` is a list of the
    rows' proposal counts. A row whose pre-step length is 0 stays at 0."""
    t_cfg, sp = eng.target_cfg, eng.spec
    gamma = sp.gamma
    dev = gen_tokens.device
    gens, rows = state.gens, state.rows
    old = state.kv.seq_len
    ar = torch.arange(rows, device=dev)

    verify_in = torch.cat([state.next_token[:, None], gen_tokens], 1)
    logits, nk, nv = _append_rows(eng, state, verify_in)
    p_all = sampling.norm_logits(logits, sp.temperature, sp.top_k,
                                 sp.top_p)                # [B, gamma+2, V]

    pos = torch.arange(gamma + 1, device=dev)
    tok_c = gen_tokens.clamp(0, t_cfg.vocab_size - 1)[..., None]
    q_sel = gen_probs.gather(2, tok_c)[..., 0]
    p_sel = p_all[:, :gamma + 1].gather(2, tok_c)[..., 0]
    rs = _rand_rows(gamma + 1, gens, [True] * rows, dev)
    if force_accept is None:
        accept_v = rs < (p_sel / q_sel.clamp_min(1e-37)).clamp(max=1.0)
    else:
        accept_v = rs < force_accept
    live = pos[None, :] < _on(dev, gamma2)[:, None]
    # the walk stops at the first rejection OR the first ACCEPTED EOS
    stop_v = live & (~accept_v
                     | (accept_v & _is_eos(gen_tokens, eng.eos_token_id)))
    j_stop_t = torch.argmax(stop_v.to(torch.int32), 1)
    outcome = torch.stack([stop_v.any(1).long(), j_stop_t,
                           accept_v[ar, j_stop_t].long()],
                          1).tolist()                 # the step's read-back
    count = np.array([o[1] + o[2] if o[0] else g2
                      for o, g2 in zip(outcome, gamma2)])
    rejected = np.array([bool(o[0] and not o[2]) for o in outcome])
    eos_acc = np.array([bool(o[0] and o[2]) for o in outcome])
    bonus = count == np.array(gamma2)
    has_final = rejected | bonus

    # bonus rows sample the target row after their last proposal, rejected
    # rows the residual at the stop; the rest keep the accepted EOS
    at = torch.where(_on(dev, bonus, torch.bool), _on(dev, gamma2), j_stop_t)
    base = p_all[ar, at]
    resid = sampling.max_fn(base - gen_probs[ar, j_stop_t])
    probs = torch.where(_on(dev, bonus, torch.bool)[:, None], base, resid)
    has_final_t = _on(dev, has_final, torch.bool)
    pred = torch.where(has_final_t,
                       sampling.sample_rows(probs, gens, has_final),
                       gen_tokens[ar, j_stop_t])
    eos_hit = _on(dev, eos_acc, torch.bool) \
        | (has_final_t & _is_eos(pred, eng.eos_token_id))

    # --- rollback + commit + retrieval tail refresh: row b keeps old +
    # count + 1 slots, one fewer when an accepted EOS stays its next token
    count_t = _on(dev, count)
    keep = count_t + 1 - _on(dev, eos_acc & ~has_final)
    kv = dataclasses.replace(state.kv, seq_len=(old + keep).to(old.dtype))
    kv, rkv = batched_commit_and_refresh(kv, state.rkv, nk, nv, old, sp,
                                         eng.prefill)
    # dead-slot freeze: a row that started the step empty stays empty
    kv = dataclasses.replace(
        kv, seq_len=torch.where(old == 0, torch.zeros_like(old),
                                kv.seq_len))

    pos2 = torch.arange(gamma + 2, device=dev)[None, :]
    emitted = torch.where(
        pos2 < count_t[:, None], gen_tokens[:, pos2[0].clamp(max=gamma)],
        torch.where((pos2 == count_t[:, None]) & has_final_t[:, None],
                    pred[:, None], JUNK_TOKEN))

    dkv = state.dkv
    if has_draft:
        ppos = torch.arange(gamma + 3, device=dev)[None, :]
        pass_tokens = torch.where(
            ppos == 0, state.next_token[:, None],
            torch.where(ppos <= count_t[:, None],
                        gen_tokens[:, (ppos[0] - 1).clamp(0, gamma)],
                        torch.where((ppos == count_t[:, None] + 1)
                                    & has_final_t[:, None], pred[:, None],
                                    JUNK_TOKEN)))
        _draft_rows(eng, state, pass_tokens, True)
        # the reference's count includes the bonus but NOT a resample
        dkv = streaming_evict_for_spec_rows(dkv, sp,
                                            count_t + _on(dev, bonus))

    new_state = dataclasses.replace(state, kv=kv, rkv=rkv, dkv=dkv,
                                    next_token=pred)
    zeros = np.zeros(rows, int)
    stats = BatchedStepStats(
        tokens=emitted, n_emitted=count + has_final, gamma2=np.array(gamma2),
        accepted=count, resampled=rejected.astype(int),
        bonus=bonus.astype(int), eos=eos_hit, mid_draft=zeros,
        mid_accept=zeros, mid_verify=zeros, mid_live=zeros)
    return new_state, stats


def triforce_step_rows(eng: Engine, state: StackedState, force_accept=None):
    """One full TriForce outer iteration for every row of ``state``."""
    if eng.draft_cfg is None:
        raise ValueError("triforce mode needs a drafter")
    mid = _middle_spec_rows(eng, state, force_accept=force_accept)
    new_state, stats = _outer_verify_and_commit_rows(
        eng, state, mid["n"], mid["gen_tokens"], mid["gen_probs"], True,
        force_accept=force_accept)
    stats.mid_draft = mid["mid_draft"]
    stats.mid_accept = mid["mid_accept"]
    stats.mid_verify = mid["row_trips"]
    stats.mid_live = mid["live_trips"]
    stats.target_forwards = mid["trips"] + 1
    return new_state, stats


def retrieval_spec_step_rows(eng: Engine, state: StackedState,
                             force_accept=None):
    """Self-speculation step for every row of ``state``: gamma middle
    forwards over all rows' retrieval caches with no host read-back, then
    the full-cache verify."""
    t_cfg, sp = eng.target_cfg, eng.spec
    gamma = sp.gamma
    dev = state.next_token.device
    rows = state.rows
    verify_tokens = torch.full((rows, gamma + 1), JUNK_TOKEN,
                               dtype=torch.int64, device=dev)
    verify_tokens[:, 0] = state.next_token
    gen_tokens = torch.full((rows, gamma + 1), JUNK_TOKEN, dtype=torch.int64,
                            device=dev)
    gen_probs = torch.zeros((rows, gamma + 1, t_cfg.vocab_size),
                            dtype=torch.float32, device=dev)
    for n in range(gamma):
        m_logits = _spec_rows(eng, state, verify_tokens, state.kv.seq_len)
        p_n = sampling.norm_logits(m_logits[:, n], sp.temperature, -1,
                                   sp.top_p)
        tok = sampling.sample_rows(p_n, state.gens)
        gen_tokens[:, n] = tok
        gen_probs[:, n] = p_n
        verify_tokens[:, n + 1] = tok
    new_state, stats = _outer_verify_and_commit_rows(
        eng, state, [gamma] * rows, gen_tokens, gen_probs, False,
        force_accept=force_accept)
    stats.mid_verify = np.full(rows, gamma)
    stats.mid_live = np.full(rows, gamma)
    stats.target_forwards = gamma + 1
    return new_state, stats
