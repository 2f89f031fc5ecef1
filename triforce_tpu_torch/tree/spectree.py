"""Sequoia-style tree speculation on the retrieval-cache middle model — the
port of ``triforce_tpu/tree/spectree.py``.

One round: grow the token tree level by level through the middle model
(target weights over the tree retrieval cache), verify ALL tree nodes in one
full-cache target forward under the tree's ancestor mask, walk the tree with
multi-child rejection sampling and residual updates, compact the accepted
path into the KV cache, refresh the retrieval tail. The grow map (tree shape,
masks, depths, successor table) is static data, turned into device tensors
once per engine.

The JAX package compiles a whole round into one program; here a round is a
host loop that launches device work and reads back only what the control
flow needs: the outcome of one tree node's child tests per visited node that
has children (``[chosen child, its token]``), and once per step ``[nothing
left to sample, the sampled token]``. ``TreeStepStats.readbacks`` counts
them. The caches are updated in place; a state is not reusable after a step
unless it was cloned first.

On a CUDA device the grow (root forward and every padded level, with
their Gumbel samples), the tree verify (the forward under the ancestor
mask and the filtered target rows) and each visited node's child tests
run as replays of captured CUDA graphs (``graphs.py``): the grow makes no
host decision, every index in it is an engine constant. The walk, its
read-backs and the commit stay on the host. ``TreeEngine(graphs=False)``
runs the same regions eagerly.

Random draws come from the state's ``torch.Generator``, in this order per
step: per grow level one Gumbel block ``[R, V]`` (R = the widest level's
root count, every level alike); per visited tree node that has children one
block of ``max_children`` uniforms, the j-th for the test of its j-th child
(drawn whether or not that test is reached); then the ``V`` uniforms of the
residual / bonus sample (drawn even when nothing is left to sample).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from .. import graphs as graphs_mod
from ..cache import (KVCache, RetrievalCache, gather_kv_incremental, init_kv,
                     init_tree_retrieval, retrieval_tail_refresh)
from ..config import ModelConfig, SpecConfig, resolve_device
from ..engine import append_graphed, dense_weights, prefill_chunks
from ..models import llama
from ..ops import sampling
from .planner import GrowMap

JUNK_TOKEN = 100
_NEG_INF = -1e30


@dataclasses.dataclass
class TreeState:
    kv: KVCache
    rkv: RetrievalCache        # budget + tree_size (+ pad) slots
    next_token: torch.Tensor   # [1] int64
    gen: torch.Generator       # random stream of every draw

    def clone(self) -> "TreeState":
        gen = torch.Generator(device=self.gen.device)
        gen.set_state(self.gen.get_state())
        return TreeState(kv=self.kv.clone(), rkv=self.rkv.clone(),
                         next_token=self.next_token.clone(), gen=gen)


@dataclasses.dataclass
class TreeStepStats:
    """``tokens`` stays on the device; the rest are host values (the step
    read them back to drive its control flow)."""
    tokens: torch.Tensor   # [max_path + 1] emitted, junk-padded
    n_emitted: int
    n_nodes: int           # accepted path length incl. root
    terminal: bool         # EOS hit or zero residual
    eos: bool
    readbacks: int = 0     # device -> host reads this step made


def _padded_levels(gm: GrowMap):
    """Pad every grow level to ONE width W, so that every level forward has
    the same shapes (one partials-kernel shape for the whole grow). Returns
    numpy tables (W, K, roots [n,R], widths [n], starts [n], tok_root
    [n,W], tok_rank [n,W], depth_rows [n,W], mask_rows [n,W,size])."""
    n = gm.num_levels
    W = max(int(sum(b)) for b in gm.branches)
    R = max(len(r) for r in gm.roots)
    K = max(max(int(x) for x in b) for b in gm.branches if len(b))
    roots = np.zeros((n, R), np.int32)
    widths = np.zeros((n,), np.int32)
    starts = np.zeros((n,), np.int32)
    tok_root = np.zeros((n, W), np.int32)
    tok_rank = np.zeros((n, W), np.int32)
    depth_rows = np.zeros((n, W), np.int32)
    mask_rows = np.zeros((n, W, gm.size), bool)
    start = 1
    for lvl, (rts, brs) in enumerate(zip(gm.roots, gm.branches)):
        w = int(sum(brs))
        widths[lvl], starts[lvl] = w, start
        roots[lvl, :len(rts)] = np.asarray(rts, np.int32)
        j = 0
        for ri, br in enumerate(brs):
            for rk in range(int(br)):
                tok_root[lvl, j], tok_rank[lvl, j] = ri, rk
                j += 1
        depth_rows[lvl, :w] = gm.depth[start:start + w]
        mask_rows[lvl, :w] = gm.mask[start:start + w]
        start += w
    return W, K, roots, widths, starts, tok_root, tok_rank, depth_rows, \
        mask_rows


class TreeEngine:
    """Tree-speculative decoding of one target model on one device.
    ``device=None`` means the first CUDA card and raises when there is
    none.

    ``kv_quant``: the full and the tree retrieval cache hold int8 codes
    with per-token scales. ``weight_quant``: the matmul weights are
    quantized to int8 here (params that already hold int8 codes are taken
    as they are); the grow forwards then run them against int8
    activations (``llama._wmm(aq=True)``), the tree verify keeps the exact
    weight-only path, and the prefill's chunks run over an exact bf16 copy
    (``engine.dense_weights``: once per call eagerly, once per engine with
    graphs on). The prefill runs through ``Engine``'s graph regions
    (``engine.prefill_chunks``, ``engine.append_graphed``).
    ``ssl``: during the grow the first ``ssl`` layers attend the FULL cache
    instead of the tree retrieval cache. ``graphs`` as ``Engine``'s: None
    captures the step's regions on a CUDA device, False runs them eagerly,
    True on the CPU raises."""

    def __init__(self, cfg: ModelConfig, grow_map: GrowMap, params, *,
                 prefill: int, max_cache_len: int, budget: int = 4096,
                 chunk_size: int = 8, temperature: float = 0.6,
                 top_p: float = 0.9, eos_ids=(0, 2), dtype=torch.bfloat16,
                 prefill_chunk: int = 128, kv_quant: bool = False,
                 weight_quant: bool = False, ssl: int = 0, mesh=None,
                 device=None, graphs=None):
        if mesh is not None:
            raise NotImplementedError("sharding over a mesh is not ported "
                                      "yet")
        if prefill % chunk_size or budget % chunk_size:
            raise ValueError("prefill and budget must be multiples of "
                             "chunk_size")
        if not 0 <= ssl <= cfg.num_layers:
            raise ValueError(f"ssl {ssl} outside [0, {cfg.num_layers}]")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params are on {params['embed'].device}, "
                             f"engine on {self.device}")
        self.graphs = graphs_mod.GraphSet(self.device, graphs)
        self.cfg = cfg
        self.gm = grow_map
        self.prefill = prefill
        (self.W, self.K, roots, widths, starts, tok_root, tok_rank,
         depth_rows, mask_rows) = _padded_levels(grow_map)
        # the padded grow width W is reserved past the tree region of both
        # caches, so that the last levels' fixed-width writes never slide
        # back over committed tree slots
        self.max_cache_len = max_cache_len + grow_map.size + self.W
        self.budget = budget
        self.chunk_size = chunk_size
        self.temperature = temperature
        self.top_p = top_p
        self.eos_ids = tuple(int(e) for e in eos_ids)
        self.dtype = dtype
        self.prefill_chunk = prefill_chunk
        self.kv_quant = kv_quant
        self.ssl = ssl
        self.weight_quant = weight_quant
        if weight_quant:
            params = llama.quantize_weights(params)    # unless already codes
        self.params = params
        self._dense = None     # the prefill's converted weights (graphed)
        self.max_path = int(grow_map.depth.max()) + 1

        # the static tables as device tensors
        def on(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a), device=self.device
                                   ).to(dtype)
        self._starts = [int(s) for s in starts]
        self._roots = on(roots)
        self._tok_root, self._tok_rank = on(tok_root), on(tok_rank)
        self._depth_rows = on(depth_rows)
        self._mask_rows = on(mask_rows, torch.bool)
        self._live = torch.arange(self.W, device=self.device)[None, :] \
            < on(widths)[:, None]
        self._depth = on(grow_map.depth)
        self._mask = on(grow_map.mask, torch.bool)
        self._succ = on(grow_map.successors)
        self._has_kids = (np.asarray(grow_map.successors) >= 0).any(1)

    # ------------------------------------------------------------------

    def init_state(self, seed: int) -> TreeState:
        dev = self.device
        kv = init_kv(self.cfg, self.max_cache_len, dtype=self.dtype,
                     device=dev, quant=self.kv_quant)
        rkv = init_tree_retrieval(self.cfg, self.budget, self.gm.size,
                                  dtype=self.dtype, device=dev,
                                  quant=self.kv_quant, pad=self.W)
        return TreeState(
            kv=kv, rkv=rkv,
            next_token=torch.zeros((1,), dtype=torch.int64, device=dev),
            gen=torch.Generator(device=dev).manual_seed(seed))

    def prefill_target(self, state: TreeState,
                       input_ids: torch.Tensor) -> TreeState:
        """Chunked prefill, the retrieval build on the last token's
        forward, and the root sample."""
        if input_ids.shape[1] != self.prefill:
            raise ValueError(f"prompt has {input_ids.shape[1]} tokens, the "
                             f"engine was built for {self.prefill}")
        kv = prefill_chunks(self.graphs, self.cfg,
                            dense_weights(self, self.params), state.kv,
                            input_ids[:, :-1], self.prefill_chunk)
        logits, kv = append_graphed(
            self.graphs, self.cfg, self.params, kv, input_ids[:, -1:],
            build_rkv=state.rkv, prefill=self.prefill,
            chunk_size=self.chunk_size, budget=self.budget)
        probs = sampling.norm_logits(logits[:, -1], self.temperature, -1,
                                     self.top_p)
        return dataclasses.replace(
            state, kv=kv, next_token=sampling.sample(probs, state.gen))

    def release_graphs(self) -> None:
        """Drop this engine's CUDA graphs and the prefill's converted
        weights."""
        self.graphs.release()
        self._dense = None

    def step(self, state: TreeState, force_accept: Optional[float] = None
             ) -> Tuple[TreeState, TreeStepStats]:
        return _tree_step(self, state, force_accept)

    def _gen(self, state: TreeState, max_len: int, force_accept):
        buf = torch.full((max_len + self.max_path + 1,), JUNK_TOKEN,
                         dtype=torch.int64, device=self.device)
        buf[0] = state.next_token[0]
        n, stop = 1, False
        counters = np.zeros(3, np.int64)
        while n < max_len + 1 and not stop:
            state, stats = _tree_step(self, state, force_accept)
            buf[n:n + self.max_path + 1] = stats.tokens
            n += stats.n_emitted
            counters += [1, stats.n_nodes, stats.readbacks]
            # forced runs never stop on the terminal flag: the coin walk
            # can zero the residual by chance, which would end a timing
            # run early
            stop = stats.terminal and force_accept is None
        return state, buf, n, counters, stop

    def generate(self, state: TreeState, max_len: int):
        """Tree steps until ``max_len`` tokens past the first or a terminal
        step. Returns (state, token_buf, n, counters=[steps, nodes,
        host read-backs], stop)."""
        return self._gen(state, max_len, None)

    def generate_forced(self, state: TreeState, max_len: int, alpha: float):
        """Controlled-acceptance tree generation: every per-child accept
        test is a coin at rate ``alpha`` while all real compute runs. The
        output is NOT target-distributed. Returns what ``generate``
        returns."""
        return self._gen(state, max_len, float(alpha))


def _grow(eng: TreeEngine, state: TreeState):
    """``_grow_body`` as one graph region (its key holds ``ssl``, which
    changes the program). Returns copies of (verify_tokens [size],
    draft_logits [size, V])."""
    def region(next_token, seq_len):
        return _grow_body(eng, dataclasses.replace(
            state, next_token=next_token,
            kv=dataclasses.replace(state.kv, seq_len=seq_len)))
    return eng.graphs.run("grow", region,
                          (state.next_token, state.kv.seq_len),
                          caches=graphs_mod.planes(state.kv, state.rkv),
                          gens=(state.gen,), extra=(eng.ssl,))


def _grow_body(eng: TreeEngine, state: TreeState):
    """Build the token tree through the middle model. All levels run at the
    padded width W (``_padded_levels``): per level, per-root Gumbel-top-k
    samples children WITHOUT replacement from softmax(draft_logits / T),
    then one middle forward of the padded frontier. Padded slots carry junk
    tokens whose KV lands in slots that later REAL levels overwrite and
    whose attention columns stay masked (col < slot_start). The caches are
    written in place. Returns (verify_tokens [size], draft_logits
    [size, V])."""
    cfg, gm, dev = eng.cfg, eng.gm, eng.device
    size, W = gm.size, eng.W
    kv_seq_len = state.kv.seq_len
    aq = eng.weight_quant      # grow forwards: int8 x int8

    # buffers padded by W: the LAST level's padded write overhangs
    # [size, size + W) and is sliced off
    verify_tokens = torch.full((size + W,), JUNK_TOKEN, dtype=torch.int64,
                               device=dev)
    verify_tokens[0] = state.next_token[0]
    draft_logits = torch.zeros((size + W, cfg.vocab_size),
                               dtype=torch.float32, device=dev)

    def forward(toks, depths, amask, slot_start, staged_len):
        logits, _, _ = llama.forward_tree_spec(
            cfg, eng.params, toks[None], state.rkv, kv_seq_len, eng.budget,
            depths=depths, ancestor_mask=amask, slot_start=slot_start,
            kv=state.kv, ssl=eng.ssl, staged_len=staged_len, act_quant=aq)
        return logits[0].float()

    draft_logits[0] = forward(state.next_token, eng._depth[0:1],
                              eng._mask[0:1], 0, 0)[0]
    for lvl, start in enumerate(eng._starts):
        root_logits = draft_logits[eng._roots[lvl]] / eng.temperature
        g = sampling.gumbel_noise(root_logits.shape, state.gen, dev)
        cand = sampling.topk_small(root_logits + g, eng.K)       # [R, K]
        toks = cand[eng._tok_root[lvl], eng._tok_rank[lvl]]      # [W]
        toks = torch.where(eng._live[lvl], toks, JUNK_TOKEN)
        verify_tokens[start:start + W] = toks
        draft_logits[start:start + W] = forward(
            toks, eng._depth_rows[lvl], eng._mask_rows[lvl], start, size)
    return verify_tokens[:size], draft_logits[:size]


def _verify(eng: TreeEngine, state: TreeState, verify_tokens):
    """ONE full-cache target forward over all tree nodes under the
    ancestor mask (their KV lands at ``seq_len + i``, in place) and the
    filtered target rows, one graph region: returns (p_all [size, V], kv
    length after the forward)."""
    kv = state.kv

    def region(verify_tokens, seq_len):
        logits_t, kv_out, _ = llama.forward_append(
            eng.cfg, eng.params, verify_tokens[None],
            dataclasses.replace(kv, seq_len=seq_len),
            positions=seq_len.to(torch.int64) + eng._depth,
            tree_mask=eng._mask)
        # row by row the same function; chunked to bound the top-p
        # filter's [rows, V, grid] intermediate
        p_all = torch.cat([sampling.norm_logits(c, eng.temperature, -1,
                                                eng.top_p)
                           for c in logits_t[0].split(32)])  # [size, V]
        return p_all, kv_out.seq_len
    return eng.graphs.run("tree_verify", region, (verify_tokens, kv.seq_len),
                          caches=graphs_mod.planes(kv))


def _node_region(eng: TreeEngine, gen, force_accept):
    """One visited node's child tests up to its read-back, a graph region:
    draws its ``max_children`` uniforms and returns (residual p [V],
    [chosen child or -1, its token])."""
    max_c = eng.gm.max_children

    def region(p, dl, kids, verify_tokens):
        u = torch.rand((max_c,), generator=gen, device=p.device,
                       dtype=torch.float32)
        p, chosen = _child_tests(eng, p, dl, kids, verify_tokens, u,
                                 force_accept)
        tok_ch = verify_tokens.index_select(0, chosen.clamp_min(0)
                                            .reshape(1))
        return p, torch.cat([chosen.reshape(1), tok_ch])
    return region


def _child_tests(eng: TreeEngine, p, dl, kids, verify_tokens, u,
                 force_accept):
    """The accept tests of one node's children, in order, on the device:
    child j is accepted iff no elder sibling was and ``p[tok] > u[j] *
    q[tok]`` (or, forced, ``u[j] < force_accept``); a rejected child moves
    p to the residual ``norm(max(p - q, 0))`` and leaves the proposal
    distribution. Returns (residual p, chosen child id or -1, 0-d)."""
    chosen = torch.full((), -1, dtype=torch.int64, device=p.device)
    for j in range(kids.shape[0]):
        child = kids[j]
        live = (child >= 0) & (chosen < 0)
        tok = verify_tokens.index_select(0, child.clamp_min(0).reshape(1))
        q = torch.softmax(dl / eng.temperature, dim=-1)
        if force_accept is None:
            ok = live & (p.gather(0, tok)[0] > u[j] * q.gather(0, tok)[0])
        else:
            ok = live & (u[j] < force_accept)
        rej = live & ~ok
        chosen = torch.where(ok, child, chosen)
        p = torch.where(rej, sampling.max_fn(p - q), p)
        dl = torch.where(rej, dl.index_fill(0, tok, _NEG_INF), dl)
    return p, chosen


def _tree_step(eng: TreeEngine, state: TreeState,
               force_accept: Optional[float] = None):
    """One full tree round: grow -> verify -> accept walk -> commit.

    ``force_accept``: controlled-acceptance validation. Every per-child
    accept test in the walk becomes a coin flip at that rate while ALL real
    compute runs (grow levels, full-cache tree verify, residual updates,
    path compaction, tail refresh). The output is NOT lossless."""
    cfg, gm, dev = eng.cfg, eng.gm, eng.device
    verify_tokens, draft_logits = _grow(eng, state)
    seq0 = state.kv.seq_len
    max_path = eng.max_path

    # --- ONE full-cache verify over all tree nodes
    p_all, seq_len = _verify(eng, state, verify_tokens)
    kv = dataclasses.replace(state.kv, seq_len=seq_len)

    # --- accept walk with residual updates: the host follows the path, the
    # device runs each node's child tests and hands back the chosen child
    readbacks = 0
    cur, n_nodes, eos_hit = 0, 1, False
    accept_idx = torch.zeros((max_path,), dtype=torch.int64, device=dev)
    final_p = None
    node = _node_region(eng, state.gen, force_accept)
    while True:
        if not eng._has_kids[cur]:           # a leaf: nothing to test
            final_p = p_all[cur]
            break
        p, chosen = eng.graphs.run(
            "tree_node", node,
            (p_all[cur], draft_logits[cur], eng._succ[cur], verify_tokens),
            gens=(state.gen,), extra=(force_accept,))
        chosen_h, tok_h = chosen.tolist()
        readbacks += 1
        if chosen_h < 0:
            final_p = p
            break
        accept_idx[n_nodes] = chosen[0]
        n_nodes += 1
        cur = chosen_h
        if tok_h in eng.eos_ids:
            eos_hit = True
            break

    # --- residual / bonus sample; the draw is made even when unused
    if final_p is None:
        final_p = torch.zeros((cfg.vocab_size,), dtype=torch.float32,
                              device=dev)
    zero_res = final_p.sum() <= 0
    sampled = sampling.sample(final_p, state.gen)
    zero_h, next_h = torch.stack([zero_res.to(torch.int64),
                                  sampled]).tolist()
    readbacks += 1
    no_final = eos_hit or bool(zero_h)
    next_tok = torch.full((1,), JUNK_TOKEN, dtype=torch.int64, device=dev) \
        if no_final else sampled[None]
    # the residual / bonus sample can itself be EOS: it is still emitted,
    # but the loop must stop on it
    res_eos = (not no_final) and next_h in eng.eos_ids
    eos_hit = eos_hit or res_eos
    terminal = no_final or res_eos

    # --- commit: compact the accepted path, refresh the retrieval tail
    kv = gather_kv_incremental(kv, accept_idx, n_nodes, seq0, max_path,
                               max_span=gm.size)
    rkv = retrieval_tail_refresh(
        state.rkv, kv, SpecConfig(budget=eng.budget, chunk_size=1),
        eng.prefill, seq0, max_new=max_path)

    # --- emitted tokens: accepted children, then the sampled token
    pos = torch.arange(max_path + 1, device=dev)
    acc_toks = verify_tokens[accept_idx[(pos + 1).clamp_max(max_path - 1)]]
    emitted = torch.where(pos < n_nodes - 1, acc_toks, JUNK_TOKEN)
    emitted[n_nodes - 1] = next_tok[0]       # junk when nothing was sampled
    n_emitted = n_nodes - 1 + (0 if no_final else 1)

    new_state = dataclasses.replace(state, kv=kv, rkv=rkv,
                                    next_token=next_tok)
    stats = TreeStepStats(tokens=emitted, n_emitted=n_emitted,
                          n_nodes=n_nodes, terminal=terminal, eos=eos_hit,
                          readbacks=readbacks)
    return new_state, stats


def tree_decode(engine: TreeEngine, input_ids: torch.Tensor,
                max_len: int = 256, seed: int = 0, device=None):
    """Host entry point: prefill, then tree steps until ``max_len`` tokens or a
    terminal step. ``device`` defaults to the first CUDA card and must be
    the engine's."""
    from ..decoding import DecodeResult, _CaptureClock, _Prefill

    dev = resolve_device(device)
    if dev != engine.device:
        raise ValueError(f"caller asked for {dev}, engine is on "
                         f"{engine.device}")
    pre = _Prefill(engine)
    state = engine.init_state(seed)
    state = engine.prefill_target(state, input_ids)
    first = int(state.next_token[0])   # read-back: prefill is done
    pre.stop()
    clock = _CaptureClock(engine.graphs)
    t0 = time.perf_counter()
    state, buf, n, counters, _ = engine.generate(state, max_len)
    out = buf[:n].tolist()             # read-back: generation is done
    wall = time.perf_counter() - t0 - clock.seconds
    assert out[0] == first
    steps, nodes = int(counters[0]), int(counters[1])
    gen = n - 1
    return DecodeResult(tokens=out, tokens_per_sec=gen / max(wall, 1e-9),
                        acceptance_rate=nodes / max(steps * engine.gm.size,
                                                    1),
                        avg_tokens_per_step=gen / max(steps, 1),
                        steps=steps, wall_s=wall, captures=clock.count,
                        capture_s=clock.seconds, **pre.fields)
