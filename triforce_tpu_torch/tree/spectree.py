"""Sequoia-style tree speculation on the retrieval-cache middle model — the
port of ``triforce_tpu/tree/spectree.py``.

One round: grow the token tree level by level through the middle model
(target weights over the tree retrieval cache), verify ALL tree nodes in one
full-cache target forward under the tree's ancestor mask, walk the tree with
multi-child rejection sampling and residual updates, compact the accepted
path into the KV cache, refresh the retrieval tail. The grow map (tree shape,
masks, depths, successor table) is static data, turned into device tensors
once per engine.

As in the JAX package, a round makes no host decision: the walk is one
conditional body per depth (``GraphSet.cond``) that runs while the walk
goes on, the final sample is chosen with ``torch.where`` and the commit
takes device counts. ``TreeEngine.generate`` runs the whole generation as
``max_len`` calls of one loop region holding the round as a conditional
body (``engine.Engine._gen``'s scheme), reading back once at its end; on
a CUDA device the region is captured as one CUDA graph and replayed
(``graphs.py``). ``TreeEngine.step`` runs one round as one region and
reads its counts back once. ``TreeEngine(graphs=False)`` runs the same
code eagerly, reading each condition back. The caches are updated in
place; a state is not reusable after a step unless it was cloned first.

``TreeEngine(mesh=, shard_seq=)`` runs the engine as one rank of a
``parallel.mesh.Mesh``, as ``Engine(mesh=)`` does (``spectree.py:68-117``,
``:248-266``): the params are this rank's shards, the full cache holds its
KV heads and, with ``shard_seq``, its slots (split over ``sp``), the tree
retrieval cache its heads; the grow, the verify under the ancestor mask,
the path compaction and the tail refresh issue the collectives. Every rank
draws the same uniforms, so every rank emits the same tokens.

Random draws come from the state's ``torch.Generator``: each round draws
its uniforms in one call at its top (``_draw_parts``): per grow level a
Gumbel block ``[R, V]`` (R = the widest level's root count, every level
alike), per walk depth ``max_children`` coins, the j-th for the test of
the node's j-th child, then the ``V`` of the residual / bonus sample;
every round draws all of them, used or not.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional, Tuple

import numpy as np
import torch

from .. import graphs as graphs_mod
from ..cache import (KVCache, RetrievalCache, gather_kv_incremental, init_kv,
                     init_tree_retrieval, retrieval_tail_refresh, write_at)
from ..config import ModelConfig, SpecConfig, refuse_hybrid, resolve_device
from ..engine import _draws, _row, append_graphed, dense_weights, \
    prefill_chunks
from ..models import llama
from ..ops import sampling
from ..parallel import sharding
from ..parallel.mesh import Mesh
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
    """``tokens`` stays on the device; the rest are host values (the
    round's one read-back)."""
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
    True on the CPU raises.

    ``mesh`` / ``shard_seq`` as ``Engine``'s: this process is one rank of
    the mesh, on ``mesh.device``; the params may be the full weights (cut
    here) or this rank's shards; with ``shard_seq`` the full cache's
    length is padded to a multiple of ``sp * chunk_size``. A mesh whose
    collectives cannot be captured (gloo on a card) needs
    ``graphs=False``."""

    def __init__(self, cfg: ModelConfig, grow_map: GrowMap, params, *,
                 prefill: int, max_cache_len: int, budget: int = 4096,
                 chunk_size: int = 8, temperature: float = 0.6,
                 top_p: float = 0.9, eos_ids=(0, 2), dtype=torch.bfloat16,
                 prefill_chunk: int = 128, kv_quant: bool = False,
                 weight_quant: bool = False, ssl: int = 0, mesh=None,
                 shard_seq: bool = False, device=None, graphs=None):
        refuse_hybrid(cfg, "TreeEngine")
        if prefill % chunk_size or budget % chunk_size:
            raise ValueError("prefill and budget must be multiples of "
                             "chunk_size")
        if not 0 <= ssl <= cfg.num_layers:
            raise ValueError(f"ssl {ssl} outside [0, {cfg.num_layers}]")
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                                f"{type(mesh).__name__}")
            device = mesh.device if device is None else device
        self.device = resolve_device(device)
        if mesh is not None and self.device != mesh.device:
            raise ValueError(f"the engine is on {self.device}, its mesh on "
                             f"{mesh.device}")
        if params["embed"].device != self.device:
            raise ValueError(f"params are on {params['embed'].device}, "
                             f"engine on {self.device}")
        self.mesh = mesh
        self.shard_seq = bool(shard_seq) and mesh is not None
        self.graphs = graphs_mod.GraphSet(self.device, graphs)
        if mesh is not None and self.graphs.mode == "graph" \
                and not mesh.capturable:
            raise ValueError(f"{mesh.backend} collectives cannot be captured "
                             f"in a CUDA graph: pass graphs=False")
        self.cfg = cfg
        self.gm = grow_map
        self.prefill = prefill
        (self.W, self.K, roots, widths, starts, tok_root, tok_rank,
         depth_rows, mask_rows) = _padded_levels(grow_map)
        # the padded grow width W is reserved past the tree region of both
        # caches, so that the last levels' fixed-width writes never slide
        # back over committed tree slots
        max_cache_len += grow_map.size + self.W
        if self.shard_seq:
            unit = mesh.shape["sp"] * chunk_size
            max_cache_len = -(-max_cache_len // unit) * unit
        self.max_cache_len = max_cache_len
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
        if mesh is not None and not sharding.is_local(params, mesh, cfg):
            params = sharding.shard_params(params, mesh, cfg)
        if weight_quant:                               # unless already codes
            params = llama.quantize_weights(params, mesh, cfg)
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

    # ------------------------------------------------------------------

    @property
    def fwd(self) -> dict:
        """The mesh arguments of the target's full-cache forwards."""
        return dict(mesh=self.mesh, shard_seq=self.shard_seq)

    def init_state(self, seed: int) -> TreeState:
        """A fresh state; over a mesh its caches have this rank's local
        shapes (``sharding.tree_state_shardings``)."""
        dev = self.device
        cfg, slots = self.cfg, self.max_cache_len
        if self.mesh is not None:
            sh = sharding.tree_state_shardings(self.mesh, cfg,
                                               self.shard_seq)
            _, _, hkv, slots, _ = sh["kv"]["k"].local_shape(
                (cfg.num_layers, 1, cfg.num_kv_heads, slots, cfg.head_dim))
            cfg = cfg.with_(num_kv_heads=hkv)
        kv = init_kv(cfg, slots, dtype=self.dtype, device=dev,
                     quant=self.kv_quant)
        rkv = init_tree_retrieval(cfg, self.budget, self.gm.size,
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
                            input_ids[:, :-1], self.prefill_chunk,
                            **self.fwd)
        logits, kv = append_graphed(
            self.graphs, self.cfg, self.params, kv, input_ids[:, -1:],
            build_rkv=state.rkv, prefill=self.prefill,
            chunk_size=self.chunk_size, budget=self.budget, **self.fwd)
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
        """One tree round as one graph region (its walk's bodies if-nodes
        once captured), then one read-back of its counts."""
        parts = _draw_parts(self)
        gen = state.gen

        def region(next_token, seq_len):
            u = _draws(parts, gen, next_token.device)
            o = _tree_body(self, dataclasses.replace(
                state, next_token=next_token,
                kv=dataclasses.replace(state.kv, seq_len=seq_len)), u,
                force_accept)
            return o["tokens"], _counts_of(o), o["seq_len"], o["next_token"]

        tokens, c, seq_len, next_token = self.graphs.run(
            "tree", region, (state.next_token, state.kv.seq_len),
            caches=graphs_mod.planes(state.kv, state.rkv), gens=(gen,),
            extra=(force_accept, self.ssl))
        n_emitted, n_nodes, terminal, eos = self.graphs.read(c).tolist()
        new_state = dataclasses.replace(
            state, kv=dataclasses.replace(state.kv, seq_len=seq_len),
            next_token=next_token)
        return new_state, TreeStepStats(
            tokens=tokens, n_emitted=n_emitted, n_nodes=n_nodes,
            terminal=bool(terminal), eos=bool(eos), readbacks=1)

    def _gen(self, state: TreeState, max_len: int, force_accept):
        """The generation loop on the device, as ``Engine._gen``: ``max_len``
        calls of one loop region whose step runs as a conditional body
        while ``n < max_len + 1`` and no terminal step (forced runs never
        stop on the terminal flag: the coin walk can zero the residual by
        chance, which would end a timing run early); one read-back at the
        end. Counters: [steps, nodes, host read-backs of the call]."""
        g, dev = self.graphs, self.device
        slack = self.max_path + 1
        caches = graphs_mod.planes(state.kv, state.rkv)
        i64 = dict(dtype=torch.int64, device=dev)
        lb = g.buffers("tree gen", caches, lambda: dict(
            buf=torch.empty((max_len + slack,), **i64),
            n=torch.empty((), **i64),
            stop=torch.empty((), dtype=torch.bool, device=dev),
            counters=torch.empty((2,), **i64),
            seq_len=torch.empty_like(state.kv.seq_len),
            next_token=torch.empty_like(state.next_token)), extra=(max_len,))
        r0 = g.readbacks
        lb["buf"].fill_(JUNK_TOKEN)
        lb["buf"][:1] = state.next_token[:1]
        lb["n"].fill_(1)
        lb["stop"].fill_(False)
        lb["counters"].zero_()
        lb["seq_len"].copy_(state.kv.seq_len)
        lb["next_token"].copy_(state.next_token)
        parts = _draw_parts(self)
        gen = state.gen
        st = dataclasses.replace(
            state, next_token=lb["next_token"],
            kv=dataclasses.replace(state.kv, seq_len=lb["seq_len"]))

        def region():
            u = _draws(parts, gen, dev)

            def step():
                o = _tree_body(self, st, u, force_accept)
                write_at(lb["buf"], o["tokens"], lb["n"], 0)
                lb["n"].add_(o["n_emitted"])
                lb["counters"].add_(torch.stack([torch.ones_like(
                    o["n_nodes"]), o["n_nodes"]]))
                lb["seq_len"].copy_(o["seq_len"])
                lb["next_token"].copy_(o["next_token"])
                if force_accept is None:
                    lb["stop"].copy_(o["terminal"])
            g.cond((lb["n"] < max_len + 1) & ~lb["stop"], step)
            return ()

        for _ in range(max_len):
            g.run("tree gen", region, (), caches=caches + tuple(lb.values()),
                  gens=(gen,), extra=(force_accept, self.ssl, max_len),
                  capture_first=True)
        host = g.read(torch.cat([lb["buf"], lb["n"].reshape(1),
                                 lb["counters"],
                                 lb["stop"].long().reshape(1)]))
        size = max_len + slack
        steps, nodes = host[size + 1:size + 3].tolist()
        state = dataclasses.replace(
            state, next_token=lb["next_token"].clone(),
            kv=dataclasses.replace(state.kv, seq_len=lb["seq_len"].clone()))
        counters = np.array([steps, nodes, g.readbacks - r0], np.int64)
        return state, host[:size], int(host[size]), counters, \
            bool(host[size + 3])

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


def _is_eos(tok: torch.Tensor, eos_ids: tuple) -> torch.Tensor:
    """Elementwise membership of ``tok`` in ``eos_ids`` (which may be
    empty)."""
    m = torch.zeros_like(tok, dtype=torch.bool)
    for e in eos_ids:
        m = m | (tok == e)
    return m


def _draw_parts(eng: TreeEngine) -> tuple:
    """The named blocks of one tree step's uniforms (``engine._draws``):
    per grow level a Gumbel block [R, V] (R = the widest level's root
    count, every level alike), per walk depth the ``max_children`` coins
    of that node's child tests, the V of the residual / bonus sample."""
    vocab = eng.cfg.vocab_size
    return (("grow", (eng.gm.num_levels, eng._roots.shape[1], vocab)),
            ("walk", (eng.max_path, eng.gm.max_children)),
            ("final", (vocab,)))


def _grow(eng: TreeEngine, state: TreeState):
    """The grow of a step from ``state`` alone (for checks): draws the
    step's uniforms from the state's generator, as the step does first,
    and returns ``_grow_body``'s (verify_tokens [size], draft_logits
    [size, V])."""
    u = _draws(_draw_parts(eng), state.gen, eng.device)
    return _grow_body(eng, state, u["grow"])


def _grow_body(eng: TreeEngine, state: TreeState, u):
    """Build the token tree through the middle model. All levels run at the
    padded width W (``_padded_levels``): per level, per-root Gumbel-top-k
    (the Gumbel noise from the level's uniforms ``u[lvl]`` [R, V]) samples
    children WITHOUT replacement from softmax(draft_logits / T), then one
    middle forward of the padded frontier. Padded slots carry junk
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
    verify_tokens[:1] = state.next_token[:1]
    draft_logits = torch.zeros((size + W, cfg.vocab_size),
                               dtype=torch.float32, device=dev)

    def forward(toks, depths, amask, slot_start, staged_len):
        logits, _, _ = llama.forward_tree_spec(
            cfg, eng.params, toks[None], state.rkv, kv_seq_len, eng.budget,
            depths=depths, ancestor_mask=amask, slot_start=slot_start,
            kv=state.kv, ssl=eng.ssl, staged_len=staged_len, act_quant=aq,
            **eng.fwd)
        return logits[0].float()

    draft_logits[0] = forward(state.next_token, eng._depth[0:1],
                              eng._mask[0:1], 0, 0)[0]
    for lvl, start in enumerate(eng._starts):
        root_logits = draft_logits[eng._roots[lvl]] / eng.temperature
        g = sampling.gumbel_u(u[lvl])
        cand = sampling.topk_small(root_logits + g, eng.K)       # [R, K]
        toks = cand[eng._tok_root[lvl], eng._tok_rank[lvl]]      # [W]
        toks = torch.where(eng._live[lvl], toks, JUNK_TOKEN)
        verify_tokens[start:start + W] = toks
        draft_logits[start:start + W] = forward(
            toks, eng._depth_rows[lvl], eng._mask_rows[lvl], start, size)
    return verify_tokens[:size], draft_logits[:size]


def _verify(eng: TreeEngine, kv: KVCache, verify_tokens):
    """ONE full-cache target forward over all tree nodes under the
    ancestor mask (their KV lands at ``seq_len + i``, in place) and the
    filtered target rows: returns (p_all [size, V], kv length after the
    forward)."""
    logits_t, kv_out, _ = llama.forward_append(
        eng.cfg, eng.params, verify_tokens[None], kv,
        positions=kv.seq_len.to(torch.int64) + eng._depth,
        tree_mask=eng._mask, **eng.fwd)
    # row by row the same function; chunked to bound the top-p filter's
    # [rows, V, grid] intermediate
    p_all = torch.cat([sampling.norm_logits(c, eng.temperature, -1,
                                            eng.top_p)
                       for c in logits_t[0].split(32)])      # [size, V]
    return p_all, kv_out.seq_len


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


def _tree_body(eng: TreeEngine, state: TreeState, u,
               force_accept: Optional[float] = None) -> dict:
    """One full tree round on the device: grow -> verify -> accept walk ->
    commit, as the JAX round (``triforce_tpu/tree/spectree.py:165-221``,
    its walk a ``while_loop`` over child tests, ``:445-500``).

    The walk is ``max_path`` conditional bodies (``GraphSet.cond``), one
    per depth, each running while the walk goes on: the node's child
    tests on its coins ``u["walk"][d]``, then, where a child is chosen, its
    id written at the device offset ``n_nodes`` of ``accept_idx``. The
    residual / bonus is sampled whether or not it is used and chosen with
    ``torch.where``; the commit takes device counts. Nothing is read back.

    ``force_accept``: controlled-acceptance validation. Every per-child
    accept test in the walk becomes a coin flip at that rate while ALL real
    compute runs (grow levels, full-cache tree verify, residual updates,
    path compaction, tail refresh). The output is NOT lossless."""
    cfg, gm, dev = eng.cfg, eng.gm, eng.device
    max_path = eng.max_path
    seq0 = state.kv.seq_len
    verify_tokens, draft_logits = _grow_body(eng, state, u["grow"])
    # --- ONE full-cache verify over all tree nodes
    p_all, seq_len = _verify(eng, state.kv, verify_tokens)

    # --- accept walk with residual updates, one body per depth
    i64 = dict(dtype=torch.int64, device=dev)
    cur = torch.zeros((), **i64)
    n_nodes = torch.ones((), **i64)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    eos_hit = torch.zeros((), dtype=torch.bool, device=dev)
    accept_idx = torch.zeros((max_path,), **i64)
    final_p = torch.zeros((cfg.vocab_size,), dtype=torch.float32, device=dev)

    def node(d):
        p, chosen = _child_tests(eng, _row(p_all, cur), _row(draft_logits, cur),
                                 _row(eng._succ, cur), verify_tokens,
                                 u["walk"][d], force_accept)
        stop = chosen < 0          # a leaf, or every child rejected
        final_p.copy_(torch.where(stop, p, final_p))
        at = n_nodes.clamp(max=max_path - 1).reshape(1)
        accept_idx.index_copy_(0, at, torch.where(
            stop, accept_idx.index_select(0, at), chosen))
        hit = ~stop & _is_eos(_row(verify_tokens, chosen.clamp_min(0)),
                              eng.eos_ids)
        n_nodes.add_((~stop).long())
        cur.copy_(torch.where(stop, cur, chosen))
        eos_hit.logical_or_(hit)
        done.copy_(stop | hit)

    for d in range(max_path):
        eng.graphs.cond(~done, functools.partial(node, d))

    # --- residual / bonus sample; drawn even when unused
    no_final = eos_hit | (final_p.sum() <= 0)
    sampled = sampling.sample_u(final_p, u["final"])
    next_tok = torch.where(no_final, JUNK_TOKEN, sampled).reshape(1)
    # the residual / bonus sample can itself be EOS: it is still emitted,
    # but the loop must stop on it
    res_eos = ~no_final & _is_eos(sampled, eng.eos_ids)

    # --- commit: compact the accepted path, refresh the retrieval tail
    seq_mesh = eng.mesh if eng.shard_seq else None
    kv = gather_kv_incremental(dataclasses.replace(state.kv, seq_len=seq_len),
                               accept_idx, n_nodes, seq0, max_path,
                               max_span=gm.size, mesh=seq_mesh)
    retrieval_tail_refresh(
        state.rkv, kv, SpecConfig(budget=eng.budget, chunk_size=1),
        eng.prefill, seq0, max_new=max_path, mesh=seq_mesh)

    # --- emitted tokens: accepted children, then the sampled token
    pos = torch.arange(max_path + 1, device=dev)
    acc_toks = verify_tokens[accept_idx[(pos + 1).clamp_max(max_path - 1)]]
    emitted = torch.where(pos < n_nodes - 1, acc_toks, JUNK_TOKEN)
    emitted = torch.where(pos == n_nodes - 1, next_tok, emitted)
    return dict(tokens=emitted, n_emitted=n_nodes - 1 + (~no_final).long(),
                n_nodes=n_nodes, terminal=no_final | res_eos,
                eos=eos_hit | res_eos, seq_len=kv.seq_len,
                next_token=next_tok)


def _counts_of(out: dict) -> torch.Tensor:
    """[n_emitted, n_nodes, terminal, eos] of a tree step (int64)."""
    return torch.stack([out["n_emitted"], out["n_nodes"], out["terminal"],
                        out["eos"]]).to(torch.int64)


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
    out = buf[:n].tolist()             # the buffer is on the host
    wall = time.perf_counter() - t0 - clock.seconds
    assert out[0] == first
    steps, nodes = int(counters[0]), int(counters[1])
    gen = n - 1
    return DecodeResult(tokens=out, tokens_per_sec=gen / max(wall, 1e-9),
                        acceptance_rate=nodes / max(steps * engine.gm.size,
                                                    1),
                        avg_tokens_per_step=gen / max(steps, 1),
                        steps=steps, wall_s=wall, captures=clock.count,
                        capture_s=clock.seconds,
                        readbacks=int(counters[2]), **pre.fields)
