"""KV-cache state for the PyTorch port — the port of
``triforce_tpu/cache.py``.

Layouts are the JAX package's, head-major ``[num_layers, batch,
num_kv_heads, slots, head_dim]``. JAX carries immutable pytrees and donates
buffers; here the large buffers (``k``, ``v``) are updated IN PLACE by the
functions that write them (the forwards' commits, the window compaction,
the tail refresh), which keeps one copy of each multi-GB cache on the card.
``seq_len`` is a 0-d int32 tensor on the cache's device, replaced (never
mutated) on every change, so a caller may keep an old length around.

The target's caches may be INT8-quantized (``quant=True``): ``k``/``v``
then hold int8 codes and ``k_scale``/``v_scale`` the fp32 scale of each
(layer, batch, head, token), ``quantize_tokens`` / ``dequantize`` being
the codec. The drafter's streaming cache is never quantized.

Row-stacked caches (batched speculation and serving) are the same three
classes with a leading row axis: buffers ``[rows, num_layers, num_kv_heads,
slots, head_dim]`` (scales without the last axis) and ``seq_len`` [rows].
They are built by ``init_kv_rows`` / ``init_retrieval_rows`` /
``init_streaming_rows``; ``write_row`` overwrites one row in place from a
batch-1 cache, ``row_view`` hands one row out as a batch-1 cache that
shares the pool's buffers, and ``batched_commit_and_refresh`` /
``streaming_evict_for_spec_rows`` are the per-row choreography of a batched
speculation step.

JAX clamps the start of ``dynamic_slice`` / ``dynamic_update_slice`` into
range; torch raises instead. ``slice_at`` and ``write_at`` reproduce the
clamp with device-side indices (no host sync).

Over a mesh (``parallel/``) a full cache may hold only this rank's slots,
``[sp_index * S_loc, (sp_index + 1) * S_loc)`` of the global cache
(``shard_seq``), while its ``seq_len`` stays global. ``write_window_sharded``
and ``slice_sharded`` are ``write_at`` and ``slice_at`` of the global cache
on such a shard: each rank writes the slots it owns, and a read sums every
rank's owned slots (zeros elsewhere) with one ``all_reduce`` over ``sp``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .config import ModelConfig, SpecConfig, resolve_device


def _clone(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if x is None else x.clone()


@dataclasses.dataclass
class KVCache:
    """Full (target) KV cache; keys stored rotated. ``rollback`` subtracts
    from ``seq_len`` (attention is masked by length, never re-sliced).

    A model with sliding-window layers (``config.HybridConfig``) keeps two
    kinds of state side by side, under the one ``seq_len``: ``k``/``v``
    hold its full-attention layers only, and ``ring_k``/``ring_v`` its
    sliding layers, each a ring of R slots where position p lives at slot
    p mod R (``ring_slots``). R is the window plus the most tokens one
    forward appends, so a forward that writes positions L .. L+T-1 over a
    ring holding L tokens overwrites only positions below L - window + 1,
    which no query from L on sees: after any forward and any rollback to
    a length L' >= L, the ring's slots of positions L' - window .. L' - 1
    hold exactly those positions."""

    k: torch.Tensor        # [L, B, H_kv, S_max, D] (model dtype, or int8)
    v: torch.Tensor
    seq_len: torch.Tensor  # 0-d int32
    k_scale: Optional[torch.Tensor] = None   # [L, B, H_kv, S_max] fp32
    v_scale: Optional[torch.Tensor] = None
    ring_k: Optional[torch.Tensor] = None    # [L_sliding, B, H_kv, R, D]
    ring_v: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def ring_slots(self) -> int:
        return 0 if self.ring_k is None else self.ring_k.shape[3]

    def rollback(self, n) -> "KVCache":
        return dataclasses.replace(self, seq_len=self.seq_len - n)

    def clone(self) -> "KVCache":
        return KVCache(self.k.clone(), self.v.clone(), self.seq_len.clone(),
                       _clone(self.k_scale), _clone(self.v_scale),
                       _clone(self.ring_k), _clone(self.ring_v))


@dataclasses.dataclass
class RetrievalCache:
    """Middle-model sparse cache: ``budget`` selected slots + ``gamma + 1``
    speculation scratch slots. The tail refresh writes generated tokens at
    descending slots from ``budget - 1`` as a rolling window."""

    k: torch.Tensor  # [L, B, H_kv, budget + gamma + 1, D] (or int8)
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None   # [L, B, H_kv, real_budget]
    v_scale: Optional[torch.Tensor] = None

    @property
    def real_budget(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def clone(self) -> "RetrievalCache":
        return RetrievalCache(self.k.clone(), self.v.clone(),
                              _clone(self.k_scale), _clone(self.v_scale))


@dataclasses.dataclass
class StreamingCache:
    """Drafter StreamingLLM cache: ``start`` sink slots + ``recent`` window
    + ``gamma + 3`` fixed speculation slots; keys stored UN-rotated and
    re-rotated with slot-index positions every forward."""

    k: torch.Tensor        # [L, B, H_kv, start + recent + gamma + 3, D]
    v: torch.Tensor
    seq_len: torch.Tensor  # 0-d int32: prefill fill level

    @property
    def real_budget(self) -> int:
        return self.k.shape[3]

    def clone(self) -> "StreamingCache":
        return StreamingCache(self.k.clone(), self.v.clone(),
                              self.seq_len.clone())


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------

# ``device=None`` means the first CUDA card, and raises without one
# (``config.resolve_device``); pass ``device="cpu"`` to build on the host.

def _zero_len(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def _planes(shape, dtype, quant: bool, device) -> dict:
    """k/v buffers of ``shape`` (int8 codes when ``quant``) and, when
    ``quant``, their fp32 per-token scale planes."""
    if quant:
        return dict(k=torch.zeros(shape, dtype=torch.int8, device=device),
                    v=torch.zeros(shape, dtype=torch.int8, device=device),
                    k_scale=torch.zeros(shape[:4], dtype=torch.float32,
                                        device=device),
                    v_scale=torch.zeros(shape[:4], dtype=torch.float32,
                                        device=device))
    return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device))


RING_SLACK = 512   # a sliding layer's ring: the window + this many slots


def init_kv(cfg: ModelConfig, max_len: int, batch: int = 1,
            dtype=torch.bfloat16, device=None, quant: bool = False,
            ring_slack: int = RING_SLACK) -> KVCache:
    """A full cache over the model's full-attention layers (every layer of
    a plain model) and, for a model with sliding layers, a ring of
    ``sliding_window + ring_slack`` slots each (``ring_slack``: the most
    tokens one forward appends)."""
    device = resolve_device(device)
    shape = (cfg.num_full_layers, batch, cfg.num_kv_heads, max_len,
             cfg.head_dim)
    ring = {}
    if cfg.windowed:
        if quant:
            raise NotImplementedError("int8 caches of sliding-window "
                                      "layers are not implemented")
        rshape = (len(cfg.plan.sliding), batch, cfg.num_kv_heads,
                  cfg.sliding_window + ring_slack, cfg.head_dim)
        ring = dict(ring_k=torch.zeros(rshape, dtype=dtype, device=device),
                    ring_v=torch.zeros(rshape, dtype=dtype, device=device))
    return KVCache(seq_len=_zero_len(device),
                   **_planes(shape, dtype, quant, device), **ring)


def ring_index(seq_len, t: int, ring: int, device) -> torch.Tensor:
    """The ring slots ``(seq_len + j) mod ring`` of the ``t`` tokens a
    forward appends after ``seq_len`` (a 0-d device tensor or an int)."""
    start = device_scalar(seq_len, device)
    return torch.remainder(start + torch.arange(t, device=device), ring)


def init_retrieval(cfg: ModelConfig, spec: SpecConfig, batch: int = 1,
                   dtype=torch.bfloat16, device=None, quant: bool = False
                   ) -> RetrievalCache:
    """No ``pad_to``: the JAX package pads the slots only for TPU DMA
    blocks, and off the TPU it pads to 1. One plane a full-attention
    layer (sliding layers read their ring exactly)."""
    device = resolve_device(device)
    real = spec.budget + spec.gamma + 1
    shape = (cfg.num_full_layers, batch, cfg.num_kv_heads, real,
             cfg.head_dim)
    return RetrievalCache(**_planes(shape, dtype, quant, device))


def init_tree_retrieval(cfg: ModelConfig, budget: int, tree_size: int,
                        batch: int = 1, dtype=torch.bfloat16, device=None,
                        quant: bool = False, pad: int = 0) -> RetrievalCache:
    """Tree-speculation retrieval cache: ``budget`` selected slots +
    ``tree_size`` scratch slots (node i of the tree at ``budget + i``) +
    ``pad`` junk slots past the tree region, so that the padded-width grow
    levels (``tree/spectree.py``) can write their fixed-width blocks
    without running over the end."""
    device = resolve_device(device)
    real = budget + tree_size + pad
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, real, cfg.head_dim)
    return RetrievalCache(**_planes(shape, dtype, quant, device))


def init_streaming(cfg: ModelConfig, spec: SpecConfig, batch: int = 1,
                   dtype=torch.bfloat16, device=None) -> StreamingCache:
    device = resolve_device(device)
    real =spec.draft_start_size + spec.draft_recent_size + spec.gamma + 3
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, real, cfg.head_dim)
    return StreamingCache(k=torch.zeros(shape, dtype=dtype, device=device),
                          v=torch.zeros(shape, dtype=dtype, device=device),
                          seq_len=_zero_len(device))


def init_kv_rows(cfg: ModelConfig, max_len: int, rows: int,
                 dtype=torch.bfloat16, device=None, quant: bool = False
                 ) -> KVCache:
    """A pool of ``rows`` full caches [rows, L, Hkv, max_len, D], every
    row empty (``seq_len`` [rows] of zeros)."""
    device = resolve_device(device)
    shape = (rows, cfg.num_layers, cfg.num_kv_heads, max_len, cfg.head_dim)
    return KVCache(seq_len=torch.zeros((rows,), dtype=torch.int32,
                                       device=device),
                   **_planes(shape, dtype, quant, device))


def init_retrieval_rows(cfg: ModelConfig, spec: SpecConfig, rows: int,
                        dtype=torch.bfloat16, device=None,
                        quant: bool = False) -> RetrievalCache:
    device = resolve_device(device)
    real = spec.budget + spec.gamma + 1
    shape = (rows, cfg.num_layers, cfg.num_kv_heads, real, cfg.head_dim)
    return RetrievalCache(**_planes(shape, dtype, quant, device))


def init_streaming_rows(cfg: ModelConfig, spec: SpecConfig, rows: int,
                        dtype=torch.bfloat16, device=None) -> StreamingCache:
    device = resolve_device(device)
    real = spec.draft_start_size + spec.draft_recent_size + spec.gamma + 3
    shape = (rows, cfg.num_layers, cfg.num_kv_heads, real, cfg.head_dim)
    return StreamingCache(k=torch.zeros(shape, dtype=dtype, device=device),
                          v=torch.zeros(shape, dtype=dtype, device=device),
                          seq_len=torch.zeros((rows,), dtype=torch.int32,
                                              device=device))


_PLANES = ("k", "v", "k_scale", "v_scale")


def set_entry(vec: torch.Tensor, slot: int, value) -> torch.Tensor:
    """A copy of a per-row vector with entry ``slot`` set (lengths and the
    other small per-row vectors are replaced, never mutated)."""
    out = vec.clone()
    out[slot] = value
    return out


def write_row(pool, slot: int, row):
    """Overwrite row ``slot`` of a row-stacked cache with a batch-1 cache
    of the same kind ([L, 1, Hkv, S, D] buffers), in place on the pool's
    buffers: admission touches one row's bytes and never copies the pool.
    Returns the pool with that row's length set."""
    for name in _PLANES:
        src = getattr(row, name, None)
        if src is not None:
            getattr(pool, name)[slot].copy_(src[:, 0])
    if hasattr(pool, "seq_len"):
        return dataclasses.replace(
            pool, seq_len=set_entry(pool.seq_len, slot, row.seq_len))
    return pool


def row_view(pool, slot: int):
    """Row ``slot`` of a row-stacked cache as a batch-1 cache
    ([L, 1, Hkv, S, D]) that shares the pool's buffers."""
    kw = {name: getattr(pool, name)[slot].unsqueeze(1) for name in _PLANES
          if getattr(pool, name, None) is not None}
    if hasattr(pool, "seq_len"):
        kw["seq_len"] = pool.seq_len[slot].clone()
    return type(pool)(**kw)


def stack_rows(rows):
    """Row-stack batch-1 caches of one kind into a new row-stacked cache
    (holds the inputs and the copy at once: pools are built blank and
    filled with ``write_row`` instead)."""
    kw = {name: torch.stack([getattr(r, name)[:, 0] for r in rows])
          for name in _PLANES if getattr(rows[0], name, None) is not None}
    if hasattr(rows[0], "seq_len"):
        kw["seq_len"] = torch.stack([r.seq_len for r in rows])
    return type(rows[0])(**kw)


# ---------------------------------------------------------------------------
# INT8 codec (triforce_tpu/cache.py:125-137)
# ---------------------------------------------------------------------------

def int8_scale(amax: torch.Tensor, floor: float) -> torch.Tensor:
    """max(amax / 127, floor), the scale of symmetric int8 codes, with an
    IEEE division: PyTorch multiplies a CUDA tensor divided by a Python
    number by the number's reciprocal instead, which can land one ulp off
    the division the JAX package and the CUDA kernels make."""
    return (amax / torch.full_like(amax, 127.0)).clamp_min(floor)


def quantize_tokens(x: torch.Tensor):
    """Symmetric int8 per-token-per-head quantization of [..., T, D]
    values: scale = max|x| / 127 over D (at least 1e-8), codes rounded half
    to even like ``jnp.round``. Returns (codes int8, scales fp32 [..., T])."""
    xf = x.float()
    scale = int8_scale(xf.abs().amax(-1), 1e-8)
    codes = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return codes.to(torch.int8), scale


def dequantize(codes: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return (codes.float() * scale[..., None].float()).to(dtype)


# ---------------------------------------------------------------------------
# Clamped dynamic slices (JAX semantics) with device-side starts
# ---------------------------------------------------------------------------

def window(start, size: int, extent: int, device) -> torch.Tensor:
    """Indices ``clamp(start, 0, extent - size) + arange(size)`` (the
    slots a JAX dynamic slice of ``size`` at ``start`` touches). A host
    int start is clamped on the host and the indices filled on the device
    (no copy from host memory, so the call can be captured in a graph)."""
    if not torch.is_tensor(start):
        start = min(max(int(start), 0), extent - size)
        return torch.arange(start, start + size, device=device)
    start = start.to(device=device, dtype=torch.int64)
    start = start.clamp(0, extent - size)
    return start + torch.arange(size, device=device)


def device_scalar(x, device, dtype=torch.int64) -> torch.Tensor:
    """``x`` (a host number or a tensor) as a 0-d tensor of ``dtype`` on
    ``device``; a host number is filled on the device, never copied from
    host memory."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.full((), x, dtype=dtype, device=device)


def slice_at(x: torch.Tensor, start, size: int, dim: int) -> torch.Tensor:
    """``jax.lax.dynamic_slice_in_dim`` (start clamped into range)."""
    return x.index_select(dim, window(start, size, x.shape[dim], x.device))


def write_at(x: torch.Tensor, new: torch.Tensor, start, dim: int) -> None:
    """``jax.lax.dynamic_update_slice_in_dim``, in place on ``x``."""
    idx = window(start, new.shape[dim], x.shape[dim], x.device)
    x.index_copy_(dim, idx, new.to(x.dtype))


def write_window_sharded(x: torch.Tensor, new: torch.Tensor, start, mesh,
                         dim: int) -> None:
    """``write_at(global, new, start, dim)`` on this rank's shard ``x`` of
    a cache whose ``dim`` is split over ``sp``: the window's global start
    is clamped into the global cache, and the rank writes the window's
    slots that fall in its own; the others keep their values. One block of
    distinct slots is read, blended and written back, so a window that
    straddles two shards, or misses this one, needs no host decision."""
    s_loc, t = x.shape[dim], new.shape[dim]
    dev = x.device
    g0 = window(start, t, s_loc * mesh.shape["sp"], dev)[0]
    lo = g0 - mesh.index("sp") * s_loc          # the window, local frame
    wb = min(t, s_loc)
    slots = lo.clamp(0, s_loc - wb) + torch.arange(wb, device=dev)
    src = slots - lo
    own = (src >= 0) & (src < t)
    shape = [1] * x.dim()
    shape[dim] = wb
    vals = torch.where(own.reshape(shape),
                       new.index_select(dim, src.clamp(0, t - 1)).to(x.dtype),
                       x.index_select(dim, slots))
    x.index_copy_(dim, slots, vals)


def slice_sharded(x: torch.Tensor, start, size: int, mesh,
                  dim: int) -> torch.Tensor:
    """``slice_at(global, start, size, dim)`` read from the shards of a
    cache whose ``dim`` is split over ``sp``: each rank takes the window's
    slots it owns and zeros for the rest, and one ``all_reduce(SUM)`` over
    ``sp`` gives every rank the whole window (adding zeros is exact)."""
    s_loc = x.shape[dim]
    dev = x.device
    idx = window(start, size, s_loc * mesh.shape["sp"], dev) \
        - mesh.index("sp") * s_loc
    own = (idx >= 0) & (idx < s_loc)
    shape = [1] * x.dim()
    shape[dim] = size
    vals = torch.where(own.reshape(shape),
                       x.index_select(dim, idx.clamp(0, s_loc - 1)),
                       torch.zeros((), dtype=x.dtype, device=dev))
    return mesh.all_reduce(vals.contiguous(), "sp")


# ---------------------------------------------------------------------------
# Cache choreography (all in place on the cache buffers)
# ---------------------------------------------------------------------------

def c_overflows(seq_len, incoming: int, cap: int):
    return seq_len + incoming > cap


def streaming_evict_prefill(cache: StreamingCache, spec: SpecConfig,
                            incoming: int) -> StreamingCache:
    """Slide the drafter window before a prefill chunk lands, iff it would
    overflow ``start + recent``: keep the last ``recent - incoming`` tokens
    right after the sink and set ``seq_len = start + recent - incoming``.
    Decided on the device, as the JAX package's ``lax.cond``: without an
    overflow the kept window is copied onto itself (its bits unchanged),
    so no length is read back and the call can be captured in a graph."""
    start, recent = spec.draft_start_size, spec.draft_recent_size
    cap = start + recent
    size_keep = recent - incoming
    over = c_overflows(cache.seq_len, incoming, cap)
    src0 = torch.where(over, cache.seq_len - size_keep, start)
    write_at(cache.k, slice_at(cache.k, src0, size_keep, 3), start, 3)
    write_at(cache.v, slice_at(cache.v, src0, size_keep, 3), start, 3)
    return dataclasses.replace(cache, seq_len=torch.where(
        over, torch.full_like(cache.seq_len, cap - incoming),
        cache.seq_len))


def streaming_evict_for_spec(cache: StreamingCache, spec: SpecConfig,
                             count) -> StreamingCache:
    """Compact accepted speculative tokens back into the recent window
    after an outer step: the window becomes the ``recent`` slots ending at
    ``start + recent + count``."""
    start, recent = spec.draft_start_size, spec.draft_recent_size
    src0 = start + count
    write_at(cache.k, slice_at(cache.k, src0, recent, 3), start, 3)
    write_at(cache.v, slice_at(cache.v, src0, recent, 3), start, 3)
    return cache


def gather_kv_incremental(kv: KVCache, accept_idx: torch.Tensor, n_accept,
                          offset, max_accept: int, max_span: int,
                          mesh=None) -> KVCache:
    """Compact an accepted speculation-tree path in place: slot
    ``offset + accept_idx[j]`` moves to ``offset + j`` for ``j <
    n_accept``, and ``seq_len`` becomes ``offset + n_accept``.
    ``accept_idx`` is a fixed-size [max_accept] buffer of tree node ids in
    path order (junk beyond ``n_accept``); ``max_span`` bounds the appended
    region (the tree size). The block is read before it is written (the
    move overlaps itself); an int8 cache moves its scales too. Mirrors the
    JAX function down to its clamped slices. ``mesh``: the cache's slots
    are split over its ``sp`` axis; the span (which may straddle two
    shards) is read whole on every rank (``slice_sharded``) and each rank
    writes back the slots it owns (``write_window_sharded``)."""
    dev = kv.k.device
    offset = device_scalar(offset, dev)
    n_accept = device_scalar(n_accept, dev)
    sel0 = torch.arange(max_accept, device=dev) < n_accept
    idx = accept_idx[:max_accept].to(torch.int64).clamp(0, max_span - 1)

    def one(buf):
        block = slice_at(buf, offset, max_span, 3) if mesh is None \
            else slice_sharded(buf, offset, max_span, mesh, 3)   # a copy
        gathered = block.index_select(3, idx)
        sel = sel0.reshape((1, 1, 1, max_accept) + (1,) * (buf.dim() - 4))
        block[:, :, :, :max_accept] = torch.where(
            sel, gathered, block[:, :, :, :max_accept])
        if mesh is None:
            write_at(buf, block, offset, 3)
        else:
            write_window_sharded(buf, block, offset, mesh, 3)

    one(kv.k)
    one(kv.v)
    if kv.quantized:
        one(kv.k_scale)
        one(kv.v_scale)
    return dataclasses.replace(
        kv, seq_len=(offset + n_accept).to(torch.int32))


def _rolling_window_blocks(base, budget: int, t_new: int, n_new,
                           region_len: int):
    """Slot math of the rolling-window tail refresh. Generated token g lives
    at slot ``budget - 1 - (g mod budget)``; the ``t_new`` tokens starting
    at window offset ``base`` cover at most TWO contiguous slot blocks. For
    each block returns ``(lo_c, valid, qc)``: the clamped block start, the
    per-position write mask, and the clamped FLIPPED source index (position
    p writes flipped token ``qc[p]``, i.e. token ``t_new - 1 - qc[p]``)."""
    js = torch.arange(t_new, device=n_new.device)
    loA = budget - base - t_new          # unwrapped block (may underrun)
    blocks = []
    for wrapped in (False, True):
        lo = loA + (budget if wrapped else 0)
        lo_c = lo.clamp(0, region_len - t_new)
        shift = lo - lo_c
        q = js - shift
        jtok = t_new - 1 - q
        in_win = (base + jtok >= budget) if wrapped \
            else (base + jtok < budget)
        valid = (q >= 0) & (q < t_new) & (jtok >= 0) & (jtok < n_new) \
            & in_win
        blocks.append((lo_c, valid, q.clamp(0, t_new - 1)))
    return blocks


def retrieval_tail_refresh(rkv: RetrievalCache, kv: KVCache,
                           spec: SpecConfig, prefill: int, new_from,
                           max_new: int | None = None,
                           mesh=None) -> RetrievalCache:
    """Write tokens ``[new_from, kv.seq_len)`` of the full cache into the
    retrieval budget region at descending slots from
    ``budget - 1 - (new_from - prefill)`` (mod budget), in place. Mirrors
    the JAX function down to its clamped slices: the source window starts
    at ``clamp(new_from, 0, S - max_new)``. An int8 cache moves its codes
    and their scales alike (``triforce_tpu/cache.py:394-398``). ``mesh``:
    the full cache's slots are split over its ``sp`` axis
    (``slice_sharded`` reads the window; ``S`` is the global length)."""
    if max_new is None:
        max_new = spec.gamma + 2
    budget = spec.budget
    new_from = device_scalar(new_from, kv.k.device)
    n_new = kv.seq_len.to(torch.int64) - new_from
    base = torch.remainder(new_from - prefill, budget)
    blocks = _rolling_window_blocks(base, budget, max_new, n_new,
                                    rkv.k.shape[3])

    def one(rc, fc):
        toks = (slice_at(fc, new_from, max_new, 3) if mesh is None
                else slice_sharded(fc, new_from, max_new, mesh, 3)).flip(3)
        for lo_c, valid, qc in blocks:
            toks_c = toks.index_select(3, qc)
            old = slice_at(rc, lo_c, max_new, 3)
            sel = valid.reshape((1, 1, 1, max_new) + (1,) * (rc.dim() - 4))
            write_at(rc, torch.where(sel, toks_c.to(rc.dtype), old), lo_c, 3)

    one(rkv.k, kv.k)
    one(rkv.v, kv.v)
    if rkv.quantized:
        one(rkv.k_scale, kv.k_scale)
        one(rkv.v_scale, kv.v_scale)
    return rkv


# ---------------------------------------------------------------------------
# Row-stacked choreography of a batched speculation step
# ---------------------------------------------------------------------------

def streaming_evict_for_spec_rows(cache: StreamingCache, spec: SpecConfig,
                                  count: torch.Tensor) -> StreamingCache:
    """``streaming_evict_for_spec`` for every row of a row-stacked drafter
    cache, each with its own ``count`` [rows]: row b's window becomes the
    ``recent`` slots ending at ``start + recent + count[b]``. In place."""
    start, recent = spec.draft_start_size, spec.draft_recent_size
    dev = cache.k.device
    src0 = (start + count.to(torch.int64)).clamp(
        0, cache.real_budget - recent)
    idx = src0[:, None] + torch.arange(recent, device=dev)     # [rows, recent]
    rows = torch.arange(cache.k.shape[0], device=dev)[:, None]
    for buf in (cache.k, cache.v):
        moved = buf[rows, :, :, idx]                  # [rows, recent, L, H, D]
        buf[:, :, :, start:start + recent] = moved.permute(0, 2, 3, 1, 4)
    return cache


def _rows_window_sharded(old: torch.Tensor, t_new: int, s_loc: int, mesh):
    """Each row's commit window on this rank's shard of a cache whose slots
    are split over ``sp``: row b's ``t_new`` slots start at global
    ``old[b]`` clamped into the global cache. Returns (slots [rows, wb]:
    distinct local slots a row, src: the window position each would take,
    own: whether it lies in the window), as ``write_window_sharded``
    reads, blends and writes one block for a batch-1 cache."""
    dev = old.device
    g0 = old.clamp(0, s_loc * mesh.shape["sp"] - t_new)
    lo = g0 - mesh.index("sp") * s_loc           # the windows, local frame
    wb = min(t_new, s_loc)
    slots = lo.clamp(0, s_loc - wb)[:, None] + torch.arange(wb, device=dev)
    src = slots - lo[:, None]
    own = (src >= 0) & (src < t_new)
    return slots, src.clamp(0, t_new - 1), own


def batched_commit_and_refresh(kv: KVCache, rkv: RetrievalCache,
                               nk: torch.Tensor, nv: torch.Tensor,
                               old_lens: torch.Tensor, spec: SpecConfig,
                               prefill: int, mesh=None):
    """The write-back of a batched speculation step, in place on the
    row-stacked caches: every row's new K/V ``nk``/``nv`` [rows, L, Hkv, T,
    D] is committed at its own pre-step length ``old_lens`` [rows] (the
    whole T-token window; slots past the row's new length are dead and
    overwritten later), and the rolling-window retrieval tail refresh
    writes row b's tokens ``[old_lens[b], kv.seq_len[b])`` at descending
    slots from ``budget - 1 - (old_lens[b] - prefill) mod budget``.
    ``kv.seq_len`` [rows] is already the post-step length. int8 caches
    quantize the new K/V once and store the same codes and scales in both
    caches. The result is bit-identical to the batch-1 in-forward commit
    followed by ``retrieval_tail_refresh``: generated token g of a row
    lives at slot ``budget - 1 - (g mod budget)``, which is what that
    function's two clamped blocks write (``_rolling_window_blocks``).
    ``mesh``: the full cache's slots are split over its ``sp`` axis (the
    retrieval cache's never are): each row's window lands at its global
    slots, each rank writing the ones it owns through one block of
    distinct slots a row (``_rows_window_sharded``); the refresh reads the
    new K/V, not the full cache, so it needs no collective.
    Returns (kv, rkv), the caches passed in."""
    rows, _, _, t_new, _ = nk.shape
    budget = spec.budget
    dev = nk.device
    if kv.quantized:
        k8, ks = quantize_tokens(nk)
        v8, vs = quantize_tokens(nv)
        planes = ((kv.k, rkv.k, k8), (kv.v, rkv.v, v8),
                  (kv.k_scale, rkv.k_scale, ks), (kv.v_scale, rkv.v_scale, vs))
    else:
        planes = ((kv.k, rkv.k, nk.to(kv.k.dtype)),
                  (kv.v, rkv.v, nv.to(kv.v.dtype)))
    old = old_lens.to(torch.int64)
    js = torch.arange(t_new, device=dev)
    ri = torch.arange(rows, device=dev)[:, None]               # [rows, 1]
    # commit: row b's window starts at old[b], clamped into the cache
    if mesh is None:
        c_idx = old.clamp(0, kv.max_len - t_new)[:, None] + js  # [rows, T]
        src = own = None
    else:
        c_idx, src, own = _rows_window_sharded(old, t_new, kv.max_len, mesh)
    # refresh: token j of row b goes to slot budget-1-((base[b]+j) % budget)
    # when j < n_new[b]; other positions rewrite what the slot holds (the
    # T slots of a row are distinct, since T <= budget)
    n_new = kv.seq_len.to(torch.int64) - old
    base = torch.remainder(old - prefill, budget)
    r_idx = budget - 1 - torch.remainder(base[:, None] + js, budget)
    valid = js[None, :] < n_new[:, None]                       # [rows, T]
    for full, retr, new in planes:
        new = new.transpose(1, 3).transpose(2, 3)   # [rows, T, L, Hkv(, D)]
        if own is None:
            full[ri, :, :, c_idx] = new
        else:
            keep = own.reshape(own.shape + (1,) * (new.dim() - 2))
            full[ri, :, :, c_idx] = torch.where(keep, new[ri, src],
                                                full[ri, :, :, c_idx])
        sel = valid.reshape(valid.shape + (1,) * (new.dim() - 2))
        retr[ri, :, :, r_idx] = torch.where(sel, new, retr[ri, :, :, r_idx])
    return kv, rkv
