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

JAX clamps the start of ``dynamic_slice`` / ``dynamic_update_slice`` into
range; torch raises instead. ``slice_at`` and ``write_at`` reproduce the
clamp with device-side indices (no host sync).
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
    from ``seq_len`` (attention is masked by length, never re-sliced)."""

    k: torch.Tensor        # [L, B, H_kv, S_max, D] (model dtype, or int8)
    v: torch.Tensor
    seq_len: torch.Tensor  # 0-d int32
    k_scale: Optional[torch.Tensor] = None   # [L, B, H_kv, S_max] fp32
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def rollback(self, n) -> "KVCache":
        return dataclasses.replace(self, seq_len=self.seq_len - n)

    def clone(self) -> "KVCache":
        return KVCache(self.k.clone(), self.v.clone(), self.seq_len.clone(),
                       _clone(self.k_scale), _clone(self.v_scale))


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


def init_kv(cfg: ModelConfig, max_len: int, batch: int = 1,
            dtype=torch.bfloat16, device=None, quant: bool = False
            ) -> KVCache:
    device = resolve_device(device)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return KVCache(seq_len=_zero_len(device),
                   **_planes(shape, dtype, quant, device))


def init_retrieval(cfg: ModelConfig, spec: SpecConfig, batch: int = 1,
                   dtype=torch.bfloat16, device=None, quant: bool = False
                   ) -> RetrievalCache:
    """No ``pad_to``: the JAX package pads the slots only for TPU DMA
    blocks, and off the TPU it pads to 1."""
    device = resolve_device(device)
    real = spec.budget + spec.gamma + 1
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
    slots a JAX dynamic slice of ``size`` at ``start`` touches)."""
    start = torch.as_tensor(start, device=device).to(torch.int64)
    start = start.clamp(0, extent - size)
    return start + torch.arange(size, device=device)


def slice_at(x: torch.Tensor, start, size: int, dim: int) -> torch.Tensor:
    """``jax.lax.dynamic_slice_in_dim`` (start clamped into range)."""
    return x.index_select(dim, window(start, size, x.shape[dim], x.device))


def write_at(x: torch.Tensor, new: torch.Tensor, start, dim: int) -> None:
    """``jax.lax.dynamic_update_slice_in_dim``, in place on ``x``."""
    idx = window(start, new.shape[dim], x.shape[dim], x.device)
    x.index_copy_(dim, idx, new.to(x.dtype))


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
    The overflow test reads ``seq_len`` on the host (one sync per chunk)."""
    start, recent = spec.draft_start_size, spec.draft_recent_size
    cap = start + recent
    size_keep = recent - incoming
    if not bool(c_overflows(cache.seq_len, incoming, cap)):
        return cache
    src0 = cache.seq_len - size_keep
    write_at(cache.k, slice_at(cache.k, src0, size_keep, 3), start, 3)
    write_at(cache.v, slice_at(cache.v, src0, size_keep, 3), start, 3)
    return dataclasses.replace(
        cache, seq_len=torch.full_like(cache.seq_len, cap - incoming))


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
                           max_new: int | None = None) -> RetrievalCache:
    """Write tokens ``[new_from, kv.seq_len)`` of the full cache into the
    retrieval budget region at descending slots from
    ``budget - 1 - (new_from - prefill)`` (mod budget), in place. Mirrors
    the JAX function down to its clamped slices: the source window starts
    at ``clamp(new_from, 0, S - max_new)``. An int8 cache moves its codes
    and their scales alike (``triforce_tpu/cache.py:394-398``)."""
    if max_new is None:
        max_new = spec.gamma + 2
    budget = spec.budget
    new_from = torch.as_tensor(new_from, device=kv.k.device).to(torch.int64)
    n_new = kv.seq_len.to(torch.int64) - new_from
    base = torch.remainder(new_from - prefill, budget)
    blocks = _rolling_window_blocks(base, budget, max_new, n_new,
                                    rkv.k.shape[3])

    def one(rc, fc):
        toks = slice_at(fc, new_from, max_new, 3).flip(3)
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
