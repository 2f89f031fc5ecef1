"""Rotary position embeddings: classic Llama RoPE and YaRN NTK-by-parts.

Counterpart of ``triforce_tpu/models/rope.py``. Tables are pure functions of
the config, computed once in fp32 with numpy (the same arithmetic as the JAX
package, so both packages rotate with identical tables) and cached per
device. The rotation itself is ``ops/layer_glue.rope`` (a kernel on the
card that reads the table rows at device position tensors; its plain
version ``rope_plain`` on the CPU).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..config import ModelConfig, RopeConfig, resolve_device


def _yarn_get_mscale(scale: float) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * math.log(scale) + 1.0


def _yarn_find_correction_dim(num_rotations, dim, base, max_pos):
    return (dim * math.log(max_pos / (num_rotations * 2 * math.pi))) / (
        2 * math.log(base))


def _yarn_find_correction_range(low_rot, high_rot, dim, base, max_pos):
    low = math.floor(_yarn_find_correction_dim(low_rot, dim, base, max_pos))
    high = math.ceil(_yarn_find_correction_dim(high_rot, dim, base, max_pos))
    return max(low, 0), min(high, dim - 1)


def _yarn_linear_ramp(lo: float, hi: float, dim: int) -> np.ndarray:
    if lo == hi:
        hi += 0.001
    ramp = (np.arange(dim, dtype=np.float32) - lo) / (hi - lo)
    return np.clip(ramp, 0.0, 1.0)


def _effective_scale(rope: RopeConfig, max_len: int | None) -> float:
    """Scaling factor, with the dynamic kinds resolved once from the table
    length (keeps rotated-key caches consistent)."""
    if rope.kind in ("dynamic", "dynamic-yarn") and max_len:
        return max(float(max_len) / rope.original_max_position_embeddings,
                   1.0)
    return rope.scaling_factor


def inv_freq_for(rope: RopeConfig, head_dim: int,
                 max_len: int | None = None) -> np.ndarray:
    """Per-pair inverse frequencies, fp32, shape [head_dim // 2]."""
    pos_freqs = rope.theta ** (
        np.arange(0, head_dim, 2, dtype=np.float32) / head_dim)
    scale = _effective_scale(rope, max_len)
    if rope.kind == "llama":
        return 1.0 / pos_freqs
    if rope.kind == "linear":
        return 1.0 / (scale * pos_freqs)
    if rope.kind == "dynamic":
        orig = rope.original_max_position_embeddings
        seq = max(max_len, orig)
        mult = max(rope.scaling_factor * seq / orig
                   - (rope.scaling_factor - 1.0), 1.0)
        base = rope.theta * (mult ** (head_dim / (head_dim - 2)))
        return 1.0 / (base ** (
            np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    if rope.kind in ("yarn", "dynamic-yarn", "ntk-by-parts"):
        inv_extra = 1.0 / pos_freqs
        inv_interp = 1.0 / (scale * pos_freqs)
        low, high = _yarn_find_correction_range(
            rope.beta_fast, rope.beta_slow, head_dim, rope.theta,
            rope.original_max_position_embeddings)
        mask = (1.0 - _yarn_linear_ramp(low, high, head_dim // 2)
                ) * rope.extrapolation_factor
        return inv_interp * (1.0 - mask) + inv_extra * mask
    raise ValueError(f"Unknown RoPE kind {rope.kind!r}")


def mscale_for(rope: RopeConfig, max_len: int | None = None) -> float:
    if rope.kind in ("yarn", "dynamic-yarn"):
        return float(_yarn_get_mscale(_effective_scale(rope, max_len))
                     * rope.attn_factor)
    return 1.0


@functools.lru_cache(maxsize=16)
def _cos_sin_tables_np(rope: RopeConfig, head_dim: int, max_len: int):
    inv_freq = inv_freq_for(rope, head_dim, max_len=max_len)
    t = np.arange(max_len, dtype=np.float32)
    freqs = np.outer(t, inv_freq)                      # [S, D/2]
    emb = np.concatenate([freqs, freqs], axis=-1)      # [S, D]
    m = mscale_for(rope, max_len=max_len)
    return (np.cos(emb) * m).astype(np.float32), (np.sin(emb) * m).astype(
        np.float32)


@functools.lru_cache(maxsize=16)
def _cos_sin_tables_dev(rope: RopeConfig, head_dim: int, max_len: int,
                        device: torch.device):
    cos, sin = _cos_sin_tables_np(rope, head_dim, max_len)
    return (torch.from_numpy(cos).to(device),
            torch.from_numpy(sin).to(device))


def cos_sin_tables(config: ModelConfig, max_len: int | None = None,
                   device=None, local: bool = False):
    """Full fp32 [max_len, head_dim] cos/sin tables (YaRN mscale folded
    in), cached per (rope, head_dim, max_len, device). ``local``: the
    sliding-window layers' tables (``config.rope_local`` where a hybrid
    configuration has one). ``device=None`` means the first CUDA card and
    raises without one."""
    max_len = max_len or config.max_position_embeddings
    rope = config.rope
    if local and getattr(config, "rope_local", None) is not None:
        rope = config.rope_local
    return _cos_sin_tables_dev(rope, config.head_dim, max_len,
                               resolve_device(device))
