"""Fused decode attention — the port of ``triforce_tpu/ops/flash_decode.py``.

``flash_decode_append`` attends GT = G*T query rows per KV head to the live
prefix ``[0, k_len)`` of one layer's cache plus the Tn new tokens of this
forward under a ``[GT, Tn]`` mask, with an fp32 online softmax; the output
is fp32 ``[Hkv, GT, D]``. On a CUDA tensor it launches the hand-written
Hopper kernel in ``csrc/flash_decode.cu`` (bf16 only — anything else
raises); on a CPU tensor it takes ``flash_decode_append_plain``, the same
arithmetic in plain PyTorch, rounding where the TPU kernel rounds: q
pre-scaled by 1/sqrt(D) in fp32 and cast back to q's dtype, scores in fp32,
p cast to v's dtype before p.v.

The Pallas kernel's TPU-only machinery does not carry over: its 128-lane
pad of the new block, the VMEM-driven block choice and the 512/2048 cache
alignment gate. ``k_len`` stays on the device and is read by the kernel.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import _build

_NEG_INF = -1e30
_SOURCE = "flash_decode.cu"
_SMS = 132          # H100 SXM streaming multiprocessors
_CTA_ROWS = 64      # query rows per CTA of the split phase


def _scale(d: int) -> float:
    # float32(1/sqrt(d)), the factor the TPU kernel multiplies q by in fp32
    return float(np.float32(1.0 / math.sqrt(d)))


def flash_decode_append_plain(q, k, v, k_new, v_new, k_len, new_mask):
    """Plain PyTorch version of the kernel (same layout contract):
    q [Hkv, GT, D]; k/v [Hkv, S, D]; k_new/v_new [Hkv, Tn, D];
    new_mask [GT, Tn] bool (True = attend); k_len int or 0-d int tensor.
    -> [Hkv, GT, D] fp32."""
    d = q.shape[-1]
    qs = (q.float() * _scale(d)).to(q.dtype).float()
    cols = torch.arange(k.shape[1], device=q.device)
    sc = torch.einsum("hgd,hsd->hgs", qs, k.float())
    sc = torch.where(cols < k_len, sc, _NEG_INF)
    sn = torch.einsum("hgd,hnd->hgn", qs, k_new.float())
    sn = sn + torch.where(new_mask, 0.0, _NEG_INF)
    m = torch.maximum(sc.amax(-1, keepdim=True), sn.amax(-1, keepdim=True))
    p = torch.exp(sc - m)
    pn = torch.exp(sn - m)
    l = p.sum(-1, keepdim=True) + pn.sum(-1, keepdim=True)
    acc = (torch.einsum("hgs,hsd->hgd", p.to(v.dtype).float(), v.float())
           + torch.einsum("hgn,hnd->hgd", pn.to(v_new.dtype).float(),
                          v_new.float()))
    return acc / l.clamp_min(1e-37)


def pick_nsplit(hkv: int, gt: int, s: int) -> int:
    """Sequence splits of the kernel's first phase: enough CTAs for about
    four per SM, each split at least 256 keys long."""
    ctas = hkv * -(-gt // _CTA_ROWS)
    want = -(-4 * _SMS // ctas)
    return max(1, min(want, -(-s // 256), 64))


@functools.lru_cache(maxsize=None)
def _n_parts(gt: int, nsplit: int) -> int:
    """Partials per query row the kernel writes, as the library counts them
    (it alone decides; the wrapper sizes its scratch by this)."""
    return _build.lib(_SOURCE).tf_flash_decode_parts(gt, nsplit)


def _check_cuda_args(q, k, v, k_new, v_new, k_len, new_mask):
    tensors = {"q": q, "k": k, "v": v, "k_new": k_new, "v_new": v_new}
    for name, x in tensors.items():
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_decode kernel takes bf16; {name} is "
                            f"{x.dtype}")
        if x.dim() != 3 or x.stride(2) != 1:
            raise ValueError(f"{name} must be [H, rows, D] with unit "
                             f"stride in D, got {tuple(x.shape)} "
                             f"{x.stride()}")
    hkv, gt, d = q.shape
    if d not in (64, 128):
        raise ValueError(f"head_dim {d} not supported by the kernel")
    for name, x in (("k", k), ("v", v)):
        if (x.shape[0] != hkv or x.shape[2] != d or x.data_ptr() % 16
                or x.stride(0) % 8 or x.stride(1) % 8):
            raise ValueError(f"{name} {tuple(x.shape)} {x.stride()} is not "
                             "a 16-byte aligned [Hkv, S, D] cache layer")
    if k_new.shape != v_new.shape or k_new.shape[0] != hkv \
            or k_new.shape[2] != d:
        raise ValueError("k_new/v_new must be [Hkv, Tn, D]")
    if new_mask.dtype != torch.bool or new_mask.shape != (gt, k_new.shape[1]) \
            or not new_mask.is_contiguous() or new_mask.device != q.device:
        raise ValueError("new_mask must be a contiguous bool [GT, Tn] "
                         "tensor on q's device")
    if k_len.dtype != torch.int32 or k_len.numel() != 1 \
            or k_len.device != q.device:
        raise ValueError("k_len must be one int32 on q's device")


def flash_decode_append(q, k, v, k_new, v_new, k_len, new_mask):
    """Fused decode attention; see the module docstring. CUDA tensors
    launch the kernel (or raise); CPU tensors take the plain version.
    ``flash_decode_append.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_decode_append_plain(q, k, v, k_new, v_new, k_len,
                                         new_mask)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_decode for device {q.device}")
    if not torch.is_tensor(k_len):
        k_len = torch.tensor(k_len, dtype=torch.int32, device=q.device)
    _check_cuda_args(q, k, v, k_new, v_new, k_len, new_mask)
    hkv, gt, d = q.shape
    s, tn = k.shape[1], k_new.shape[1]
    nsplit = pick_nsplit(hkv, gt, s)
    parts = _n_parts(gt, nsplit)
    f32 = dict(dtype=torch.float32, device=q.device)
    m_part = torch.empty((hkv, gt, parts), **f32)
    l_part = torch.empty((hkv, gt, parts), **f32)
    acc_part = torch.empty((hkv, gt, parts, d), **f32)
    out = torch.empty((hkv, gt, d), **f32)
    err = _build.lib(_SOURCE).tf_flash_decode_bf16(
        q.data_ptr(), q.stride(0), q.stride(1),
        k.data_ptr(), k.stride(0), k.stride(1),
        v.data_ptr(), v.stride(0), v.stride(1),
        k_new.data_ptr(), k_new.stride(0), k_new.stride(1),
        v_new.data_ptr(), v_new.stride(0), v_new.stride(1),
        new_mask.data_ptr(), k_len.data_ptr(),
        m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
        out.data_ptr(), hkv, gt, tn, s, d, nsplit, _scale(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_decode kernel launch")
    flash_decode_append.launches += 1
    return out


flash_decode_append.launches = 0


@functools.lru_cache(maxsize=64)
def causal_mask(t: int, tn: int, groups: int, device) -> torch.Tensor:
    """[G*T, Tn] bool: query row i of each group attends new token j <= i
    (cached per shape and device; callers never write to it)."""
    rows = torch.arange(t, device=device)[:, None]
    cols = torch.arange(tn, device=device)[None, :]
    return (cols <= rows).repeat(groups, 1).contiguous()


def append_attention_kernel(q, k_cache, v_cache, k_new, v_new, *, k_len,
                            new_mask=None):
    """Counterpart of ``append_attention_pallas`` (B = 1, no cache mask):
    q [1, Hq, T, D]; k/v cache [1, Hkv, S, D] (one layer, a view is fine);
    k_new/v_new [1, Hkv, Tn, D]; new_mask [T, Tn] bool or None (causal).
    -> [1, Hq, T, D] in q's dtype."""
    b, hq, t, d = q.shape
    hkv = k_cache.shape[1]
    g = hq // hkv
    if b != 1:
        raise ValueError("the flash-decode kernel takes batch 1")
    tn = k_new.shape[2]
    if new_mask is None:
        nmask = causal_mask(t, tn, g, q.device)
    else:
        nmask = new_mask.to(torch.bool).repeat(g, 1).contiguous()
    qh = q[0].reshape(hkv, g * t, d)
    out = flash_decode_append(qh, k_cache[0], v_cache[0], k_new[0],
                              v_new[0], k_len, nmask)
    return out.reshape(1, hq, t, d).to(q.dtype)
