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

``flash_decode_append_int8`` is the same attention over an int8 cache
(codes plus fp32 per-token scales): the TPU kernel's ``quant`` branch, with
its own CUDA kernel in the same source and its own plain version,
``flash_decode_append_int8_plain``. That branch re-quantizes p per row over
each group of keys, so its result depends on the grouping; the plain
version takes the group as a parameter (the TPU kernel's block in the CPU
tests, ``KERNEL_GROUP`` against the CUDA kernel).

``flash_decode_append_batched`` (and ``..._batched_int8``) is the same
attention for B rows at once, the port of the TPU's row-batched kernel
``flash_decode_append_batched``: q ``[B, Hkv, GT, D]``, one cache layer per
row ``[B, Hkv, S, D]`` (any row, head and token strides: a layer of a
``[B, L, Hkv, S, D]`` pool is a view, so there is no layer index), a live
length per row ``k_len [B]`` and a mask per row ``[B, GT, Tn]`` (or one
``[GT, Tn]`` mask for all). A row with ``k_len = 0`` reads no cache and
returns the attention over its new block alone. On the card the rows are a
grid index of the same device code as the single-row kernel, one launch
pair for all rows; each row is split as the single-row kernel would split
it (``_plan`` does not look at B), so a row's result does not depend
on its companions and equals the single-row kernel's bit for bit. The
plain versions run the single-row plain version row by row.

``flash_decode_partials`` (and ``..._int8``) is the port of the TPU's
``flash_decode_partials``: the same walk over the live prefix WITHOUT the
new block and WITHOUT the normalisation. It returns the online-softmax
state ``(m [Hkv, GT], l [Hkv, GT], acc [Hkv, GT, D])`` fp32, mergeable with
``ops.attention.merge_partials``; an empty prefix gives ``(-1e30, 0, 0)``.
The tree grow's prefix attention runs it (``models/llama.py``). On the card
it is the first phase of the kernel above followed by a merge that stops
before the fold; the TPU kernel's ``layer`` argument is a view of the
stacked cache here.

Two device paths share every entry point: up to ``DECODE_ROWS`` = 16 query
rows per KV head (the decode shapes) a pipelined kernel whose sequence
splits fill one wave of the card (``decode_nsplit``), and above that the
wide path, whose CTAs take a q tile of 64 or 128 query rows on Hopper's
warpgroup products and whose splits fill whole waves (``wide_nsplit``);
both plans read the card's SM count and the built kernel's occupancy.

A sliding-window layer's cache is a ring (``ops/attention.py``): with
``window`` W > 0, ``k``/``v`` hold S = R ring slots, ``k_len`` is the
sequence length L, and query row r (token t = r mod T of the T new
tokens) sees slot s iff its age (L - 1 - s) mod R is at most W - 2 - t
and the slot holds a position (s < L). ``flash_decode_window`` takes it
through its own C entry point (``tf_flash_decode_window_bf16``), whose
tile loops are separate template instances: the full layers' launches
run code with no window test in it.

The Pallas kernel's TPU-only machinery does not carry over: its 128-lane
pad of the new block, the VMEM-driven block choice and the 512/2048 cache
alignment gate. ``k_len`` stays on the device and is read by the kernel.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..cache import int8_scale

_NEG_INF = -1e30
_SOURCE = "flash_decode.cu"
DECODE_ROWS = 16    # GT up to this takes the decode kernel (one mma row
                    # tile; csrc/flash_decode.cu's DECODE_ROWS)
_MAX_SPLITS = 1024  # splits the decode path's merge can weigh
_WIDE_MAX_SPLITS = 64   # cache splits the wide path's merge can weigh
_MIN_SPLIT_KEYS = 256
KERNEL_GROUP = 16   # keys per p re-quantization group of the int8 kernel


def _scale(d: int) -> float:
    # float32(1/sqrt(d)), the factor the TPU kernel multiplies q by in fp32
    return float(np.float32(1.0 / math.sqrt(d)))


def window_valid(rows, cols, k_len, slots: int, window: int):
    """Which ring slots ``cols`` query tokens ``rows`` see (module
    docstring): the slot holds a cached position (below ``k_len``) whose
    age ``(k_len - 1 - s) mod slots`` is at most ``window - 2 - row``."""
    age = torch.remainder(k_len - 1 - cols, slots)
    return (cols < k_len) & (age <= window - 2 - rows)


def flash_decode_append_plain(q, k, v, k_new, v_new, k_len, new_mask,
                              window: int = 0):
    """Plain PyTorch version of the kernel (same layout contract):
    q [Hkv, GT, D]; k/v [Hkv, S, D]; k_new/v_new [Hkv, Tn, D];
    new_mask [GT, Tn] bool (True = attend); k_len int or 0-d int tensor;
    ``window``: k/v are a sliding-window layer's ring. -> [Hkv, GT, D]
    fp32."""
    d = q.shape[-1]
    qs = (q.float() * _scale(d)).to(q.dtype).float()
    cols = torch.arange(k.shape[1], device=q.device)
    sc = torch.einsum("hgd,hsd->hgs", qs, k.float())
    if window:
        rows = torch.remainder(torch.arange(q.shape[1], device=q.device),
                               k_new.shape[1])[:, None]
        valid = window_valid(rows, cols[None, :], k_len, k.shape[1], window)
    else:
        valid = cols < k_len
    sc = torch.where(valid, sc, _NEG_INF)
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


def flash_decode_partials_plain(q, k, v, k_len):
    """Plain PyTorch version of the partials kernel: q [Hkv, GT, D]
    (pre-scaled here, rounded to q's dtype, as the TPU wrapper does); k/v
    [Hkv, S, D]; k_len int or 0-d int tensor. -> (m [Hkv, GT], l [Hkv, GT],
    acc [Hkv, GT, D]) fp32 over slots [0, k_len): m the row maximum of the
    scores, l = sum p, acc = p.v with p = exp(s - m) cast to v's dtype
    before p.v; no normalisation. ``k_len = 0`` gives (-1e30, 0, 0)."""
    d = q.shape[-1]
    qs = (q.float() * _scale(d)).to(q.dtype).float()
    valid = torch.arange(k.shape[1], device=q.device) < k_len
    sc = torch.einsum("hgd,hsd->hgs", qs, k.float())
    sc = torch.where(valid, sc, _NEG_INF)
    m = sc.amax(-1)
    p = torch.where(valid, torch.exp(sc - m[..., None]), 0.0)
    acc = torch.einsum("hgs,hsd->hgd", p.to(v.dtype).float(), v.float())
    return m, p.sum(-1), acc


def _quantize_rows(x):
    """Per-row int8 codes of fp32 ``x`` [..., D] as the TPU kernel makes
    them: (codes as fp32, scale = max(max|x| / 127, 1e-20) [..., 1])."""
    xs = int8_scale(x.abs().amax(-1, keepdim=True), 1e-20)
    return torch.round(x / xs).clamp(-127, 127), xs


def _first(x, n: int):
    """fp32 copy of the first ``n`` slots of ``x`` [H, S, ...], zero-padded
    past S."""
    x = x[:, :n].float()
    pad = n - x.shape[1]
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad)) if pad else x


def _int8_cache_partials(q, k, v, k_len, k_scale, v_scale, group: int):
    """The cache part of the int8 plain versions: (m, l [Hkv, GT, 1], acc
    [Hkv, GT, D], q8, qs) with q8/qs the per-row codes and scales of the
    pre-scaled q. See ``flash_decode_append_int8_plain``."""
    hkv, gt, d = q.shape
    qf = (q.float() * _scale(d)).to(q.dtype).float()
    q8, qs = _quantize_rows(qf)
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((hkv, gt, 1), _NEG_INF, **f32)
    l = torch.zeros((hkv, gt, 1), **f32)
    acc = torch.zeros((hkv, gt, d), **f32)
    kl = min(max(int(k_len), 0), k.shape[1])
    nb = -(-kl // group)          # every group holds a live key
    if nb:
        n = nb * group
        kf, vf = _first(k, n), _first(v, n)
        ks, vs = _first(k_scale, n), _first(v_scale, n)
        sc = torch.einsum("hgd,hsd->hgs", q8, kf) * qs * ks[:, None, :]
        cols = torch.arange(n, device=q.device)
        sc = torch.where(cols < kl, sc, _NEG_INF).reshape(hkv, gt, nb, group)
        gm = sc.amax(-1, keepdim=True)                       # [H,GT,nb,1]
        p = torch.exp(sc - gm)
        p8, ps = _quantize_rows(p * vs.reshape(hkv, 1, nb, group))
        m = gm.amax(-2)
        w = torch.exp(gm - m[..., None])
        l = (p.sum(-1, keepdim=True) * w).sum(-2)
        acc = torch.einsum("hgbs,hbsd->hgd", p8 * (ps * w),
                           vf.reshape(hkv, nb, group, d))
    return m, l, acc, q8, qs


def flash_decode_partials_int8_plain(q, k, v, k_len, k_scale, v_scale, *,
                                     group: int):
    """Plain PyTorch version of the int8 partials kernel: the cache part
    of ``flash_decode_append_int8_plain`` at ``group`` (q quantized per
    row, integer q8.k8 and p8.v8 products, p re-quantized per group of
    keys), with no new block and no normalisation. k/v int8 [Hkv, S, D];
    k_scale/v_scale [Hkv, S]. -> (m [Hkv, GT], l [Hkv, GT], acc
    [Hkv, GT, D]) fp32; ``k_len = 0`` gives (-1e30, 0, 0)."""
    m, l, acc, _, _ = _int8_cache_partials(q, k, v, k_len, k_scale, v_scale,
                                           group)
    return m[..., 0], l[..., 0], acc


def flash_decode_append_int8_plain(q, k, v, k_new, v_new, k_len, new_mask,
                                   k_scale, v_scale, *, group: int):
    """Plain PyTorch version of the int8 kernel, following the TPU
    kernel's ``quant`` branch (``flash_decode.py:41-92, 436-448``) with
    ``group`` as its block: q pre-scaled, rounded to q's dtype and
    quantized per (head, row); scores (q8 . k8) * qs * ks; per group of
    keys, p * vs is re-quantized per row for an integer p.v; the new block
    sees q8 * qs in k_new's dtype. q [Hkv, GT, D]; k/v int8 [Hkv, S, D];
    k_scale/v_scale [Hkv, S]; the rest as ``flash_decode_append_plain``.
    -> [Hkv, GT, D] fp32.

    Within each group p is taken against the group's own max score gm and
    the group is weighted by exp(gm - m): the TPU kernel's softmax, whose p
    is relative to the running max instead, so that the integer codes do
    not depend on where a running max stands. The CUDA kernel's splits
    each keep their own, and with this form it makes the very codes this
    version makes; against the TPU kernel a code can differ by one step
    where its rounding was a near tie. The integer q8 . k8 dots are summed
    in fp32, exact below 2^24.
    """
    part = flash_decode_partials_int8_plain(q, k, v, k_len, k_scale,
                                            v_scale, group=group)
    return flash_decode_fold_int8_plain(q, *part, k_new, v_new, new_mask)


def flash_decode_fold_int8_plain(q, m, l, acc, k_new, v_new, new_mask):
    """The new-block fold of ``flash_decode_append_int8_plain`` on its own:
    cache partials (m, l [Hkv, GT], acc [Hkv, GT, D], as
    ``flash_decode_partials_int8_plain`` gives them, or several shards'
    merged) with the new block folded in and normalised. The new block
    sees q'' = bf16(q8 * qs) of the pre-scaled q, and its p is rounded to
    k_new's dtype against the row's final maximum, as the kernel's fold
    rounds it. (``new_block_partials`` + ``merge_partials`` round that p
    against the new block's own maximum instead: each p is then rounded
    twice apart, so the two differ by up to 2^-7 of the new block's share
    of every output.) -> [Hkv, GT, D] fp32."""
    d = q.shape[-1]
    q8, qs = _quantize_rows((q.float() * _scale(d)).to(q.dtype).float())
    m, l = m[..., None], l[..., None]
    qn = (q8 * qs).to(k_new.dtype).float()
    sn = torch.einsum("hgd,hnd->hgn", qn, k_new.float())
    sn = sn + torch.where(new_mask, 0.0, _NEG_INF)
    m_new = torch.maximum(m, sn.amax(-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    pn = torch.exp(sn - m_new)
    l = l * alpha + pn.sum(-1, keepdim=True)
    acc = acc * alpha + torch.einsum("hgn,hnd->hgd",
                                     pn.to(v_new.dtype).float(),
                                     v_new.float())
    return acc / l.clamp_min(1e-37)


def wide_nsplit(hkv: int, gt: int, s: int, sms: int, ctas_per_sm: int,
                cta_rows: int) -> int:
    """Cache splits of the wide path: as many as let the CTAs of all q
    tiles (``cta_rows`` query rows each) of all ``hkv`` heads of one row,
    one per split, run in one wave of ``ctas_per_sm`` CTAs on each of
    ``sms`` SMs (tiles that outnumber the wave take one split each), each
    split at least 256 keys of the
    ``s``-slot cache, at most 64 (the new block is folded in after them,
    by phase 2 or, with one split, by the split itself). A function of the
    shape alone, never of the batch."""
    tiles = hkv * -(-gt // cta_rows)
    wave = sms * ctas_per_sm
    return max(1, min(wave // tiles, -(-s // _MIN_SPLIT_KEYS),
                      _WIDE_MAX_SPLITS))


def decode_nsplit(hkv: int, s: int, sms: int, ctas_per_sm: int) -> int:
    """Sequence splits of the decode path (GT <= DECODE_ROWS): as many as
    let the splits of all ``hkv`` heads of one row run in one wave of
    ``ctas_per_sm`` CTAs on each of ``sms`` SMs (a row of heads that
    outnumbers the wave takes one split each), each split at least 256
    keys of the ``s``-slot cache. A function of the shape alone, never of
    the batch: B rows run B waves, each split as B = 1 splits it."""
    wave = sms * ctas_per_sm // hkv
    return max(1, min(wave, -(-s // _MIN_SPLIT_KEYS), _MAX_SPLITS))


@functools.lru_cache(maxsize=None)
def _n_parts(gt: int, nsplit: int) -> int:
    """Partials per query row the kernel writes, as the library counts them
    (it alone decides; the wrapper sizes its scratch by this)."""
    return _build.lib(_SOURCE).tf_flash_decode_parts(gt, nsplit)


@functools.lru_cache(maxsize=None)
def _cta_rows(gt: int) -> int:
    """Query rows of one KV head one phase-1 CTA of a launch at ``gt``
    takes, as the library decides them (a q tile on the wide path)."""
    return _build.lib(_SOURCE).tf_flash_decode_cta_rows(gt)


@functools.lru_cache(maxsize=None)
def _wave_at(index: int, d: int, quant: bool, rows: int):
    """(SMs, CTAs one SM holds at once of the built phase-1 kernel that a
    launch with ``rows`` query rows runs) of card ``index``: the device's
    SM count and the CUDA occupancy calculator."""
    with torch.cuda.device(index):
        n = _build.lib(_SOURCE).tf_flash_decode_ctas_per_sm(rows, d,
                                                            int(quant))
    if n <= 0:
        raise RuntimeError(f"flash_decode occupancy query: cudaError_t {-n}")
    return torch.cuda.get_device_properties(index).multi_processor_count, n


def _wave(device, d: int, quant: bool, gt: int = 1):
    """(SMs, CTAs per SM) of the phase-1 kernel a launch at ``gt`` rows
    runs on ``device``."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    rows = 1 if gt <= DECODE_ROWS else _cta_rows(gt)
    return _wave_at(index, d, quant, rows)


def _plan(q, s: int, quant: bool):
    """(nsplit, partials per row) of a launch for queries q [..., Hkv, GT,
    D] over an ``s``-slot cache; the batch dimension, if any, is not read."""
    hkv, gt, d = q.shape[-3:]
    wave = _wave(q.device, d, quant, gt)
    if gt > DECODE_ROWS:
        nsplit = wide_nsplit(hkv, gt, s, *wave, _cta_rows(gt))
    else:
        nsplit = decode_nsplit(hkv, s, *wave)
    return nsplit, _n_parts(gt, nsplit)


def set_programmatic_launch(on: bool) -> bool:
    """Launch every dependent phase (the reduce, the wide fold and merge)
    as a programmatic dependent of the launch before it (``on``, the
    default) or as an ordinary launch; returns the previous setting. A CUDA
    graph keeps the launches it captured, so set this before a capture.
    For measuring what the programmatic edge is worth."""
    return bool(_build.lib(_SOURCE).tf_flash_decode_set_pdl(int(on)))


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_cache_args(q, k, v, k_len, cache_dtype, **more):
    """q [Hkv, GT, D] bf16, a 16-byte aligned cache layer k/v [Hkv, S, D]
    of ``cache_dtype`` and one int32 ``k_len``, all on q's device;
    ``more`` are further bf16 [H, rows, D] tensors (the new block)."""
    for name, x in {"q": q, "k": k, "v": v, **more}.items():
        want = cache_dtype if name in ("k", "v") else torch.bfloat16
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != want:
            raise TypeError(f"this flash_decode kernel takes {name} as "
                            f"{want}; got {x.dtype}")
        if x.dim() != 3 or x.stride(2) != 1:
            raise ValueError(f"{name} must be [H, rows, D] with unit "
                             f"stride in D, got {tuple(x.shape)} "
                             f"{x.stride()}")
    hkv, gt, d = q.shape
    if d not in (64, 128):
        raise ValueError(f"head_dim {d} not supported by the kernel")
    per16 = 16 // k.element_size()     # elements in 16 bytes
    for name, x in (("k", k), ("v", v)):
        if (x.shape[0] != hkv or x.shape[2] != d or x.data_ptr() % 16
                or x.stride(0) % per16 or x.stride(1) % per16):
            raise ValueError(f"{name} {tuple(x.shape)} {x.stride()} is not "
                             "a 16-byte aligned [Hkv, S, D] cache layer")
    if k.shape[1] != v.shape[1]:
        raise ValueError("k and v hold different numbers of slots")
    if k_len.dtype != torch.int32 or k_len.numel() != 1 \
            or k_len.device != q.device:
        raise ValueError("k_len must be one int32 on q's device")


def _check_cuda_args(q, k, v, k_new, v_new, k_len, new_mask, cache_dtype):
    _check_cache_args(q, k, v, k_len, cache_dtype, k_new=k_new, v_new=v_new)
    hkv, gt, d = q.shape
    if k_new.shape != v_new.shape or k_new.shape[0] != hkv \
            or k_new.shape[2] != d:
        raise ValueError("k_new/v_new must be [Hkv, Tn, D]")
    if new_mask.dtype != torch.bool or new_mask.shape != (gt, k_new.shape[1]) \
            or not new_mask.is_contiguous() or new_mask.device != q.device:
        raise ValueError("new_mask must be a contiguous bool [GT, Tn] "
                         "tensor on q's device")


def _check_scales(k, k_scale, v_scale):
    for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
        if (x.device != k.device or x.dtype != torch.float32
                or x.shape != k.shape[:2] or x.stride(1) != 1):
            raise ValueError(f"{name} must be fp32 [Hkv, S] with unit "
                             f"token stride on k's device, got {x.dtype} "
                             f"{tuple(x.shape)} {x.stride()}")


def _aligned16(x):
    """``x``, or a contiguous copy of it when its rows do not start on 16
    bytes: the wide path copies the new block in 16-byte chunks."""
    per16 = 16 // x.element_size()
    if x.data_ptr() % 16 or any(st % per16 for st in x.stride()[:-1]):
        return x.clone(memory_format=torch.contiguous_format)
    return x


def _launch(fn, q, k, v, k_new, v_new, k_len, new_mask, scales=(),
            window=()):
    """Allocate the outputs and scratch and launch one entry point of
    ``csrc/flash_decode.cu``; ``scales`` are the int8 entry's extra
    (pointer, head stride) arguments, ``window`` the window entry's
    (window, tokens a group)."""
    hkv, gt, d = q.shape
    if gt > DECODE_ROWS:
        k_new, v_new = _aligned16(k_new), _aligned16(v_new)
    s, tn = k.shape[1], k_new.shape[1]
    nsplit, parts = _plan(q, s, bool(scales))
    f32 = dict(dtype=torch.float32, device=q.device)
    m_part = torch.empty((hkv, gt, parts), **f32)
    l_part = torch.empty((hkv, gt, parts), **f32)
    acc_part = torch.empty((hkv, gt, parts, d), **f32)
    out = torch.empty((hkv, gt, d), **f32)
    err = fn(q.data_ptr(), q.stride(0), q.stride(1),
             k.data_ptr(), k.stride(0), k.stride(1),
             v.data_ptr(), v.stride(0), v.stride(1), *scales,
             k_new.data_ptr(), k_new.stride(0), k_new.stride(1),
             v_new.data_ptr(), v_new.stride(0), v_new.stride(1),
             new_mask.data_ptr(), k_len.data_ptr(),
             m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
             out.data_ptr(), hkv, gt, tn, s, d, nsplit, _scale(d),
             *window, _stream(q.device))
    _build.check(err, "flash_decode kernel launch")
    return out


def _device_k_len(k_len, q):
    if q.device.type != "cuda":
        raise ValueError(f"no flash_decode for device {q.device}")
    if not torch.is_tensor(k_len):
        k_len = torch.tensor(k_len, dtype=torch.int32, device=q.device)
    return k_len


def flash_decode_append(q, k, v, k_new, v_new, k_len, new_mask):
    """Fused decode attention; see the module docstring. CUDA tensors
    launch the kernel (or raise); CPU tensors take the plain version.
    ``flash_decode_append.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_decode_append_plain(q, k, v, k_new, v_new, k_len,
                                         new_mask)
    k_len = _device_k_len(k_len, q)
    _check_cuda_args(q, k, v, k_new, v_new, k_len, new_mask, torch.bfloat16)
    out = _launch(_build.lib(_SOURCE).tf_flash_decode_bf16, q, k, v, k_new,
                  v_new, k_len, new_mask)
    flash_decode_append.launches += 1
    return out


flash_decode_append.launches = 0


def flash_decode_window(q, k, v, k_new, v_new, k_len, new_mask,
                        window: int):
    """``flash_decode_append`` over a sliding-window layer's ring (module
    docstring): k/v [Hkv, R, D] the ring, ``k_len`` the sequence length,
    the T query tokens the Tn = T new ones. CUDA tensors launch the window
    kernel (or raise); CPU tensors take the plain version.
    ``flash_decode_window.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_decode_append_plain(q, k, v, k_new, v_new, k_len,
                                         new_mask, window)
    k_len = _device_k_len(k_len, q)
    _check_cuda_args(q, k, v, k_new, v_new, k_len, new_mask, torch.bfloat16)
    if window < 2 or q.shape[1] % k_new.shape[1]:
        raise ValueError(f"a window of {window} over {q.shape[1]} query "
                         f"rows and {k_new.shape[1]} new tokens")
    out = _launch(_build.lib(_SOURCE).tf_flash_decode_window_bf16, q, k, v,
                  k_new, v_new, k_len, new_mask,
                  window=(window, k_new.shape[1]))
    flash_decode_window.launches += 1
    return out


flash_decode_window.launches = 0


def flash_decode_append_int8(q, k, v, k_new, v_new, k_len, new_mask,
                             k_scale, v_scale):
    """Fused decode attention over an int8 cache: k/v int8 codes
    [Hkv, S, D] with fp32 scales [Hkv, S]; q, k_new and v_new bf16 on the
    card. CUDA tensors launch the int8 kernel (or raise); CPU tensors take
    the plain version at the kernel's group.
    ``flash_decode_append_int8.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_decode_append_int8_plain(
            q, k, v, k_new, v_new, k_len, new_mask, k_scale, v_scale,
            group=KERNEL_GROUP)
    k_len = _device_k_len(k_len, q)
    _check_cuda_args(q, k, v, k_new, v_new, k_len, new_mask, torch.int8)
    _check_scales(k, k_scale, v_scale)
    out = _launch(_build.lib(_SOURCE).tf_flash_decode_int8, q, k, v, k_new,
                  v_new, k_len, new_mask,
                  scales=(k_scale.data_ptr(), k_scale.stride(0),
                          v_scale.data_ptr(), v_scale.stride(0)))
    flash_decode_append_int8.launches += 1
    return out


flash_decode_append_int8.launches = 0


# ---------------------------------------------------------------------------
# Cache-only partials (no new block, no normalisation)
# ---------------------------------------------------------------------------

def _launch_partials(fn, q, k, v, k_len, scales=()):
    """Allocate the outputs and scratch and launch one partials entry
    point of ``csrc/flash_decode.cu``."""
    hkv, gt, d = q.shape
    s = k.shape[1]
    nsplit, parts = _plan(q, s, bool(scales))
    f32 = dict(dtype=torch.float32, device=q.device)
    m_part = torch.empty((hkv, gt, parts), **f32)
    l_part = torch.empty((hkv, gt, parts), **f32)
    acc_part = torch.empty((hkv, gt, parts, d), **f32)
    m = torch.empty((hkv, gt), **f32)
    l = torch.empty((hkv, gt), **f32)
    acc = torch.empty((hkv, gt, d), **f32)
    err = fn(q.data_ptr(), q.stride(0), q.stride(1),
             k.data_ptr(), k.stride(0), k.stride(1),
             v.data_ptr(), v.stride(0), v.stride(1), *scales,
             k_len.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
             acc_part.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
             hkv, gt, s, d, nsplit, _scale(d), _stream(q.device))
    _build.check(err, "flash_decode partials kernel launch")
    return m, l, acc


def flash_decode_partials(q, k, v, k_len):
    """Cache-only online-softmax partials of q [Hkv, GT, D] against slots
    [0, k_len) of one cache layer k/v [Hkv, S, D] (a view of the stacked
    cache is fine): (m [Hkv, GT], l [Hkv, GT], acc [Hkv, GT, D]) fp32,
    unnormalised. q is pre-scaled by 1/sqrt(D) here. CUDA tensors launch
    the kernel (or raise); CPU tensors take the plain version.
    ``flash_decode_partials.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_decode_partials_plain(q, k, v, k_len)
    k_len = _device_k_len(k_len, q)
    _check_cache_args(q, k, v, k_len, torch.bfloat16)
    out = _launch_partials(_build.lib(_SOURCE).tf_flash_decode_partials_bf16,
                           q, k, v, k_len)
    flash_decode_partials.launches += 1
    return out


flash_decode_partials.launches = 0


def flash_decode_partials_int8(q, k, v, k_len, k_scale, v_scale):
    """``flash_decode_partials`` over an int8 cache layer: k/v int8 codes
    [Hkv, S, D] with fp32 scales [Hkv, S]; q bf16 on the card. CUDA
    tensors launch the int8 kernel (or raise); CPU tensors take the plain
    version at the kernel's group.
    ``flash_decode_partials_int8.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_decode_partials_int8_plain(q, k, v, k_len, k_scale,
                                                v_scale, group=KERNEL_GROUP)
    k_len = _device_k_len(k_len, q)
    _check_cache_args(q, k, v, k_len, torch.int8)
    _check_scales(k, k_scale, v_scale)
    out = _launch_partials(
        _build.lib(_SOURCE).tf_flash_decode_partials_int8, q, k, v, k_len,
        scales=(k_scale.data_ptr(), k_scale.stride(0),
                v_scale.data_ptr(), v_scale.stride(0)))
    flash_decode_partials_int8.launches += 1
    return out


flash_decode_partials_int8.launches = 0


# ---------------------------------------------------------------------------
# Row-batched: B rows, each with its own live length and mask
# ---------------------------------------------------------------------------

def _row_mask(new_mask, b: int):
    """Row ``b``'s [GT, Tn] mask of a per-row [B, GT, Tn] or shared mask."""
    return new_mask[b] if new_mask.dim() == 3 else new_mask


def flash_decode_append_batched_plain(q, k, v, k_new, v_new, k_len,
                                      new_mask):
    """Plain PyTorch version of the row-batched kernel: the single-row
    plain version, row by row. q [B, Hkv, GT, D]; k/v [B, Hkv, S, D];
    k_new/v_new [B, Hkv, Tn, D]; new_mask [B, GT, Tn] (or [GT, Tn] for all
    rows) bool; k_len [B] int. -> [B, Hkv, GT, D] fp32."""
    return torch.stack([
        flash_decode_append_plain(q[b], k[b], v[b], k_new[b], v_new[b],
                                  k_len[b], _row_mask(new_mask, b))
        for b in range(q.shape[0])])


def flash_decode_append_batched_int8_plain(q, k, v, k_new, v_new, k_len,
                                           new_mask, k_scale, v_scale, *,
                                           group: int):
    """Plain PyTorch version of the row-batched int8 kernel: the
    single-row int8 plain version at ``group``, row by row. k/v int8
    [B, Hkv, S, D]; k_scale/v_scale [B, Hkv, S]."""
    return torch.stack([
        flash_decode_append_int8_plain(
            q[b], k[b], v[b], k_new[b], v_new[b], k_len[b],
            _row_mask(new_mask, b), k_scale[b], v_scale[b], group=group)
        for b in range(q.shape[0])])


def _check_batched_args(q, k, v, k_new, v_new, k_len, new_mask, cache_dtype):
    for name, x in {"q": q, "k_new": k_new, "v_new": v_new, "k": k,
                    "v": v}.items():
        want = cache_dtype if name in ("k", "v") else torch.bfloat16
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != want:
            raise TypeError(f"this flash_decode kernel takes {name} as "
                            f"{want}; got {x.dtype}")
        if x.dim() != 4 or x.stride(3) != 1:
            raise ValueError(f"{name} must be [B, H, rows, D] with unit "
                             f"stride in D, got {tuple(x.shape)} "
                             f"{x.stride()}")
    bsz, hkv, gt, d = q.shape
    if d not in (64, 128):
        raise ValueError(f"head_dim {d} not supported by the kernel")
    per16 = 16 // k.element_size()     # elements in 16 bytes
    for name, x in (("k", k), ("v", v)):
        if (x.shape[:2] != (bsz, hkv) or x.shape[3] != d
                or x.data_ptr() % 16
                or any(x.stride(i) % per16 for i in range(3))):
            raise ValueError(f"{name} {tuple(x.shape)} {x.stride()} is not "
                             "a 16-byte aligned [B, Hkv, S, D] cache layer")
    tn = k_new.shape[2]
    if k_new.shape != v_new.shape or k_new.shape != (bsz, hkv, tn, d):
        raise ValueError("k_new/v_new must be [B, Hkv, Tn, D]")
    if new_mask.dtype != torch.bool or not new_mask.is_contiguous() \
            or new_mask.device != q.device \
            or new_mask.shape not in ((bsz, gt, tn), (gt, tn)):
        raise ValueError("new_mask must be a contiguous bool [B, GT, Tn] or "
                         "[GT, Tn] tensor on q's device")
    if k_len.dtype != torch.int32 or k_len.shape != (bsz,) \
            or not k_len.is_contiguous() or k_len.device != q.device:
        raise ValueError("k_len must be int32 [B] on q's device")


def _check_batched_scales(k, k_scale, v_scale):
    for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
        if (x.device != k.device or x.dtype != torch.float32
                or x.shape != k.shape[:3] or x.stride(2) != 1):
            raise ValueError(f"{name} must be fp32 [B, Hkv, S] with unit "
                             f"token stride on k's device, got {x.dtype} "
                             f"{tuple(x.shape)} {x.stride()}")


def _launch_batched(fn, q, k, v, k_new, v_new, k_len, new_mask, scales=()):
    """Allocate the outputs and scratch (B x the single-row scratch) and
    launch one row-batched entry point of ``csrc/flash_decode.cu``."""
    bsz, hkv, gt, d = q.shape
    s, tn = k.shape[2], k_new.shape[2]
    nsplit, parts = _plan(q, s, bool(scales))   # per row, whatever B is
    if gt > DECODE_ROWS:
        k_new, v_new = _aligned16(k_new), _aligned16(v_new)
    f32 = dict(dtype=torch.float32, device=q.device)
    m_part = torch.empty((bsz, hkv, gt, parts), **f32)
    l_part = torch.empty((bsz, hkv, gt, parts), **f32)
    acc_part = torch.empty((bsz, hkv, gt, parts, d), **f32)
    out = torch.empty((bsz, hkv, gt, d), **f32)
    mask_sb = gt * tn if new_mask.dim() == 3 else 0
    err = fn(bsz, q.data_ptr(), *q.stride()[:3],
             k.data_ptr(), *k.stride()[:3], v.data_ptr(), *v.stride()[:3],
             *scales,
             k_new.data_ptr(), *k_new.stride()[:3],
             v_new.data_ptr(), *v_new.stride()[:3],
             mask_sb, new_mask.data_ptr(), k_len.data_ptr(),
             m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
             out.data_ptr(), hkv, gt, tn, s, d, nsplit, _scale(d),
             _stream(q.device))
    _build.check(err, "row-batched flash_decode kernel launch")
    return out


def _device_k_lens(k_len, q):
    if q.device.type != "cuda":
        raise ValueError(f"no flash_decode for device {q.device}")
    return torch.as_tensor(k_len, device=q.device).to(torch.int32)


def flash_decode_append_batched(q, k, v, k_new, v_new, k_len, new_mask):
    """Row-batched fused decode attention; see the module docstring. CUDA
    tensors launch the kernel once for all rows (or raise); CPU tensors
    take the plain version.
    ``flash_decode_append_batched.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_decode_append_batched_plain(q, k, v, k_new, v_new,
                                                 k_len, new_mask)
    k_len = _device_k_lens(k_len, q)
    _check_batched_args(q, k, v, k_new, v_new, k_len, new_mask,
                        torch.bfloat16)
    out = _launch_batched(_build.lib(_SOURCE).tf_flash_decode_batched_bf16,
                          q, k, v, k_new, v_new, k_len, new_mask)
    flash_decode_append_batched.launches += 1
    return out


flash_decode_append_batched.launches = 0


def flash_decode_append_batched_int8(q, k, v, k_new, v_new, k_len, new_mask,
                                     k_scale, v_scale):
    """Row-batched fused decode attention over int8 caches: k/v int8 codes
    [B, Hkv, S, D] with fp32 scales [B, Hkv, S]. CUDA tensors launch the
    int8 kernel once for all rows (or raise); CPU tensors take the plain
    version at the kernel's group.
    ``flash_decode_append_batched_int8.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_decode_append_batched_int8_plain(
            q, k, v, k_new, v_new, k_len, new_mask, k_scale, v_scale,
            group=KERNEL_GROUP)
    k_len = _device_k_lens(k_len, q)
    _check_batched_args(q, k, v, k_new, v_new, k_len, new_mask, torch.int8)
    _check_batched_scales(k, k_scale, v_scale)
    out = _launch_batched(
        _build.lib(_SOURCE).tf_flash_decode_batched_int8, q, k, v, k_new,
        v_new, k_len, new_mask,
        scales=(k_scale.data_ptr(), *k_scale.stride()[:2],
                v_scale.data_ptr(), *v_scale.stride()[:2]))
    flash_decode_append_batched_int8.launches += 1
    return out


flash_decode_append_batched_int8.launches = 0


@functools.lru_cache(maxsize=64)
def causal_mask(t: int, tn: int, groups: int, device) -> torch.Tensor:
    """[G*T, Tn] bool: query row i of each group attends new token j <= i
    (cached per shape and device; callers never write to it). A mask
    first built under a CUDA graph capture raises: its bits would exist
    only once the graph replays (``Engine.__init__`` builds the decode
    widths' masks before any capture)."""
    if torch.device(device).type == "cuda" \
            and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"causal_mask({t}, {tn}, {groups}) first built "
                           f"under a CUDA graph capture")
    rows = torch.arange(t, device=device)[:, None]
    cols = torch.arange(tn, device=device)[None, :]
    return (cols <= rows).repeat(groups, 1).contiguous()


def _kernel_layout(q, k_new, new_mask):
    """[1, Hq, T, D] queries -> [Hkv, G*T, D] rows and their [G*T, Tn]
    mask (``new_mask`` [T, Tn] bool, or None for causal)."""
    b, hq, t, d = q.shape
    hkv = k_new.shape[1]
    g = hq // hkv
    if b != 1:
        raise ValueError("the flash-decode kernel takes batch 1")
    tn = k_new.shape[2]
    if new_mask is None:
        nmask = causal_mask(t, tn, g, q.device)
    else:
        nmask = new_mask.to(torch.bool).repeat(g, 1).contiguous()
    return q[0].reshape(hkv, g * t, d), nmask


def append_attention_kernel(q, k_cache, v_cache, k_new, v_new, *, k_len,
                            new_mask=None, window: int = 0):
    """Counterpart of ``append_attention_pallas`` (B = 1, no cache mask):
    q [1, Hq, T, D]; k/v cache [1, Hkv, S, D] (one layer, a view is fine);
    k_new/v_new [1, Hkv, Tn, D]; new_mask [T, Tn] bool or None (causal);
    ``window``: the cache is a sliding-window layer's ring.
    -> [1, Hq, T, D] in q's dtype."""
    qh, nmask = _kernel_layout(q, k_new, new_mask)
    if window:
        out = flash_decode_window(qh, k_cache[0], v_cache[0], k_new[0],
                                  v_new[0], k_len, nmask, window)
    else:
        out = flash_decode_append(qh, k_cache[0], v_cache[0], k_new[0],
                                  v_new[0], k_len, nmask)
    return out.reshape(q.shape).to(q.dtype)


def append_attention_kernel_int8(q, k_cache, v_cache, k_new, v_new, *,
                                 k_len, k_scale, v_scale, new_mask=None):
    """``append_attention_kernel`` over an int8 cache layer: k/v cache
    int8 [1, Hkv, S, D] with scales [1, Hkv, S]."""
    qh, nmask = _kernel_layout(q, k_new, new_mask)
    out = flash_decode_append_int8(qh, k_cache[0], v_cache[0], k_new[0],
                                   v_new[0], k_len, nmask, k_scale[0],
                                   v_scale[0])
    return out.reshape(q.shape).to(q.dtype)


def _kernel_layout_rows(q, k_new, new_mask):
    """[B, Hq, T, D] queries -> [B, Hkv, G*T, D] rows and their mask:
    ``new_mask`` None (causal, one [G*T, Tn] mask for all rows), [T, Tn]
    (one for all rows) or [B, T, Tn] (per row)."""
    b, hq, t, d = q.shape
    hkv, tn = k_new.shape[1], k_new.shape[2]
    g = hq // hkv
    if new_mask is None:
        nmask = causal_mask(t, tn, g, q.device)
    else:
        reps = (1, g, 1) if new_mask.dim() == 3 else (g, 1)
        nmask = new_mask.to(torch.bool).repeat(*reps).contiguous()
    return q.reshape(b, hkv, g * t, d), nmask


def append_attention_kernel_batched(q, k_cache, v_cache, k_new, v_new, *,
                                    k_len, new_mask=None):
    """Row-batched counterpart of ``append_attention_kernel``: q
    [B, Hq, T, D]; k/v cache [B, Hkv, S, D] (one layer of every row, a view
    is fine); k_new/v_new [B, Hkv, Tn, D]; k_len [B]; new_mask None
    (causal), [T, Tn] or [B, T, Tn] bool. -> [B, Hq, T, D] in q's dtype."""
    qh, nmask = _kernel_layout_rows(q, k_new, new_mask)
    out = flash_decode_append_batched(qh, k_cache, v_cache, k_new, v_new,
                                      k_len, nmask)
    return out.reshape(q.shape).to(q.dtype)


def append_attention_kernel_batched_int8(q, k_cache, v_cache, k_new, v_new,
                                         *, k_len, k_scale, v_scale,
                                         new_mask=None):
    """``append_attention_kernel_batched`` over int8 cache layers: k/v
    cache int8 [B, Hkv, S, D] with scales [B, Hkv, S]."""
    qh, nmask = _kernel_layout_rows(q, k_new, new_mask)
    out = flash_decode_append_batched_int8(qh, k_cache, v_cache, k_new,
                                           v_new, k_len, nmask, k_scale,
                                           v_scale)
    return out.reshape(q.shape).to(q.dtype)


def attention_partials_kernel(q, k_cache, v_cache, *, k_len, k_scale=None,
                              v_scale=None):
    """Cache-only partials in the layout of ``ops.attention``'s partials
    (B = 1): q [1, Hq, T, D]; k/v cache [1, Hkv, S, D] (one layer, a view
    is fine), int8 with scales [1, Hkv, S] when given. -> (m, l
    [1, Hkv, G, T], acc [1, Hkv, G, T, D]) fp32 through
    ``flash_decode_partials`` (``..._int8`` with scales)."""
    b, hq, t, d = q.shape
    hkv = k_cache.shape[1]
    g = hq // hkv
    if b != 1:
        raise ValueError("the flash-decode kernel takes batch 1")
    qh = q[0].reshape(hkv, g * t, d)
    if k_scale is not None:
        m, l, acc = flash_decode_partials_int8(qh, k_cache[0], v_cache[0],
                                               k_len, k_scale[0], v_scale[0])
    else:
        m, l, acc = flash_decode_partials(qh, k_cache[0], v_cache[0], k_len)
    return (m.reshape(b, hkv, g, t), l.reshape(b, hkv, g, t),
            acc.reshape(b, hkv, g, t, d))
