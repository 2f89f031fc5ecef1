"""Fused chunk scoring for the retrieval-cache build — the port of
``triforce_tpu/ops/retrieval_kernel.py``.

``chunk_scores`` computes, per KV head, q . chunk_mean(k) averaged over the
GQA group, as mean over each chunk of the group-mean q . k — the identity
that lets the keys stream once with no chunk-mean tensor. q is cast to the
cache dtype first (as the TPU kernel does); every product accumulates in
fp32. Only the live prefill is read.

On a CUDA tensor it launches the hand-written kernel in
``csrc/chunk_scores.cu`` (bf16 only — anything else raises); on a CPU
tensor it takes ``chunk_scores_plain``. The launch plan (``block_plan``:
chunks a block, blocks a head) is computed here from the shape, the SM
count and the kernel's occupancy, and passed in. Top-k and the gather
stay torch ops (``ops/retrieval.py``), as the JAX package leaves them to
XLA.

``chunk_scores_int8`` scores an int8 cache (codes plus fp32 per-token
scales), the TPU kernel's ``quant`` branch: q is quantized per (head, row)
without a cast to bf16 first, and each integer dot is scaled by qs * ks
before the group mean. Its own CUDA kernel is in the same source; its plain
version, ``chunk_scores_int8_plain``, mirrors that kernel (not the JAX XLA
path, which dequantizes the keys and keeps q in fp32).
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from ..cache import int8_scale

_SOURCE = "chunk_scores.cu"
# bytes of keys a block scores at most, unless fewer blocks than a wave
# would be left (the kernel's source note gives the measurements)
BLOCK_BYTES = 65536


def chunk_scores_plain(q, k, *, chunk: int, prefill: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: q [Hkv, G, D], k [Hkv, S, D]
    -> [Hkv, prefill // chunk] fp32."""
    hkv = k.shape[0]
    qb = q.to(k.dtype).float()
    sc = torch.einsum("hgd,hsd->hgs", qb, k[:, :prefill].float()).mean(1)
    return sc.reshape(hkv, prefill // chunk, chunk).mean(-1)


def chunk_scores_int8_plain(q, k, k_scale, *, chunk: int,
                            prefill: int) -> torch.Tensor:
    """Plain PyTorch version of the int8 kernel
    (``retrieval_kernel.py:52-62, 133-145``): q [Hkv, G, D] (any float
    dtype), k int8 codes [Hkv, S, D], k_scale fp32 [Hkv, S] ->
    [Hkv, prefill // chunk] fp32. The integer dots are summed in fp32,
    exact below 2^24."""
    hkv = k.shape[0]
    qf = q.float()
    qs = int8_scale(qf.abs().amax(-1, keepdim=True), 1e-20)
    q8 = torch.round(qf / qs).clamp(-127, 127)
    sc = torch.einsum("hgd,hsd->hgs", q8, k[:, :prefill].float())
    sc = (sc * qs * k_scale[:, None, :prefill].float()).mean(1)
    return sc.reshape(hkv, prefill // chunk, chunk).mean(-1)


def block_plan(hkv: int, n_chunks: int, chunk: int, row_bytes: int,
               sms: int, ctas_per_sm: int):
    """(chunks a block, blocks a head) of a launch over ``n_chunks`` >= 1
    chunks of ``chunk`` keys of ``row_bytes`` each, per head: blocks of
    whole chunks, at most ``BLOCK_BYTES`` of keys (or one chunk) each, but
    no fewer of them than fill one wave of ``ctas_per_sm`` CTAs on each of
    ``sms`` SMs (heads that outnumber the wave take one block each). Block
    b of a head scores chunks [b * cpb, min((b + 1) * cpb, n_chunks));
    none is empty."""
    per_head = max(1, sms * ctas_per_sm // hkv)
    cpb = min(-(-n_chunks // per_head),
              max(1, BLOCK_BYTES // (row_bytes * chunk)))
    return cpb, -(-n_chunks // cpb)


@functools.lru_cache(maxsize=None)
def _wave_at(index: int, d: int, quant: bool):
    """(SMs, CTAs one SM holds at once of the built kernel) of card
    ``index``: the device's SM count and the CUDA occupancy calculator."""
    with torch.cuda.device(index):
        n = _build.lib(_SOURCE).tf_chunk_scores_ctas_per_sm(d, int(quant))
    if n <= 0:
        raise RuntimeError(f"chunk_scores occupancy query: cudaError_t {-n}")
    return torch.cuda.get_device_properties(index).multi_processor_count, n


def _wave(device, d: int, quant: bool):
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _wave_at(index, d, quant)


def plan(q, chunk: int, prefill: int, quant: bool):
    """(chunks a block, blocks a head) of a launch for q [Hkv, G, D] over
    ``prefill`` > 0 keys on q's card."""
    hkv, _, d = q.shape
    return block_plan(hkv, prefill // chunk, chunk, d * (1 if quant else 2),
                      *_wave(q.device, d, quant))


def _check_prefill(k, chunk, prefill):
    if prefill % chunk or prefill > k.shape[1]:
        raise ValueError(f"prefill {prefill} must be a multiple of chunk "
                         f"{chunk} within the cache ({k.shape[1]})")


def _check_cache(q, k, chunk, dtype):
    if k.device.type != "cuda":
        raise ValueError(f"no chunk_scores for device {k.device}")
    hkv, g, d = q.shape
    if k.dtype != dtype:
        raise TypeError(f"this chunk_scores kernel takes a {dtype} cache, "
                        f"got {k.dtype}")
    per16 = 16 // k.element_size()     # elements in 16 bytes
    if (k.dim() != 3 or k.shape[0] != hkv or k.shape[2] != d
            or k.stride(2) != 1 or k.data_ptr() % 16 or k.stride(0) % per16
            or k.stride(1) % per16):
        raise ValueError(f"k {tuple(k.shape)} {k.stride()} is not a 16-byte "
                         "aligned [Hkv, S, D] cache layer")
    if d not in (64, 128) or not 1 <= g <= 8 or chunk > 256:
        raise ValueError(f"chunk_scores kernel: unsupported head_dim {d}, "
                         f"group {g} or chunk {chunk}")


def chunk_scores(q, k, *, chunk: int, prefill: int) -> torch.Tensor:
    """Fused chunk-score pass: q [Hkv, G, D] (one layer's last-prefill-token
    queries, grouped per KV head), k [Hkv, S, D] with ``prefill`` live
    tokens -> [Hkv, prefill // chunk] fp32. CUDA tensors launch the kernel
    (or raise); CPU tensors take the plain version.
    ``chunk_scores.launches`` counts kernel launches."""
    _check_prefill(k, chunk, prefill)
    if k.device.type == "cpu":
        return chunk_scores_plain(q, k, chunk=chunk, prefill=prefill)
    _check_cache(q, k, chunk, torch.bfloat16)
    hkv, g, d = q.shape
    qb = q.to(k.dtype).contiguous()
    if qb.data_ptr() % 16:          # the kernel reads q in 16-byte loads
        qb = qb.clone()
    out = torch.empty((hkv, prefill // chunk), dtype=torch.float32,
                      device=k.device)
    if prefill == 0:
        return out
    cpb, bph = plan(qb, chunk, prefill, False)
    err = _build.lib(_SOURCE).tf_chunk_scores_bf16(
        qb.data_ptr(), k.data_ptr(), k.stride(0), k.stride(1),
        out.data_ptr(), hkv, g, d, prefill, chunk, cpb, bph,
        torch.cuda.current_stream(k.device).cuda_stream)
    _build.check(err, "chunk_scores kernel launch")
    chunk_scores.launches += 1
    return out


chunk_scores.launches = 0


def chunk_scores_int8(q, k, k_scale, *, chunk: int,
                      prefill: int) -> torch.Tensor:
    """Fused chunk-score pass over an int8 cache: q [Hkv, G, D], k int8
    codes [Hkv, S, D], k_scale fp32 [Hkv, S] -> [Hkv, prefill // chunk]
    fp32. CUDA tensors launch the int8 kernel (or raise); CPU tensors take
    the plain version. ``chunk_scores_int8.launches`` counts launches."""
    _check_prefill(k, chunk, prefill)
    if k.device.type == "cpu":
        return chunk_scores_int8_plain(q, k, k_scale, chunk=chunk,
                                       prefill=prefill)
    _check_cache(q, k, chunk, torch.int8)
    if (k_scale.device != k.device or k_scale.dtype != torch.float32
            or k_scale.shape != k.shape[:2] or k_scale.stride(1) != 1):
        raise ValueError("k_scale must be fp32 [Hkv, S] with unit token "
                         "stride on k's device")
    hkv, g, d = q.shape
    # the kernel widens a bf16 q itself (the same fp32 values as q.float(),
    # without a launch); any other dtype is widened here
    qf = (q if q.dtype == torch.bfloat16 else q.float()).contiguous()
    out = torch.empty((hkv, prefill // chunk), dtype=torch.float32,
                      device=k.device)
    if prefill == 0:
        return out
    cpb, bph = plan(qf, chunk, prefill, True)
    err = _build.lib(_SOURCE).tf_chunk_scores_int8(
        qf.data_ptr(), int(qf.dtype == torch.bfloat16), k.data_ptr(),
        k.stride(0), k.stride(1),
        k_scale.data_ptr(), k_scale.stride(0), out.data_ptr(), hkv, g, d,
        prefill, chunk, cpb, bph,
        torch.cuda.current_stream(k.device).cuda_stream)
    _build.check(err, "chunk_scores int8 kernel launch")
    chunk_scores_int8.launches += 1
    return out


chunk_scores_int8.launches = 0
