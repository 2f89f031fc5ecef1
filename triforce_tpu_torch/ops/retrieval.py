"""Retrieval-cache construction — the port of ``triforce_tpu/ops/retrieval.py``:
chunk-mean key scoring -> top-k chunk selection (chunk 0 pinned) -> per-KV-
head gather into the budget region.

``chunk_scores`` takes the fused scoring pass of ``ops/retrieval_kernel.py``
for a bf16 cache (the CUDA kernel on the card, its plain version on the
CPU). An int8 cache takes the int8 kernel on the card and, on the CPU, the
JAX package's portable form (``chunk_scores_xla`` over dequantized keys),
as the JAX package does off the TPU; the two may pick different chunks
where scores nearly tie. The build gathers codes and scales alike, so an
int8 retrieval cache stays int8.
"""

from __future__ import annotations

import torch

from . import retrieval_kernel


def chunk_scores_xla(q, k_prefill, chunk_size: int) -> torch.Tensor:
    """Portable chunk scoring: q . chunk_mean(k), GQA-group-averaged.
    q [B, Hq, 1, D]; k_prefill [B, Hkv, P, D] (P % chunk_size == 0) ->
    [B, Hkv, P // chunk_size] fp32."""
    b, hkv, p, d = k_prefill.shape
    g = q.shape[1] // hkv
    chunk_k = k_prefill.float().reshape(b, hkv, p // chunk_size, chunk_size,
                                        d).mean(3)
    qg = q.reshape(b, hkv, g, d).float()
    return torch.einsum("bhgd,bhcd->bhgc", qg, chunk_k).mean(2)


def chunk_scores(q, k_layer, prefill: int, chunk_size: int,
                 k_scale=None) -> torch.Tensor:
    """Chunk scores over the live prefill. q [B, Hq, 1, D]; k_layer
    [B, Hkv, S, D] (one layer of the full cache; int8 codes with k_scale
    [B, Hkv, S] when quantized) -> [B, Hkv, prefill // chunk_size] fp32.
    Batch 1, like the kernels."""
    b, hkv, s, d = k_layer.shape
    if b != 1:
        raise ValueError("chunk_scores takes batch 1")
    if k_scale is not None and k_layer.device.type == "cpu":
        k_prefill = k_layer[:, :, :prefill].float() \
            * k_scale[:, :, :prefill, None]
        return chunk_scores_xla(q, k_prefill, chunk_size)
    g = q.shape[1] // hkv
    qh = q[0].reshape(hkv, g, d)
    if k_scale is not None:
        sc = retrieval_kernel.chunk_scores_int8(
            qh, k_layer[0], k_scale[0], chunk=chunk_size, prefill=prefill)
    else:
        sc = retrieval_kernel.chunk_scores(qh, k_layer[0], chunk=chunk_size,
                                           prefill=prefill)
    return sc[None]


def select_chunks(scores, select_sets: int) -> torch.Tensor:
    """Pick ``select_sets`` chunks per head from [B, Hkv, C] scores, always
    keeping chunk 0 (the attention sink) first -> [B, Hkv, select_sets]."""
    b, hkv, _ = scores.shape
    top_rest = torch.topk(scores[:, :, 1:], select_sets - 1, dim=-1).indices
    first = torch.zeros((b, hkv, 1), dtype=top_rest.dtype,
                        device=scores.device)
    return torch.cat([first, top_rest + 1], dim=-1)


def gather_chunks(cache_layer, chunk_idx, chunk_size: int) -> torch.Tensor:
    """cache_layer [B, Hkv, S, ...] (S >= the chunks' end); chunk_idx
    [B, Hkv, S_sets] -> [B, Hkv, S_sets * chunk_size, ...]. Indexes the
    layer in place: no copy of the prefill is made. A scale plane
    [B, Hkv, S] gathers the same way (``gather_chunk_scales``)."""
    b, hkv = cache_layer.shape[:2]
    dev = chunk_idx.device
    tok = (chunk_idx[..., None] * chunk_size
           + torch.arange(chunk_size, device=dev)).reshape(b, hkv, -1)
    bi = torch.arange(b, device=dev)[:, None, None]
    hi = torch.arange(hkv, device=dev)[None, :, None]
    return cache_layer[bi, hi, tok]


gather_chunk_scales = gather_chunks


def build_layer(q, k_layer, v_layer, prefill: int, chunk_size: int,
                budget: int, k_scale=None, v_scale=None):
    """One layer's retrieval budget region from the last prefill token's
    query: q [B,Hq,1,D]; k_layer/v_layer [B,Hkv,S_max,D] (int8 codes with
    scales [B,Hkv,S_max] when quantized) -> (k_sel, v_sel) [B, Hkv, budget,
    D], plus (ks_sel, vs_sel) [B, Hkv, budget] when quantized, to be written
    at retrieval slots [0, budget)."""
    select_sets = budget // chunk_size
    scores = chunk_scores(q, k_layer, prefill, chunk_size, k_scale=k_scale)
    idx = select_chunks(scores, select_sets)
    k_sel = gather_chunks(k_layer, idx, chunk_size)
    v_sel = gather_chunks(v_layer, idx, chunk_size)
    if k_scale is None:
        return k_sel, v_sel
    return (k_sel, v_sel, gather_chunk_scales(k_scale, idx, chunk_size),
            gather_chunk_scales(v_scale, idx, chunk_size))
