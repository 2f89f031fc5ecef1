"""Retrieval-cache construction — the port of ``triforce_tpu/ops/retrieval.py``:
chunk-mean key scoring -> top-k chunk selection (chunk 0 pinned) -> per-KV-
head gather into the budget region.

``chunk_scores`` always takes the fused scoring pass of
``ops/retrieval_kernel.py`` (the CUDA kernel on the card, its plain version
on the CPU). ``chunk_scores_xla`` keeps the JAX package's portable form,
which forms fp32 chunk means first, for comparison.
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


def chunk_scores(q, k_layer, prefill: int, chunk_size: int) -> torch.Tensor:
    """Chunk scores over the live prefill. q [B, Hq, 1, D]; k_layer
    [B, Hkv, S, D] (one layer of the full cache) -> [B, Hkv, prefill //
    chunk_size] fp32. Batch 1, like the kernel."""
    b, hkv, s, d = k_layer.shape
    if b != 1:
        raise ValueError("chunk_scores takes batch 1")
    g = q.shape[1] // hkv
    sc = retrieval_kernel.chunk_scores(q[0].reshape(hkv, g, d), k_layer[0],
                                       chunk=chunk_size, prefill=prefill)
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
    """cache_layer [B, Hkv, S, D] (S >= the chunks' end); chunk_idx
    [B, Hkv, S_sets] -> [B, Hkv, S_sets * chunk_size, D]. Indexes the
    layer in place: no copy of the prefill is made."""
    b, hkv = cache_layer.shape[:2]
    dev = chunk_idx.device
    tok = (chunk_idx[..., None] * chunk_size
           + torch.arange(chunk_size, device=dev)).reshape(b, hkv, -1)
    bi = torch.arange(b, device=dev)[:, None, None]
    hi = torch.arange(hkv, device=dev)[None, :, None]
    return cache_layer[bi, hi, tok]


def build_layer(q, k_layer, v_layer, prefill: int, chunk_size: int,
                budget: int):
    """One layer's retrieval budget region from the last prefill token's
    query: q [B,Hq,1,D]; k_layer/v_layer [B,Hkv,S_max,D] -> (k_sel, v_sel)
    [B, Hkv, budget, D], to be written at retrieval slots [0, budget)."""
    select_sets = budget // chunk_size
    scores = chunk_scores(q, k_layer, prefill, chunk_size)
    idx = select_chunks(scores, select_sets)
    k_sel = gather_chunks(k_layer, idx, chunk_size)
    v_sel = gather_chunks(v_layer, idx, chunk_size)
    return k_sel, v_sel
