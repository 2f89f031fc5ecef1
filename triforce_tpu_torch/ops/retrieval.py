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

Over a mesh whose ``sp`` axis splits the full cache's slots
(``build_layer(mesh=)``), each rank scores its own chunks (the shard
length is a whole number of chunks), one ``all_reduce`` makes the scores
whole on every rank, so every rank selects the same chunks, and a second
one gathers the selected chunks from their owners: the retrieval cache is
split over heads only, whole on every ``sp`` rank.
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


def _chunk_tokens(chunk_idx, chunk_size: int) -> torch.Tensor:
    """[B, Hkv, S_sets] chunk ids -> [B, Hkv, S_sets * chunk_size] slots."""
    b, hkv = chunk_idx.shape[:2]
    return (chunk_idx[..., None] * chunk_size
            + torch.arange(chunk_size, device=chunk_idx.device)).reshape(
                b, hkv, -1)


def gather_chunks(cache_layer, chunk_idx, chunk_size: int) -> torch.Tensor:
    """cache_layer [B, Hkv, S, ...] (S >= the chunks' end); chunk_idx
    [B, Hkv, S_sets] -> [B, Hkv, S_sets * chunk_size, ...]. Indexes the
    layer in place: no copy of the prefill is made. A scale plane
    [B, Hkv, S] gathers the same way (``gather_chunk_scales``)."""
    b, hkv = cache_layer.shape[:2]
    dev = chunk_idx.device
    tok = _chunk_tokens(chunk_idx, chunk_size)
    bi = torch.arange(b, device=dev)[:, None, None]
    hi = torch.arange(hkv, device=dev)[None, :, None]
    return cache_layer[bi, hi, tok]


gather_chunk_scales = gather_chunks


def _scores_sharded(q, k_layer, prefill: int, chunk_size: int, k_scale,
                    mesh) -> torch.Tensor:
    """Every prefill chunk's score from the ranks' slot shards: this rank
    scores the chunks it holds (none when its shard starts past the
    prefill) into zeros, and one ``all_reduce(SUM)`` over ``sp`` makes the
    [B, Hkv, prefill // chunk_size] scores whole on every rank."""
    b, hkv, s_loc, _ = k_layer.shape
    if s_loc % chunk_size:
        raise ValueError(f"shard length {s_loc} is not a whole number of "
                         f"{chunk_size}-token chunks")
    off = mesh.index("sp") * s_loc
    live = min(max(prefill - off, 0), s_loc)
    scores = torch.zeros((b, hkv, prefill // chunk_size), dtype=torch.float32,
                         device=k_layer.device)
    if live:
        c0 = off // chunk_size
        scores[:, :, c0:c0 + live // chunk_size] = chunk_scores(
            q, k_layer, live, chunk_size, k_scale=k_scale)
    return mesh.all_reduce(scores, "sp")


def _gather_sharded(cache_layer, chunk_idx, chunk_size: int, mesh):
    """``gather_chunks`` of global chunk ids from the slot shards: each
    rank takes the selected tokens it owns, zeros for the rest, and one
    ``all_reduce(SUM)`` over ``sp`` gives every rank all of them."""
    b, hkv, s_loc = cache_layer.shape[:3]
    dev = chunk_idx.device
    tok = _chunk_tokens(chunk_idx, chunk_size) - mesh.index("sp") * s_loc
    own = (tok >= 0) & (tok < s_loc)
    bi = torch.arange(b, device=dev)[:, None, None]
    hi = torch.arange(hkv, device=dev)[None, :, None]
    vals = cache_layer[bi, hi, tok.clamp(0, s_loc - 1)]
    own = own.reshape(own.shape + (1,) * (vals.dim() - 3))
    vals = torch.where(own, vals, torch.zeros((), dtype=vals.dtype,
                                              device=dev))
    return mesh.all_reduce(vals.contiguous(), "sp")


def build_layer(q, k_layer, v_layer, prefill: int, chunk_size: int,
                budget: int, k_scale=None, v_scale=None, mesh=None):
    """One layer's retrieval budget region from the last prefill token's
    query: q [B,Hq,1,D]; k_layer/v_layer [B,Hkv,S_max,D] (int8 codes with
    scales [B,Hkv,S_max] when quantized) -> (k_sel, v_sel) [B, Hkv, budget,
    D], plus (ks_sel, vs_sel) [B, Hkv, budget] when quantized, to be written
    at retrieval slots [0, budget). ``mesh``: k/v hold this rank's slots
    ``[sp_index * S_loc, ..)`` of a cache split over ``sp`` (module
    docstring)."""
    select_sets = budget // chunk_size
    if mesh is not None:
        scores = _scores_sharded(q, k_layer, prefill, chunk_size, k_scale,
                                 mesh)
        idx = select_chunks(scores, select_sets)
        planes = (k_layer, v_layer) if k_scale is None \
            else (k_layer, v_layer, k_scale, v_scale)
        return tuple(_gather_sharded(x, idx, chunk_size, mesh)
                     for x in planes)
    scores = chunk_scores(q, k_layer, prefill, chunk_size, k_scale=k_scale)
    idx = select_chunks(scores, select_sets)
    k_sel = gather_chunks(k_layer, idx, chunk_size)
    v_sel = gather_chunks(v_layer, idx, chunk_size)
    if k_scale is None:
        return k_sel, v_sel
    return (k_sel, v_sel, gather_chunk_scales(k_scale, idx, chunk_size),
            gather_chunk_scales(v_scale, idx, chunk_size))
