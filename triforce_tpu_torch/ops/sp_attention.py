"""Sharded append attention — the port of
``triforce_tpu/ops/sp_attention.py``: the KV cache split over the mesh
(heads over ``tp``, and with ``shard_seq`` its slots over ``sp``), each
rank's online-softmax partials over its local shard merged exactly by one
``all_reduce`` pair over ``sp``.

For TriForce this is what holds a 128K cache across cards where the
reference offloads it to host memory: each rank runs the partials kernel
(B4, ``flash_decode_partials`` / ``_int8``, on a CUDA tensor; the plain
``attention_partials`` on the CPU) over its local slots, and the merge
costs two collectives of ``[B, Hkv, G, T(+D)]`` floats per layer,
independent of the context length. The new tokens' block is merged after
the collective on every rank (the same work on each, no extra traffic);
committing the new K/V is left to the caller.

With ``shard_seq=False`` (plain head parallelism, the retrieval cache) no
collective is issued, so every forward over a mesh takes this one code
path.

``prefix_partials_sharded`` is the cache part alone over a fully visible
prefix (the tree grow's self-speculation layers), and
``append_attention_rows_sharded`` the same attention for B rows of a
row-stacked cache, each with its own live length: over ``sp`` every row
takes the partials kernel over its part of the rank's shard and the
row-stacked partials merge in the same two collectives; without a split
of the slots the row-batched kernel (B3) runs on the rank's heads.
"""

from __future__ import annotations

import torch

from .attention import (attention_partials, attention_partials_auto,
                        attention_partials_rows, finalize, merge_partials,
                        new_block_partials)


def _local_len(k_len, mesh, s_loc: int):
    """A GLOBAL live length (an int, a 0-d or a [B] device tensor) in the
    frame of this rank's ``s_loc`` slots of a cache split over ``sp``:
    clamped into [0, s_loc], so a shard past the prefix reads nothing."""
    start = mesh.index("sp") * s_loc
    if torch.is_tensor(k_len):
        return (k_len - start).clamp(0, s_loc)
    return min(max(int(k_len) - start, 0), s_loc)


def _cache_partials_local(q, k, v, k_len, ks, vs, mask_fn=None,
                          layer=None):
    """Online-softmax partials of q [B, Hq, T, D] over this rank's local
    cache shard, in the [B, Hkv, G, T(, D)] layout of
    ``attention_partials``. ``layer``: k/v (and the scales) are the whole
    stacked [L, B, Hkv, S_loc, D] local cache and the kernel reads layer
    ``layer`` of it in place (a view, no copy). Without a cache mask the
    partials kernel runs on a CUDA tensor and ``attention_partials`` on
    the CPU (``attention_partials_auto``); a cache mask takes
    ``attention_partials``."""
    if layer is not None:
        k, v = k[layer], v[layer]
        ks = None if ks is None else ks[layer]
        vs = None if vs is None else vs[layer]
    if mask_fn is None:
        return attention_partials_auto(q, k, v, k_len=k_len, k_scale=ks,
                                       v_scale=vs)
    return attention_partials(q, k, v, k_len=k_len, mask_fn=mask_fn,
                              k_scale=ks, v_scale=vs)


def merge_partials_psum(p, mesh, axis: str = "sp"):
    """Exact merge of every rank's partials over ``axis``: an
    ``all_reduce(MAX)`` of m, then one ``all_reduce(SUM)`` of l and acc
    rescaled to the global maximum (``sp_attention.py:90-98``)."""
    m, l, acc = p
    m_g = mesh.all_reduce(m.contiguous().clone(), axis, "max")
    scale = torch.exp(m - m_g)
    both = torch.cat([(l * scale).reshape(-1),
                      (acc * scale[..., None]).reshape(-1)])
    mesh.all_reduce(both, axis, "sum")
    return (m_g, both[:l.numel()].reshape(l.shape),
            both[l.numel():].reshape(acc.shape))


def _causal(t: int, tn: int, device) -> torch.Tensor:
    rows = torch.arange(t, device=device)[:, None]
    cols = torch.arange(tn, device=device)[None, :]
    return cols <= rows


def append_attention_sharded(mesh, q, k_cache, v_cache, k_new, v_new, *,
                             k_len, new_mask=None, k_scale=None,
                             v_scale=None, shard_seq: bool = True,
                             cache_mask_fn=None, layer=None):
    """Attention of T new tokens against this rank's cache shard and the
    other ranks' over ``sp``, plus the new tokens themselves.

    q/k_new/v_new: [B, H(q|kv)_local, T, D], this rank's heads. k_cache /
    v_cache: this rank's [B, Hkv_local, S_loc, D] shard (or, with
    ``layer``, the whole stacked [L, ...] local cache); with
    ``shard_seq`` the slots ``[sp_index * S_loc, (sp_index + 1) * S_loc)``
    of the global cache, else every slot (and no collective). Scale planes
    [B, Hkv, S_loc] come with an int8 cache. ``k_len`` is the GLOBAL live
    length (an int or a 0-d device tensor), clamped into each shard's
    frame; ``cache_mask_fn(rows, cols)`` is called with global columns.
    Returns [B, Hq_local, T, D] in q's dtype."""
    t, tn = q.shape[2], k_new.shape[2]
    if new_mask is None:
        new_mask = _causal(t, tn, q.device)
    mask_fn = cache_mask_fn
    s_loc = k_cache.shape[-2]
    if shard_seq:
        start = mesh.index("sp") * s_loc
        local_len = _local_len(k_len, mesh, s_loc)
        if cache_mask_fn is not None:
            # the local column frame translated back to global columns
            def mask_fn(rows, cols, _off=start):
                return cache_mask_fn(rows, cols + _off)
    else:
        local_len = k_len
    p = _cache_partials_local(q, k_cache, v_cache, local_len, k_scale,
                              v_scale, mask_fn=mask_fn, layer=layer)
    if shard_seq:
        p = merge_partials_psum(p, mesh, "sp")
    pn = new_block_partials(q, k_new, v_new, new_mask)
    return finalize(merge_partials(p, pn), q.dtype)


def prefix_partials_sharded(mesh, q, k_cache, v_cache, *, k_len,
                            k_scale=None, v_scale=None, layer=None):
    """Partials of q [B, Hq, T, D] over the fully visible GLOBAL prefix
    [0, k_len) of a cache whose slots are split over ``sp``: the partials
    kernel (B4; ``attention_partials`` on the CPU) over this rank's part
    of it, merged over ``sp`` (``merge_partials_psum``). ``layer`` as in
    ``append_attention_sharded``."""
    s_loc = k_cache.shape[-2]
    p = _cache_partials_local(q, k_cache, v_cache,
                              _local_len(k_len, mesh, s_loc), k_scale,
                              v_scale, layer=layer)
    return merge_partials_psum(p, mesh, "sp")


def append_attention_rows_sharded(mesh, q, k_cache, v_cache, k_new, v_new,
                                  *, k_len, k_scale=None, v_scale=None):
    """``append_attention_rows`` over a cache whose slots are split over
    ``sp``: q/k_new/v_new [B, H_local, T, D], this rank's heads; k_cache /
    v_cache one layer of every row [B, Hkv_local, S_loc, D] (scales
    [B, Hkv_local, S_loc]); ``k_len`` [B] the rows' GLOBAL live lengths.
    Each row's partials over its part of the rank's slots (one
    partials-kernel launch a row: B3 returns normalised rows, which cannot
    merge) merge over ``sp``, then the causal new block; a dead row
    (length 0) reads nothing on any shard. (Without a split of the slots
    the row-batched kernel runs on the rank's heads, no collective.)
    Returns [B, Hq_local, T, D] in q's dtype."""
    s_loc = k_cache.shape[-2]
    p = attention_partials_rows(q, k_cache, v_cache,
                                k_len=_local_len(k_len, mesh, s_loc),
                                k_scale=k_scale, v_scale=v_scale)
    p = merge_partials_psum(p, mesh, "sp")
    pn = new_block_partials(q, k_new, v_new,
                            _causal(q.shape[2], k_new.shape[2], q.device))
    return finalize(merge_partials(p, pn), q.dtype)


def sp_append_attention(mesh, q, k_cache, v_cache, k_new, v_new, *, k_len,
                        new_mask=None):
    """Sequence-sharded append attention (the JAX package's alias)."""
    return append_attention_sharded(mesh, q, k_cache, v_cache, k_new, v_new,
                                    k_len=k_len, new_mask=new_mask,
                                    shard_seq=True)
