"""The int8 attention over a cache split in two shards, put back together,
against the int8 attention over the whole cache: the identity behind
chip_smoke.py's B4-int8 gate at a rank's shard shapes (ROADMAP C item 2).

Two 4096-key shards of an 8192-slot int8 cache: each shard's plain
partials (``flash_decode_partials_int8_plain``), merged as
``merge_partials_psum`` merges them over two ranks (threads of one
process), then the new block folded in as B1-int8's fold folds it
(``flash_decode_fold_int8_plain``: q'' = bf16(q8 * qs), p rounded against
the row's final maximum), are plain B1-int8 over the whole cache
(``flash_decode_append_int8_plain``) up to fp32 summation order. With the
new block merged as the mesh path merges it (``new_block_partials`` +
``merge_partials``, p rounded against the block's own maximum), the two
differ by the bf16 rounding of the new block's p, and by no more. Both
the composition and the whole are held against the JAX package's
``quant`` branch in interpret mode, at its block as their group.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_mesh_worker import run_threads
from triforce_tpu.ops.flash_decode import flash_decode_append as j_fda
from triforce_tpu_torch import cache as tcache
from triforce_tpu_torch.ops import attention as tatt
from triforce_tpu_torch.ops import flash_decode as tfd
from triforce_tpu_torch.ops import sp_attention as tsp

D, S, SHARDS, BLOCK = 128, 8192, 2, 512
# chip_smoke.py's tolerance of an int8 kernel against its plain version,
# over sqrt(k_len + Tn)
INT8_B1_TOL = 0.005
# the composition against the whole in fp32: a two-term merge rescales each
# shard's sums once more than the one pass does, a few fp32 roundings of
# outputs of a few units; readings were 3.4e-8 at most
FP32_TOL = 5e-7
# k_len: the whole cache; one that ends inside a 64-key tile (and inside a
# p group of the second shard)
CASES = [(8, 2, 8192), (8, 2, 8155), (64, 1, 8192), (64, 1, 8155)]


def _inputs(gt, hkv, k_len, seed):
    """bf16-valued q, new block and a random 60% mask (token 0 always);
    the int8 codes and scales of a bf16 cache, slots past k_len poisoned."""
    rng = np.random.default_rng(seed)

    def bf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)

    q, kn, vn = bf(hkv, gt, D), bf(hkv, gt, D), bf(hkv, gt, D)
    (k, ks), (v, vs) = (tcache.quantize_tokens(bf(hkv, S, D))
                        for _ in range(2))
    k[:, k_len:], v[:, k_len:] = 127, -127          # never read
    ks[:, k_len:], vs[:, k_len:] = 1e3, 1e3
    mask = torch.from_numpy(rng.random((gt, gt)) < 0.6)
    mask[:, 0] = True
    return q, kn, vn, k, v, ks, vs, mask


def _shard_partials(q, k, v, ks, vs, k_len, group):
    """Each shard's plain partials over its part of [0, k_len), merged by
    ``merge_partials_psum`` over ``SHARDS`` thread ranks."""
    s_loc = S // SHARDS
    parts = []
    for r in range(SHARDS):
        sl = slice(r * s_loc, (r + 1) * s_loc)
        local = min(max(k_len - r * s_loc, 0), s_loc)
        parts.append(tfd.flash_decode_partials_int8_plain(
            q, k[:, sl], v[:, sl], torch.tensor(local, dtype=torch.int32),
            ks[:, sl], vs[:, sl], group=group))
    return run_threads(lambda mesh: tsp.merge_partials_psum(
        tuple(x.clone() for x in parts[mesh.index("sp")]), mesh, "sp"),
        sp=SHARDS)[0]


def _merge_frame(q, merged, kn, vn, mask):
    """The new block merged as the mesh path merges it, with q'' as its
    query (what the gate showed it): p rounded against its own maximum."""
    hkv, gt, _ = q.shape
    q8, qs = tfd._quantize_rows(
        (q.float() * tfd._scale(D)).to(torch.bfloat16).float())
    qn = (q8 * qs).to(torch.bfloat16).reshape(1, hkv, 1, gt, D)
    pn = tatt._update(qn, *tatt._init_partials(q[None], hkv), kn[None],
                      vn[None], mask)
    m, l, acc = merged
    part = (m.reshape(1, hkv, 1, gt), l.reshape(1, hkv, 1, gt),
            acc.reshape(1, hkv, 1, gt, D))
    return tatt.finalize(tatt.merge_partials(part, pn), torch.float32)[0], qn


def _frame_bound(qn, merged, kn, vn, mask):
    """2^-7 of each output's new-block share sum_j p_j |v_j| / l, with p
    against the row's final maximum: each p, rounded to bf16 (8 bits) in
    one frame and in the other, sits within 2^-8 of itself in both."""
    m, l, _ = (x.double() for x in merged)
    sn = torch.einsum("hgd,hnd->hgn", qn[0, :, 0].double(), kn.double())
    sn = sn + torch.where(mask, 0.0, -1e30).double()
    mf = torch.maximum(m, sn.amax(-1))
    pn = torch.exp(sn - mf[..., None])
    lf = l * torch.exp(m - mf) + pn.sum(-1)
    share = torch.einsum("hgn,hnd->hgd", pn, vn.double().abs())
    return (2.0 ** -7 * share / lf[..., None]).float()


@pytest.mark.parametrize("gt,hkv,k_len", CASES)
def test_shards_merged_then_folded_are_b1_int8(gt, hkv, k_len):
    q, kn, vn, k, v, ks, vs, mask = _inputs(gt, hkv, k_len, 100 + gt)
    merged = _shard_partials(q, k, v, ks, vs, k_len, tfd.KERNEL_GROUP)
    got = tfd.flash_decode_fold_int8_plain(q, *merged, kn, vn, mask)
    whole = tfd.flash_decode_append_int8_plain(
        q, k, v, kn, vn, torch.tensor(k_len, dtype=torch.int32), mask, ks,
        vs, group=tfd.KERNEL_GROUP)
    assert torch.isfinite(got).all() and got.shape == (hkv, gt, D)
    err = (got - whole).abs().max().item()
    assert err <= FP32_TOL
    # merged as the mesh path merges the new block: the rounding frame of
    # its p alone sets it apart from B1-int8, within the frame's bound, and
    # far beyond the fold's fp32 order
    mesh_way, qn = _merge_frame(q, merged, kn, vn, mask)
    bound = _frame_bound(qn, merged, kn, vn, mask)
    assert ((mesh_way - whole).abs() <= bound + FP32_TOL).all()
    assert (mesh_way - whole).abs().max().item() > max(10 * err, FP32_TOL)
    # the gate's tolerance sees a new block left out of the fold
    lost = tfd.flash_decode_fold_int8_plain(q, *merged, kn, vn,
                                            torch.zeros_like(mask))
    tol = INT8_B1_TOL / (k_len + gt) ** 0.5
    assert (lost - whole).abs().max().item() > 10 * tol


def _close_up_to_flips(got, want, flip_bound):
    """Within fp32 tolerance elementwise, except where a p code flipped by
    one step between the frameworks (exp differs by an ulp): such an
    element moves by at most ps * |v8| / l <= max vs; at most 0.5% may
    (``tests/test_torch_kv_quant.py``)."""
    diff = np.abs(got - want)
    over = diff > 2e-5 + 2e-5 * np.abs(want)
    assert over.mean() <= 5e-3, over.mean()
    assert diff.max() <= flip_bound, diff.max()


@pytest.mark.parametrize("gt,hkv,k_len", CASES)
def test_shard_composition_and_whole_match_jax_quant_branch(gt, hkv, k_len):
    """The composition (shards merged, then folded) and plain B1-int8 over
    the whole cache, each at the Pallas kernel's block as their group,
    against the TPU kernel's ``quant`` branch in interpret mode. The inputs
    are fp32 holding bf16 values, so that neither framework rounds the new
    block's p and the comparison is of the int8 arithmetic."""
    q, kn, vn, k, v, ks, vs, mask = (
        x.float() if x.dtype == torch.bfloat16 else x
        for x in _inputs(gt, hkv, k_len, 200 + gt))
    want = np.asarray(j_fda(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), jnp.asarray(kn.numpy()),
        jnp.asarray(vn.numpy()), jnp.asarray(k_len),
        jnp.asarray(mask.numpy()), block=BLOCK, interpret=True,
        k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy())))
    merged = _shard_partials(q, k, v, ks, vs, k_len, BLOCK)
    got = tfd.flash_decode_fold_int8_plain(q, *merged, kn, vn, mask)
    whole = tfd.flash_decode_append_int8_plain(
        q, k, v, kn, vn, torch.tensor(k_len, dtype=torch.int32), mask, ks,
        vs, group=BLOCK)
    flip = vs[:, :k_len].max().item()
    _close_up_to_flips(got.numpy(), want, flip)
    _close_up_to_flips(whole.numpy(), want, flip)
    assert (got - whole).abs().max().item() <= FP32_TOL
