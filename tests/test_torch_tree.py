"""Tree speculation (Sequoia mode) of the port against the JAX package on
the tiny target in fp32, at the shapes of tests/test_tree.py (prefill 32,
budget 16, chunk 4, an 8-node tree): the planner copy, the sampling ops of
the grow, the tree caches, the tree verify, int8 activations, the grow
forward, the partials kernel's plain versions (against the Pallas kernel in
interpret mode) and the TreeEngine end to end.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: fp32 end to end, the frameworks differ in summation order only,
so logits and caches agree to ~1e-6 (2e-5 allowed); integer codes are
equal. A torch Generator never yields JAX's threefry stream, so engines are
compared near-greedy (temperature 1e-3: the top-p nucleus is one token and
every draw is immaterial) on a prompt without near ties, and the sampled
behaviour by distribution (chi-square).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sstats

from triforce_tpu import cache as jcache
from triforce_tpu import config as jcfg
from triforce_tpu.models import llama as jl
from triforce_tpu.ops import attention as jatt
from triforce_tpu.ops import sampling as jsamp
from triforce_tpu.ops.flash_decode import flash_decode_partials as j_fdp
from triforce_tpu.tree import planner as jplan
from triforce_tpu.tree import spectree as jtree
from triforce_tpu_torch import cache as tcache
from triforce_tpu_torch import config as tcfg
from triforce_tpu_torch.models import llama as tl
from triforce_tpu_torch.ops import attention as tatt
from triforce_tpu_torch.ops import flash_decode as tfd
from triforce_tpu_torch.ops import sampling as tsamp
from triforce_tpu_torch.tree import planner as tplan
from triforce_tpu_torch.tree import spectree as ttree

torch.set_num_threads(1)

JC, TC = jcfg.TINY_TARGET, tcfg.TINY_TARGET
PREFILL, BUDGET, CHUNK = 32, 16, 4
TOL = dict(rtol=2e-5, atol=2e-5)


def _np(x):
    return np.array(x)


def _grow_map(pl, size=8, depth=4, branch=3):
    p = pl.modeled_acceptance_vector(0.8, max_branch=branch)
    T, choice = pl.plan_tree(p, max_budget=size, max_depth=depth)
    return pl.build_grow_map(T, choice, size, depth)


@pytest.fixture(scope="module")
def target():
    pj = jl.init_params(jax.random.PRNGKey(0), JC, dtype=jnp.float32)
    pt = tl.params_from_numpy(jax.tree.map(np.asarray, pj), TC, "cpu")
    return pj, pt


def _ids(n, seed=0, lo=0):
    return np.random.default_rng(seed).integers(lo, JC.vocab_size, (1, n))


# ---------------------------------------------------------------------------
# planner, sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,depth", [(8, 4), (64, 11), (128, 12)])
def test_planner_copy_matches(size, depth):
    """The port's own planner gives the JAX package's grow map field by
    field, and ``_padded_levels`` the same tables."""
    gj, gt = (_grow_map(pl, size, depth, 4) for pl in (jplan, tplan))
    assert gt.size == gj.size == size
    assert gt.roots == gj.roots and gt.branches == gj.branches
    for name in ("successors", "mask", "depth"):
        np.testing.assert_array_equal(getattr(gt, name), getattr(gj, name))
        assert getattr(gt, name).dtype == getattr(gj, name).dtype
    assert gt.num_levels == gj.num_levels
    assert gt.max_children == gj.max_children
    assert gt.level_slices() == gj.level_slices()
    pj, pt = jtree._padded_levels(gj), ttree._padded_levels(gt)
    assert pt[:2] == pj[:2]
    for a, b in zip(pt[2:], pj[2:]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_topk_small_matches():
    x = np.random.default_rng(0).standard_normal((5, 199)).astype(np.float32)
    x[0, 7] = x[0, 3]            # a tie: the lower index goes first
    want = _np(jsamp.topk_small(jnp.asarray(x), 4))
    got = tsamp.topk_small(torch.from_numpy(x), 4)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_topk_small_support_smaller_than_k():
    """Entries at the -1e30 sentinel (zero probability): a support of 2
    with k = 4 still gives distinct indices, the support first."""
    x = np.full((2, 50), -1e30, np.float32)
    x[0, [9, 30]] = [0.5, 2.0]
    x[1, [0, 49]] = [1.0, -3.0]
    want = _np(jsamp.topk_small(jnp.asarray(x), 4))
    got = tsamp.topk_small(torch.from_numpy(x), 4).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, :2].tolist() == [30, 9] and got[1, :2].tolist() == [0, 49]
    assert all(len(set(r)) == 4 for r in got.tolist())


def test_gumbel_topk_without_replacement_marginal():
    """k distinct picks per row; the first pick is distributed as probs
    (chi-square over 4000 rows, fixed seed)."""
    probs = np.array([0.4, 0.25, 0.15, 0.1, 0.06, 0.04, 0.0], np.float32)
    n = 4000
    got = tsamp.gumbel_topk_without_replacement(
        torch.from_numpy(probs).expand(n, -1), 3,
        torch.Generator().manual_seed(0)).numpy()
    assert got.shape == (n, 3)
    assert all(len(set(r)) == 3 for r in got.tolist())
    assert (got != 6).all()                 # never the zero-probability one
    obs = np.bincount(got[:, 0], minlength=7)[:6]
    stat = float(((obs - probs[:6] * n) ** 2 / (probs[:6] * n)).sum())
    assert sstats.chi2.sf(stat, 5) > 1e-3, stat


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_init_tree_retrieval_shapes(quant):
    rj = jcache.init_tree_retrieval(JC, BUDGET, 8, dtype=jnp.float32,
                                    quant=quant, pad=3)
    rt = tcache.init_tree_retrieval(TC, BUDGET, 8, dtype=torch.float32,
                                    device="cpu", quant=quant, pad=3)
    assert tuple(rt.k.shape) == rj.k.shape == (
        JC.num_layers, 1, JC.num_kv_heads, BUDGET + 8 + 3, JC.head_dim)
    assert rt.v.shape == rt.k.shape and rt.quantized == quant
    assert rt.k.dtype == (torch.int8 if quant else torch.float32)
    if quant:
        assert tuple(rt.k_scale.shape) == rj.k_scale.shape
        assert rt.k_scale.dtype == torch.float32
    assert rt.real_budget == BUDGET + 8 + 3


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_gather_kv_incremental_bitwise(quant):
    """The accepted path's slots move to the front of the tree region,
    codes and scales alike, bit for bit; the move overlaps itself (slot
    offset + 1 is both read and written)."""
    rng = np.random.default_rng(3)
    shape = (2, 1, 2, 40, 8)
    offset, size, max_path = 20, 8, 5
    accept = np.array([0, 1, 4, 7, 6], np.int32)
    for n_acc in (1, 3, 5):
        if quant:
            k, v = (rng.integers(-127, 128, shape).astype(np.int8)
                    for _ in range(2))
            ks, vs = (rng.random(shape[:4]).astype(np.float32)
                      for _ in range(2))
            kj = jcache.KVCache(jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(offset + size, jnp.int32),
                                jnp.asarray(ks), jnp.asarray(vs))
            kt = tcache.KVCache(torch.from_numpy(k.copy()),
                                torch.from_numpy(v.copy()),
                                torch.tensor(offset + size, dtype=torch.int32),
                                torch.from_numpy(ks.copy()),
                                torch.from_numpy(vs.copy()))
        else:
            k, v = (rng.standard_normal(shape).astype(np.float32)
                    for _ in range(2))
            kj = jcache.KVCache(jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(offset + size, jnp.int32))
            kt = tcache.KVCache(torch.from_numpy(k.copy()),
                                torch.from_numpy(v.copy()),
                                torch.tensor(offset + size, dtype=torch.int32))
        kj = jcache.gather_kv_incremental(
            kj, jnp.asarray(accept), jnp.asarray(n_acc, jnp.int32),
            jnp.asarray(offset, jnp.int32), max_path, max_span=size)
        kt = tcache.gather_kv_incremental(
            kt, torch.from_numpy(accept), n_acc,
            torch.tensor(offset, dtype=torch.int32), max_path, max_span=size)
        assert int(kt.seq_len) == int(kj.seq_len) == offset + n_acc
        assert kt.seq_len.dtype == torch.int32
        for name in ("k", "v") + (("k_scale", "v_scale") if quant else ()):
            np.testing.assert_array_equal(getattr(kt, name).numpy(),
                                          _np(getattr(kj, name)))
        # the path itself: slot offset + j holds what offset + accept[j] held
        np.testing.assert_array_equal(
            kt.k[:, :, :, offset:offset + n_acc].numpy(),
            k[:, :, :, offset + accept[:n_acc]])


# ---------------------------------------------------------------------------
# tree verify: forward_append(positions, tree_mask)
# ---------------------------------------------------------------------------

def _prefilled(pj, pt, quant=False, max_len=80, seed=1):
    """Both packages' full caches after the same 32-token prompt."""
    ids = _ids(PREFILL, seed)
    kvj = jcache.init_kv(JC, max_len, dtype=jnp.float32, quant=quant)
    kvt = tcache.init_kv(TC, max_len, dtype=torch.float32, device="cpu",
                         quant=quant)
    _, kvj, _ = jl.forward_append(JC, pj, jnp.asarray(ids), kvj)
    _, kvt, _ = tl.forward_append(TC, pt, torch.from_numpy(ids), kvt)
    return kvj, kvt


def test_forward_append_tree_mask_logits_and_cache(target):
    pj, pt = target
    gm = _grow_map(tplan)
    kvj, kvt = _prefilled(pj, pt)
    toks = _ids(gm.size, 5)
    lj, kvj, _ = jl.forward_append(
        JC, pj, jnp.asarray(toks), kvj,
        positions=kvj.seq_len + jnp.asarray(gm.depth, jnp.int32),
        tree_mask=gm.mask)
    lt, kvt, _ = tl.forward_append(
        TC, pt, torch.from_numpy(toks), kvt,
        positions=kvt.seq_len + torch.from_numpy(gm.depth),
        tree_mask=torch.from_numpy(gm.mask))
    np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
    np.testing.assert_allclose(kvt.k.numpy(), _np(kvj.k), **TOL)
    np.testing.assert_allclose(kvt.v.numpy(), _np(kvj.v), **TOL)
    assert int(kvt.seq_len) == int(kvj.seq_len) == PREFILL + gm.size


def test_tree_verify_matches_sequential_forward(target):
    """The port's one-shot tree-masked verify gives, along the deepest
    root-to-leaf chain, the logits of feeding that chain sequentially (the
    tolerance of tests/test_tree.py)."""
    _, pt = target
    gm = _grow_map(tplan)
    _, kvt = _prefilled(*target)
    parents = {int(c): i for i in range(gm.size) for c in gm.successors[i]
               if c >= 0}
    chain = [int(np.argmax(gm.depth))]
    while chain[-1] != 0:
        chain.append(parents[chain[-1]])
    chain.reverse()
    tokens = np.full((gm.size,), 7, np.int64)
    tokens[chain] = (11 + np.arange(len(chain))) % TC.vocab_size
    seq = kvt.clone()
    l_tree, _, _ = tl.forward_append(
        TC, pt, torch.from_numpy(tokens)[None], kvt,
        positions=kvt.seq_len + torch.from_numpy(gm.depth),
        tree_mask=gm.mask)
    l_seq, _, _ = tl.forward_append(TC, pt,
                                    torch.from_numpy(tokens[chain])[None], seq)
    np.testing.assert_allclose(l_tree[0, chain].numpy(), l_seq[0].numpy(),
                               atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------------------
# int8 activations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,shape", [("wq", (1, 5, 64)),
                                        ("w_down", (2, 3, 128)),
                                        ("lm_head", (1, 4, 64))])
def test_wmm_act_quant_matches_jax(target, name, shape):
    """``_wmm(aq=True)``: the same activation codes and the exact integer
    product on both sides, so only the two fp32 scale products round:
    1e-6 relative. Without int8 weights ``aq`` changes nothing."""
    pj, pt = target
    qj, qt = jl.quantize_weights(pj), tl.quantize_weights(pt)
    lj = qj if name == "lm_head" else jax.tree.map(lambda a: a[1],
                                                   qj["layers"])
    lt = qt if name == "lm_head" else tl._layer(qt, 1)
    assert shape[-1] == lt[name].shape[0]
    x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    x[0, 0] = 0.0                  # an all-zero token: the 1e-6 floor
    pet = jnp.float32 if name == "lm_head" else None
    want = _np(jl._wmm(jnp.asarray(x), "bth,ho->bto", lj, name, pet=pet,
                       aq=True))
    got = tl._wmm(torch.from_numpy(x), lt, name, aq=True,
                  out_dtype=torch.float32 if pet else None).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    # it is not the weight-only product (activation rounding shows) ...
    exact = tl._wmm(torch.from_numpy(x), lt, name).numpy()
    gap = np.abs(got - exact).max()
    assert 0 < gap < 0.05 * np.abs(exact).max()
    # ... and a weight that is not int8 ignores aq
    plain = pt if name == "lm_head" else tl._layer(pt, 1)
    np.testing.assert_array_equal(
        tl._wmm(torch.from_numpy(x), plain, name, aq=True).numpy(),
        tl._wmm(torch.from_numpy(x), plain, name).numpy())


def test_int_matmul_is_exact_past_2_to_24():
    """Sums of 127 * 127 * K pass 2^24 at model widths; the product stays
    exact (fp32 would not)."""
    x = torch.full((3, 2048), 127, dtype=torch.int8)
    w = torch.full((2048, 8), 127, dtype=torch.int8)
    w[:, 1] = -127
    out = tl._int_matmul(x, w)
    assert out.dtype == torch.int32 and out.shape == (3, 8)
    assert out[0, 0].item() == 127 * 127 * 2048 > 2 ** 24
    assert out[2, 1].item() == -127 * 127 * 2048


# ---------------------------------------------------------------------------
# the grow forward
# ---------------------------------------------------------------------------

def _check_planes(ct, cj, quant):
    if quant:
        np.testing.assert_array_equal(ct.k.numpy(), _np(cj.k))
        np.testing.assert_array_equal(ct.v.numpy(), _np(cj.v))
        np.testing.assert_allclose(ct.k_scale.numpy(), _np(cj.k_scale), **TOL)
        np.testing.assert_allclose(ct.v_scale.numpy(), _np(cj.v_scale), **TOL)
    else:
        np.testing.assert_allclose(ct.k.numpy(), _np(cj.k), **TOL)
        np.testing.assert_allclose(ct.v.numpy(), _np(cj.v), **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("ssl", [0, 1])
def test_forward_tree_spec_root_and_two_levels(target, ssl, quant):
    """The root forward and the first two padded grow levels, chained on
    one pair of caches: logits, the tree retrieval cache and (with ``ssl``
    layers reading and staging in it) the full cache."""
    pj, pt = target
    gm = _grow_map(tplan)
    W, _, _, widths, starts, _, _, depth_rows, mask_rows = \
        ttree._padded_levels(gm)
    kvj, kvt = _prefilled(pj, pt, quant=quant,
                          max_len=PREFILL + gm.size + W + 4)
    rng = np.random.default_rng(11)
    rshape = (JC.num_layers, 1, JC.num_kv_heads, BUDGET + gm.size + W,
              JC.head_dim)
    if quant:
        rk, rv = (rng.integers(-127, 128, rshape).astype(np.int8)
                  for _ in range(2))
        rks, rvs = ((rng.random(rshape[:4]) * 0.02).astype(np.float32)
                    for _ in range(2))
        rj = jcache.RetrievalCache(jnp.asarray(rk), jnp.asarray(rv),
                                   jnp.asarray(rks), jnp.asarray(rvs))
        rt = tcache.RetrievalCache(*(torch.from_numpy(a.copy())
                                     for a in (rk, rv, rks, rvs)))
    else:
        rk, rv = (rng.standard_normal(rshape).astype(np.float32)
                  for _ in range(2))
        rj = jcache.RetrievalCache(jnp.asarray(rk), jnp.asarray(rv))
        rt = tcache.RetrievalCache(torch.from_numpy(rk.copy()),
                                   torch.from_numpy(rv.copy()))
    seq_j, seq_t = kvj.seq_len, kvt.seq_len
    steps = [(_ids(1, 20), gm.depth[0:1], gm.mask[0:1], 0, 0)]
    for lvl in (0, 1):
        toks = _ids(W, 21 + lvl)
        toks[0, widths[lvl]:] = 100          # the junk padding
        steps.append((toks, depth_rows[lvl], mask_rows[lvl],
                      int(starts[lvl]), gm.size))
    for toks, depths, amask, start, staged in steps:
        lj, rj, kvj = jl.forward_tree_spec(
            JC, pj, jnp.asarray(toks), rj, seq_j, BUDGET, depths=depths,
            ancestor_mask=amask, slot_start=start, kv=kvj, ssl=ssl,
            staged_len=staged)
        lt, rt2, kvt2 = tl.forward_tree_spec(
            TC, pt, torch.from_numpy(toks), rt, seq_t, BUDGET, depths=depths,
            ancestor_mask=amask, slot_start=start, kv=kvt, ssl=ssl,
            staged_len=staged)
        assert rt2 is rt and kvt2 is kvt          # written in place
        np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
        _check_planes(rt, rj, quant)
        _check_planes(kvt, kvj, quant)
    assert int(kvt.seq_len) == PREFILL            # the grow commits nothing
    if ssl:     # layer 0 staged its nodes in the full cache, not in rkv
        assert not np.array_equal(kvt.k[0, :, :, PREFILL:PREFILL + 3].numpy(),
                                  np.zeros_like(kvt.k[0, :, :, :3].numpy()))
        np.testing.assert_array_equal(rt.k[0].numpy(), rk[0])


def test_forward_tree_spec_act_quant_matches_jax(target):
    """The grow forward with int8 weights and int8 activations (what
    ``TreeEngine(weight_quant=True)`` grows with): the integer products are
    exact, so the logits keep the fp32 tolerance."""
    pj, pt = target
    qj, qt = jl.quantize_weights(pj), tl.quantize_weights(pt)
    gm = _grow_map(tplan)
    kvj, kvt = _prefilled(pj, pt)
    rj = jcache.init_tree_retrieval(JC, BUDGET, gm.size, dtype=jnp.float32,
                                    pad=4)
    rt = tcache.init_tree_retrieval(TC, BUDGET, gm.size, dtype=torch.float32,
                                    device="cpu", pad=4)
    toks = _ids(1, 30)
    lj, rj, _ = jl.forward_tree_spec(
        JC, qj, jnp.asarray(toks), rj, kvj.seq_len, BUDGET,
        depths=gm.depth[0:1], ancestor_mask=gm.mask[0:1], slot_start=0,
        act_quant=True)
    lt, rt, _ = tl.forward_tree_spec(
        TC, qt, torch.from_numpy(toks), rt, kvt.seq_len, BUDGET,
        depths=gm.depth[0:1], ancestor_mask=gm.mask[0:1], slot_start=0,
        act_quant=True)
    np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
    np.testing.assert_allclose(rt.k.numpy(), _np(rj.k), **TOL)


def test_forward_tree_spec_mesh_raises(target):
    """The grow over a mesh runs: over a one-rank mesh (every collective
    issued, adding nothing) ``forward_tree_spec`` gives the meshless
    logits and retrieval cache bit for bit (tp x sp against JAX's sharded
    grow: ``tests/test_torch_sharded_rows_tree.py``); a ``TreeEngine``
    refuses what is not a ``parallel.mesh.Mesh``."""
    from triforce_tpu_torch.parallel import mesh as tmesh
    _, pt = target
    gm = _grow_map(tplan)
    outs = []
    for mesh in (None, tmesh.single_device_mesh(device="cpu")):
        rt = tcache.init_tree_retrieval(TC, BUDGET, gm.size,
                                        dtype=torch.float32, device="cpu")
        lt, rt, _ = tl.forward_tree_spec(
            TC, pt, torch.full((1, 1), 7, dtype=torch.int64), rt, 32,
            BUDGET, depths=gm.depth[0:1], ancestor_mask=gm.mask[0:1],
            slot_start=0, mesh=mesh)
        outs.append((lt, rt.k))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    with pytest.raises(TypeError, match="Mesh"):
        ttree.TreeEngine(TC, gm, pt, prefill=PREFILL, max_cache_len=64,
                         budget=BUDGET, chunk_size=CHUNK, device="cpu",
                         mesh=object())


# ---------------------------------------------------------------------------
# kernel B4: the plain versions against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

HKV, S, D, BLOCK = 2, 512, 32, 128
K_LENS = [0, 300, 256, 512]


def _assert_partials(got, want, tol):
    """(m, l, acc) against the Pallas kernel's: m to ``tol``, l and acc
    relative to their scale. With k_len = 0 both are (-1e30, 0, 0)."""
    m, l, acc = (x.numpy() for x in got)
    mj, lj, accj = (_np(x) for x in want)
    assert m.shape == mj.shape and l.shape == lj.shape \
        and acc.shape == accj.shape
    np.testing.assert_allclose(m, mj, **tol)
    np.testing.assert_allclose(l, lj, rtol=tol["rtol"],
                               atol=tol["atol"] * max(np.abs(lj).max(), 1))
    np.testing.assert_allclose(acc, accj, rtol=tol["rtol"],
                               atol=tol["atol"] * max(np.abs(accj).max(), 1))


@pytest.mark.parametrize("gt", [1, 4, 22, 256])
def test_partials_plain_matches_pallas_interpret(gt):
    """GT in {1, 4, 22, 256 (the q-tiled Pallas path)} at every k_len case,
    over a slab and over a layer of the stacked cache (a view here, the
    ``layer`` argument there). fp32: the blockwise kernel rescales a
    running sum, the plain version sums once."""
    rng = np.random.default_rng(gt)
    q = rng.standard_normal((HKV, gt, D)).astype(np.float32)
    kst, vst = (rng.standard_normal((3, HKV, S, D)).astype(np.float32)
                for _ in range(2))
    for k_len in K_LENS:
        want = j_fdp(jnp.asarray(q), jnp.asarray(kst), jnp.asarray(vst),
                     jnp.asarray(k_len), block=BLOCK, interpret=True,
                     layer=jnp.asarray(2))
        slab = j_fdp(jnp.asarray(q), jnp.asarray(kst[2]),
                     jnp.asarray(vst[2]), jnp.asarray(k_len), block=BLOCK,
                     interpret=True)
        got = tfd.flash_decode_partials(
            torch.from_numpy(q), torch.from_numpy(kst)[2],
            torch.from_numpy(vst)[2], torch.tensor(k_len, dtype=torch.int32))
        _assert_partials(got, want, TOL)
        _assert_partials(got, slab, TOL)
        if k_len == 0:         # the state the TPU kernel starts from
            assert (got[0] == -1e30).all() and (got[1] == 0).all() \
                and (got[2] == 0).all()
    assert tfd.flash_decode_partials.launches == 0      # no kernel on CPU


def test_partials_plain_bf16_and_xla_partials():
    """bf16 inputs: p is rounded to bf16 against the global maximum here
    and against a running maximum in the blockwise kernel (one bf16 ulp,
    2^-8 relative). And the partials merge with a new block into what
    ``append_attention`` gives (the CPU path of the grow attention)."""
    rng = np.random.default_rng(2)
    q, k, v = (np.array(jnp.asarray(rng.standard_normal(s), jnp.bfloat16)
                        .astype(jnp.float32))
               for s in [(HKV, 8, D), (HKV, S, D), (HKV, S, D)])
    want = j_fdp(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                 jnp.asarray(v, jnp.bfloat16), jnp.asarray(300), block=BLOCK,
                 interpret=True)
    got = tfd.flash_decode_partials_plain(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), 300)
    _assert_partials(got, want, dict(rtol=2e-2, atol=2e-2))
    # fp32: merged with the new block = the partials path's attention
    kn, vn = (rng.standard_normal((1, HKV, 8, D)).astype(np.float32)
              for _ in range(2))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    m, l, acc = tfd.flash_decode_partials(qt, kt, vt, 300)
    mask = tfd.causal_mask(8, 8, 1, "cpu")
    p = (m.reshape(1, HKV, 1, 8), l.reshape(1, HKV, 1, 8),
         acc.reshape(1, HKV, 1, 8, D))
    pn = tatt.new_block_partials(qt[None], torch.from_numpy(kn),
                                 torch.from_numpy(vn), mask)
    out = tatt.finalize(tatt.merge_partials(p, pn), torch.float32)
    ref = jatt.append_attention(jnp.asarray(q)[None], jnp.asarray(k)[None],
                                jnp.asarray(v)[None], jnp.asarray(kn),
                                jnp.asarray(vn), k_len=jnp.asarray(300))
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)
    # an empty prefix merges cleanly: the new block alone, no NaN
    empty = tfd.flash_decode_partials(qt, kt, vt, 0)
    p0 = (empty[0].reshape(1, HKV, 1, 8), empty[1].reshape(1, HKV, 1, 8),
          empty[2].reshape(1, HKV, 1, 8, D))
    alone = tatt.finalize(tatt.merge_partials(p0, pn), torch.float32)
    assert torch.isfinite(alone).all()
    torch.testing.assert_close(alone, tatt.finalize(pn, torch.float32))


@pytest.mark.parametrize("gt", [1, 22, 256])
def test_partials_int8_plain_matches_pallas_interpret(gt):
    """The int8 plain version at the Pallas block as its group: the same
    integer codes up to a rare one-step flip of a p code (exp differs by
    an ulp between the frameworks), which moves the normalised acc / l by
    at most one code step, ps * |v8| / l <= max vs."""
    rng = np.random.default_rng(40 + gt)
    q = rng.standard_normal((HKV, gt, D)).astype(np.float32)
    k8, v8 = (rng.integers(-127, 128, (HKV, S, D)).astype(np.int8)
              for _ in range(2))
    ks, vs = ((rng.random((HKV, S)) * 0.02 + 0.005).astype(np.float32)
              for _ in range(2))
    for k_len in K_LENS:
        want = j_fdp(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
                     jnp.asarray(k_len), block=BLOCK, interpret=True,
                     k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        got = tfd.flash_decode_partials_int8_plain(
            torch.from_numpy(q), torch.from_numpy(k8), torch.from_numpy(v8),
            torch.tensor(k_len, dtype=torch.int32), torch.from_numpy(ks),
            torch.from_numpy(vs), group=BLOCK)
        m, l, acc = (x.numpy() for x in got)
        mj, lj, accj = (_np(x) for x in want)
        np.testing.assert_allclose(m, mj, **TOL)
        np.testing.assert_allclose(l, lj, rtol=2e-5, atol=2e-5)
        # compare normalised, as the int8 B1 test does: at most 0.5% of the
        # outputs off the fp32 tolerance, none by more than one code step
        norm = np.maximum(lj, 1e-37)[..., None]
        diff = np.abs(acc / norm - accj / norm)
        over = diff > 2e-5 + 2e-5 * np.abs(accj / norm)
        assert over.mean() <= 5e-3, (k_len, over.mean())
        assert diff.max() <= vs.max(), (k_len, diff.max())
        if k_len == 0:
            assert (m == -1e30).all() and (l == 0).all() and (acc == 0).all()
    # the wrapper on the CPU is the plain version at the CUDA kernel's group
    args = (torch.from_numpy(q), torch.from_numpy(k8), torch.from_numpy(v8),
            300, torch.from_numpy(ks), torch.from_numpy(vs))
    for a, b in zip(tfd.flash_decode_partials_int8(*args),
                    tfd.flash_decode_partials_int8_plain(
                        *args, group=tfd.KERNEL_GROUP)):
        assert torch.equal(a, b)
    assert tfd.flash_decode_partials_int8.launches == 0


def test_partials_non_cpu_tensor_never_takes_the_plain_path():
    q = torch.empty((HKV, 1, D), device="meta")
    with pytest.raises(ValueError):
        tfd.flash_decode_partials(q, q, q, 0)
    with pytest.raises(ValueError):
        tfd.flash_decode_partials_int8(q, q, q, 0, q, q)


# ---------------------------------------------------------------------------
# TreeEngine
# ---------------------------------------------------------------------------

ENGINE_CASES = {"plain": {}, "kv_quant": dict(kv_quant=True),
                "weight_quant": dict(weight_quant=True), "ssl1": dict(ssl=1)}


def _engines(pj, pt, temperature, **kw):
    common = dict(prefill=PREFILL, max_cache_len=PREFILL + 64, budget=BUDGET,
                  chunk_size=CHUNK, temperature=temperature, top_p=0.9,
                  prefill_chunk=16)
    je = jtree.TreeEngine(JC, _grow_map(jplan), pj, dtype=jnp.float32,
                          donate=False, **common, **kw)
    te = ttree.TreeEngine(TC, _grow_map(tplan), pt, dtype=torch.float32,
                          device="cpu", **common, **kw)
    return je, te


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_tree_engine_near_greedy_identity(target, case):
    """Near-greedy, the port's TreeEngine takes the JAX TreeEngine's steps:
    per step the same accepted path length, emitted count, emitted tokens
    and cache length; and ``tree_decode`` emits the same tokens. The prompt
    (seed 5) has no near tie between top logits in any of the four
    configurations."""
    pj, pt = target
    je, te = _engines(pj, pt, 1e-3, **ENGINE_CASES[case])
    assert te.max_cache_len == je.max_cache_len
    ids = _ids(PREFILL, 5, lo=3)
    sj = je.prefill_target(je.init_state(jax.random.PRNGKey(7)),
                           jnp.asarray(ids))
    st = te.prefill_target(te.init_state(7), torch.from_numpy(ids))
    assert int(st.next_token[0]) == int(sj.next_token[0])
    assert tuple(st.rkv.k.shape) == sj.rkv.k.shape
    for _ in range(4):
        sj, aj = je.step(sj)
        st, at = te.step(st)
        assert (at.n_nodes, at.n_emitted) == (int(aj.n_nodes),
                                              int(aj.n_emitted))
        assert at.terminal == bool(aj.terminal) and at.eos == bool(aj.eos)
        assert at.tokens.tolist() == _np(aj.tokens).tolist()
        assert int(st.kv.seq_len) == int(sj.kv.seq_len)
        assert int(st.next_token[0]) == int(sj.next_token[0])
        assert at.readbacks == 1      # the step's counts, read once
        if at.terminal:
            break
    rj = jtree.tree_decode(je, jnp.asarray(ids), max_len=20, seed=1)
    rt = ttree.tree_decode(te, torch.from_numpy(ids), max_len=20, seed=1,
                           device="cpu")
    assert rt.tokens == rj.tokens
    assert rt.steps == rj.steps
    assert rt.avg_tokens_per_step == rj.avg_tokens_per_step


def test_tree_step_commits_path_and_compacts(target):
    """After a sampled step ``kv.seq_len = seq0 + n_nodes``, the emitted
    count follows the terminal flag, and the compacted slots hold the
    verify's KV of the accepted nodes bit for bit."""
    _, pt = target
    te = ttree.TreeEngine(TC, _grow_map(tplan), pt, prefill=PREFILL,
                          max_cache_len=PREFILL + 64, budget=BUDGET,
                          chunk_size=CHUNK, temperature=0.8, top_p=0.9,
                          dtype=torch.float32, prefill_chunk=16, device="cpu")
    st = te.prefill_target(te.init_state(5),
                           torch.from_numpy(_ids(PREFILL, 2, lo=3)))
    seq0 = int(st.kv.seq_len)
    assert seq0 == PREFILL
    twin = st.clone()
    new, stats = te.step(st)
    assert 1 <= stats.n_nodes <= te.max_path
    assert int(new.kv.seq_len) == seq0 + stats.n_nodes
    assert stats.n_emitted == stats.n_nodes - 1 + (0 if stats.terminal else 1)
    toks = stats.tokens[:stats.n_emitted]
    assert ((0 <= toks) & (toks < TC.vocab_size)).all()
    # redo the twin's grow and verify by hand: slot seq0 + j of the stepped
    # cache must hold the verify's KV of the j-th accepted node
    vt, _ = ttree._grow(te, twin)
    _, kv_v, _ = tl.forward_append(
        TC, te.params, vt[None], twin.kv,
        positions=twin.kv.seq_len + te._depth, tree_mask=te._mask)
    path = [0]
    for tok in stats.tokens[:stats.n_nodes - 1].tolist():
        kids = [int(c) for c in te.gm.successors[path[-1]] if c >= 0]
        path.append(next(c for c in kids if int(vt[c]) == tok))
    got = new.kv.k[:, :, :, seq0:seq0 + stats.n_nodes]
    want = kv_v.k[:, :, :, [seq0 + i for i in path]]
    assert torch.equal(got, want)


def test_tree_forced_acceptance(target):
    """generate_forced at alpha = 1.0 accepts every node's FIRST child, so
    each step commits a full root-to-leaf path and emits depth + 1 tokens;
    a low alpha rarely does; forced runs never stop on ``terminal``."""
    _, pt = target
    te = ttree.TreeEngine(TC, _grow_map(tplan), pt, prefill=PREFILL,
                          max_cache_len=PREFILL + 64, budget=BUDGET,
                          chunk_size=CHUNK, temperature=0.8, top_p=0.9,
                          dtype=torch.float32, prefill_chunk=16, device="cpu")
    ids = torch.from_numpy(_ids(PREFILL, 2, lo=3))
    st = te.prefill_target(te.init_state(21), ids)
    st, buf, n, counters, stop = te.generate_forced(st, 12, 1.0)
    steps, nodes = int(counters[0]), int(counters[1])
    assert steps >= 1 and not stop
    assert nodes == steps * te.max_path
    assert n - 1 == steps * te.max_path
    toks = buf[1:n]
    assert ((0 <= toks) & (toks < TC.vocab_size)).all()
    st2 = te.prefill_target(te.init_state(22), ids)
    _, _, _, c2, _ = te.generate_forced(st2, 12, 0.05)
    assert int(c2[1]) / max(int(c2[0]), 1) < te.max_path


def test_tree_accept_walk_first_token_marginal():
    """The first token a tree step emits is distributed as the target's own
    top-p conditional (multi-child rejection sampling with residual updates
    preserves the target marginal): goodness of fit over 512 seeds, the
    oracle of tests/test_lossless_stats.py on the port."""
    n = 512
    params = tl.init_params(TC, device="cpu", dtype=torch.float32, seed=0)
    pvec = tplan.modeled_acceptance_vector(0.7, 4)
    T, choice = tplan.plan_tree(pvec, 8, 4)
    te = ttree.TreeEngine(TC, tplan.build_grow_map(T, choice, 8, 4), params,
                          prefill=PREFILL, max_cache_len=PREFILL + 96,
                          budget=BUDGET, chunk_size=CHUNK, temperature=0.05,
                          top_p=0.9, dtype=torch.float32, prefill_chunk=16,
                          device="cpu")
    ids = torch.randint(0, TC.vocab_size, (1, PREFILL),
                        generator=torch.Generator().manual_seed(2))
    state = te.prefill_target(te.init_state(100), ids)
    logits, _, _ = tl.forward_append(TC, params, state.next_token[None],
                                     state.kv.clone())
    p_true = tsamp.norm_logits(logits[0, -1][None], 0.05, -1, 0.9)[0] \
        .double().numpy()
    p_true = p_true / p_true.sum()
    toks = np.empty(n, np.int64)
    for i in range(n):
        s = state.clone()
        s.gen.manual_seed(5_000 + i)
        _, stats = te.step(s)
        toks[i] = int(stats.tokens[0])
    emp = np.bincount(toks, minlength=TC.vocab_size) / n
    assert (emp[p_true == 0] == 0).all(), \
        "tree walk emitted a token outside the target's top-p support"
    order = np.argsort(-p_true)
    exp = p_true[order] * n
    k = max(int((np.cumsum(exp >= 5.0) == np.arange(1, len(exp) + 1)).sum()),
            1)
    obs = np.concatenate([emp[order][:k] * n, [emp[order][k:].sum() * n]])
    e = np.concatenate([exp[:k], [exp[k:].sum()]])
    stat = float(((obs - e) ** 2 / np.maximum(e, 1e-9)).sum())
    p = float(sstats.chi2.sf(stat, max(len(e) - 1, 1)))
    assert p > 1e-3, (f"tree first-token marginal departs from the target "
                      f"conditional: chi2 {stat:.1f}, p={p:.2e}")
