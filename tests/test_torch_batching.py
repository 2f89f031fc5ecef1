"""The row-batched layer of the port on the CPU, tiny sizes, fp32: kernel
B3's plain versions against the JAX Pallas kernel in interpret mode (run as
tests/test_flash_decode.py runs it), the batched attention dispatch, the
row-stacked caches and their write-back, the batched forwards, and the AR
continuous-batching scheduler (``triforce_tpu_torch/batching.py``) against
the JAX package. The CUDA kernels themselves are checked on the card by
chip_smoke.py and tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triforce_tpu import batching as jbatching
from triforce_tpu import cache as jcache
from triforce_tpu import config as jcfg
from triforce_tpu.models import llama as jl
from triforce_tpu.ops import attention as jatt
from triforce_tpu.ops.flash_decode import flash_decode_append_batched as j_fdab
from triforce_tpu_torch import batching as tbatching
from triforce_tpu_torch import cache as tcache
from triforce_tpu_torch import config as tcfg
from triforce_tpu_torch.models import llama as tl
from triforce_tpu_torch.ops import attention as tatt
from triforce_tpu_torch.ops import flash_decode as tfd

torch.set_num_threads(1)

ROWS, HKV, S, D, BLOCK = 4, 2, 512, 32, 128
# ragged lengths: a dead row, inside a block, a row whose new block
# outweighs its cache, the whole cache
K_LENS = [0, 300, 3, 512]
# fp32 arithmetic of the same inputs summed in another order
TOL = dict(rtol=2e-5, atol=2e-5)


def _np(x):
    return np.array(x)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _kernel_inputs(gt, tn, seed, quant, layers=None):
    """q, new block, mask and a cache [B, Hkv, S, D] (or stacked
    [B, L, Hkv, S, D]); int8 codes with positive scales when ``quant``."""
    rng = np.random.default_rng(seed)
    lead = (ROWS,) if layers is None else (ROWS, layers)
    q = rng.standard_normal((ROWS, HKV, gt, D)).astype(np.float32)
    kn = rng.standard_normal((ROWS, HKV, tn, D)).astype(np.float32)
    vn = rng.standard_normal((ROWS, HKV, tn, D)).astype(np.float32)
    mask = rng.random((ROWS, gt, tn)) < 0.7
    mask[:, :, 0] = True
    if quant:
        k = rng.integers(-127, 128, lead + (HKV, S, D)).astype(np.int8)
        v = rng.integers(-127, 128, lead + (HKV, S, D)).astype(np.int8)
        ks = (rng.random(lead + (HKV, S)) * 0.05 + 0.005).astype(np.float32)
        vs = (rng.random(lead + (HKV, S)) * 0.05 + 0.005).astype(np.float32)
    else:
        k = rng.standard_normal(lead + (HKV, S, D)).astype(np.float32)
        v = rng.standard_normal(lead + (HKV, S, D)).astype(np.float32)
        ks = vs = None
    return q, kn, vn, mask, k, v, ks, vs


# ---------------------------------------------------------------------------
# kernel B3 and B3-int8: plain versions vs the Pallas kernel, interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gt,tn", [(1, 1), (8, 4)])
@pytest.mark.parametrize("layer", [None, 1], ids=["unstacked", "layer"])
def test_batched_plain_matches_pallas_interpret(gt, tn, layer):
    """Ragged k_len with a dead row, per-row masks; with ``layer`` the JAX
    kernel reads layer 1 of the stacked caches, the port a strided view."""
    q, kn, vn, mask, k, v, _, _ = _kernel_inputs(
        gt, tn, 10 * gt + (layer or 0), False,
        layers=None if layer is None else 3)
    kl = np.array(K_LENS, np.int32)
    want = j_fdab(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kl),
                  jnp.asarray(mask), block=BLOCK, interpret=True,
                  layer=None if layer is None else jnp.asarray(layer))
    kt, vt = _t(k), _t(v)
    if layer is not None:
        kt, vt = kt[:, layer], vt[:, layer]
        assert not kt.is_contiguous()
    got = tfd.flash_decode_append_batched(_t(q), kt, vt, _t(kn), _t(vn),
                                          _t(kl), _t(mask))
    assert got.dtype == torch.float32 and got.shape == (ROWS, HKV, gt, D)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    # the dead row is the attention over its new block alone
    alone = tfd.flash_decode_append_plain(
        _t(q)[0], kt[0, :, :1], vt[0, :, :1], _t(kn)[0], _t(vn)[0], 0,
        _t(mask)[0])
    torch.testing.assert_close(got[0], alone, rtol=0, atol=0)


@pytest.mark.parametrize("gt,tn", [(1, 1), (8, 4)])
@pytest.mark.parametrize("layer", [None, 1], ids=["unstacked", "layer"])
def test_batched_int8_plain_matches_pallas_interpret(gt, tn, layer):
    """The int8 plain version at the Pallas block. Every p and integer
    code is the kernel's; the rescaled sum over blocks is ordered
    differently (fp32 tolerance) and, rarely, a p code flips by one where
    exp differs by an ulp between the frameworks: at most 0.5% of outputs,
    each by at most one code step (<= max vs), as
    tests/test_torch_kv_quant.py states for the single-row kernel."""
    q, kn, vn, mask, k, v, ks, vs = _kernel_inputs(
        gt, tn, 20 * gt + (layer or 0), True,
        layers=None if layer is None else 3)
    kl = np.array(K_LENS, np.int32)
    want = _np(j_fdab(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kn),
        jnp.asarray(vn), jnp.asarray(kl), jnp.asarray(mask), block=BLOCK,
        interpret=True, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        layer=None if layer is None else jnp.asarray(layer)))
    sel = (slice(None),) if layer is None else (slice(None), layer)
    got = tfd.flash_decode_append_batched_int8_plain(
        _t(q), _t(k)[sel], _t(v)[sel], _t(kn), _t(vn), _t(kl), _t(mask),
        _t(ks)[sel], _t(vs)[sel], group=BLOCK).numpy()
    diff = np.abs(got - want)
    over = diff > TOL["atol"] + TOL["rtol"] * np.abs(want)
    assert over.mean() <= 5e-3, over.mean()
    assert diff.max() <= vs.max()


def test_batched_wrappers_on_cpu_are_the_row_loop():
    """On CPU tensors the wrappers run the plain versions, which are the
    single-row plain versions row by row (the int8 one at the CUDA
    kernel's group), with one [GT, Tn] mask shared by all rows too."""
    q, kn, vn, mask, k, v, _, _ = _kernel_inputs(4, 4, 3, False)
    kl = _t(np.array(K_LENS, np.int32))
    got = tfd.flash_decode_append_batched(_t(q), _t(k), _t(v), _t(kn),
                                          _t(vn), kl, _t(mask)[0])
    for b in range(ROWS):
        want = tfd.flash_decode_append(_t(q)[b], _t(k)[b], _t(v)[b],
                                       _t(kn)[b], _t(vn)[b], kl[b],
                                       _t(mask)[0])
        torch.testing.assert_close(got[b], want, rtol=0, atol=0)
    q, kn, vn, mask, k, v, ks, vs = _kernel_inputs(4, 4, 4, True)
    got = tfd.flash_decode_append_batched_int8(
        _t(q), _t(k), _t(v), _t(kn), _t(vn), kl, _t(mask), _t(ks), _t(vs))
    for b in range(ROWS):
        want = tfd.flash_decode_append_int8_plain(
            _t(q)[b], _t(k)[b], _t(v)[b], _t(kn)[b], _t(vn)[b], kl[b],
            _t(mask)[b], _t(ks)[b], _t(vs)[b], group=tfd.KERNEL_GROUP)
        torch.testing.assert_close(got[b], want, rtol=0, atol=0)
    assert tfd.flash_decode_append_batched.launches == 0
    assert tfd.flash_decode_append_batched_int8.launches == 0


def test_non_cpu_rows_never_take_the_plain_path():
    """Only CPU tensors run the plain version: any other device goes to
    the kernel route, which raises for what it cannot launch."""
    q = torch.empty((2, HKV, 1, D), device="meta")
    mask = torch.ones((1, 1), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        tfd.flash_decode_append_batched(q, q, q, q, q, [0, 0], mask)
    with pytest.raises(ValueError):
        tfd.flash_decode_append_batched_int8(q, q, q, q, q, [0, 0], mask,
                                             q, q)


# ---------------------------------------------------------------------------
# the batched dispatch
# ---------------------------------------------------------------------------

def test_rows_dispatch_matches_jax_rowwise_attention():
    """``append_attention_rows`` on the CPU against the JAX package's
    per-row-length attention (``batching._rowwise_attention`` merged with
    the new-token partials), GQA, ragged lengths with a dead row."""
    rng = np.random.default_rng(5)
    hq = 2 * HKV
    q = rng.standard_normal((ROWS, hq, 1, D)).astype(np.float32)
    k = rng.standard_normal((ROWS, HKV, S, D)).astype(np.float32)
    v = rng.standard_normal((ROWS, HKV, S, D)).astype(np.float32)
    kn = rng.standard_normal((ROWS, HKV, 1, D)).astype(np.float32)
    vn = rng.standard_normal((ROWS, HKV, 1, D)).astype(np.float32)
    kl = np.array(K_LENS, np.int32)
    pc = jbatching._rowwise_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(kl),
                                      block=BLOCK)
    pn = jatt.new_block_partials(jnp.asarray(q), jnp.asarray(kn),
                                 jnp.asarray(vn), jnp.ones((1, 1), bool))
    want = jatt.finalize(jatt.merge_partials(pc, pn), jnp.float32)
    got = tatt.append_attention_rows(_t(q), _t(k), _t(v), _t(kn), _t(vn),
                                     k_len=_t(kl), block=BLOCK)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_rows_dispatch_matches_vmapped_jax_append_attention(quant):
    """T > 1, causal: each row equals the JAX ``append_attention`` at its
    own length (what a vmapped batch-1 forward computes off the TPU), an
    int8 cache dequantized block by block; and each row equals the port's
    own batch-1 dispatch bit for bit."""
    t = 4
    q, kn, vn, _, k, v, ks, vs = _kernel_inputs(2 * t, t, 6, quant)
    q = q.reshape(ROWS, 2 * HKV, t, D)
    kl = np.array(K_LENS, np.int32)
    sc = {} if not quant else dict(k_scale=_t(ks), v_scale=_t(vs))
    got = tatt.append_attention_rows(_t(q), _t(k), _t(v), _t(kn), _t(vn),
                                     k_len=_t(kl), block=BLOCK, **sc)
    for b in range(ROWS):
        jsc = {} if not quant else dict(k_scale=jnp.asarray(ks[b:b + 1]),
                                        v_scale=jnp.asarray(vs[b:b + 1]))
        want = jatt.append_attention(
            jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
            jnp.asarray(v[b:b + 1]), jnp.asarray(kn[b:b + 1]),
            jnp.asarray(vn[b:b + 1]), k_len=jnp.asarray(kl[b]),
            block=BLOCK, **jsc)
        np.testing.assert_allclose(got[b:b + 1].numpy(), _np(want), **TOL)
        tsc = {} if not quant else dict(k_scale=_t(ks)[b:b + 1],
                                        v_scale=_t(vs)[b:b + 1])
        one = tatt.append_attention_auto(
            _t(q)[b:b + 1], _t(k)[b:b + 1], _t(v)[b:b + 1], _t(kn)[b:b + 1],
            _t(vn)[b:b + 1], k_len=_t(kl)[b], block=BLOCK, **tsc)
        torch.testing.assert_close(got[b:b + 1], one, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# row-stacked caches
# ---------------------------------------------------------------------------

SPEC_KW = dict(gamma=3, budget=16, chunk_size=4, draft_start_size=4,
               draft_recent_size=12)
PREFILL = 32


def _stacked_jax_caches(rng, rows, max_len, quant):
    """Random row-stacked JAX caches [B, L, 1, Hkv, S, D] (as vmap stacks
    them) and the port's [B, L, Hkv, S, D] copies."""
    cfg = jcfg.TINY_TARGET
    L, H, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    real = SPEC_KW["budget"] + SPEC_KW["gamma"] + 1

    def planes(slots):
        shape = (rows, L, 1, H, slots, Dh)
        if quant:
            return dict(
                k=rng.integers(-127, 128, shape).astype(np.int8),
                v=rng.integers(-127, 128, shape).astype(np.int8),
                k_scale=rng.random(shape[:-1]).astype(np.float32),
                v_scale=rng.random(shape[:-1]).astype(np.float32))
        return dict(k=rng.standard_normal(shape).astype(np.float32),
                    v=rng.standard_normal(shape).astype(np.float32))

    kvp, rp = planes(max_len), planes(real)
    lens = np.array([PREFILL + 3 * r for r in range(rows)], np.int32)
    jkv = jcache.KVCache(seq_len=jnp.asarray(lens),
                         **{n: jnp.asarray(a) for n, a in kvp.items()})
    jr = jcache.RetrievalCache(**{n: jnp.asarray(a) for n, a in rp.items()})
    tkv = tcache.KVCache(seq_len=_t(lens),
                         **{n: _t(a[:, :, 0]).clone() for n, a in kvp.items()})
    tr = tcache.RetrievalCache(**{n: _t(a[:, :, 0]).clone()
                                  for n, a in rp.items()})
    return jkv, jr, tkv, tr


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_batched_commit_and_refresh_matches_jax_across_budget_wrap(quant):
    """Sixteen write-backs with a different accepted count per row and step
    (past the budget-16 rolling window's wrap several times): the full
    caches and the retrieval caches, codes and scales alike, equal the JAX
    function's bit for bit."""
    rng = np.random.default_rng(7)
    rows, t_new, max_len = 3, SPEC_KW["gamma"] + 2, PREFILL + 96
    cfg = jcfg.TINY_TARGET
    jspec, tspec = jcfg.SpecConfig(**SPEC_KW), tcfg.SpecConfig(**SPEC_KW)
    jkv, jr, tkv, tr = _stacked_jax_caches(rng, rows, max_len, quant)
    for step in range(16):
        nk = rng.standard_normal((rows, cfg.num_layers, 1, cfg.num_kv_heads,
                                  t_new, cfg.head_dim)).astype(np.float32)
        nv = rng.standard_normal(nk.shape).astype(np.float32)
        old = _np(jkv.seq_len)
        n_new = rng.integers(1, t_new + 1, rows).astype(np.int32)
        new_len = old + n_new
        jkv, jr = jcache.batched_commit_and_refresh(
            jkv.replace(seq_len=jnp.asarray(new_len)), jr, jnp.asarray(nk),
            jnp.asarray(nv), jnp.asarray(old), jspec, PREFILL)
        tkv = tcache.KVCache(tkv.k, tkv.v, _t(new_len), tkv.k_scale,
                             tkv.v_scale)
        tkv, tr = tcache.batched_commit_and_refresh(
            tkv, tr, _t(nk[:, :, 0]), _t(nv[:, :, 0]), _t(old), tspec,
            PREFILL)
        names = ("k", "v", "k_scale", "v_scale") if quant else ("k", "v")
        for name in names:
            for jc, tc in ((jkv, tkv), (jr, tr)):
                np.testing.assert_array_equal(
                    getattr(tc, name).numpy(),
                    _np(getattr(jc, name))[:, :, 0],
                    err_msg=f"{name} step {step}")
    assert int(tkv.seq_len.max()) > PREFILL + 2 * SPEC_KW["budget"]


def test_streaming_evict_for_spec_rows_matches_jax():
    rng = np.random.default_rng(8)
    jspec, tspec = jcfg.SpecConfig(**SPEC_KW), tcfg.SpecConfig(**SPEC_KW)
    cfg = jcfg.TINY_DRAFT
    real = 4 + 12 + SPEC_KW["gamma"] + 3
    shape = (3, cfg.num_layers, 1, cfg.num_kv_heads, real, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    count = np.array([0, 2, 5], np.int32)
    want = jax.vmap(lambda c, n: jcache.streaming_evict_for_spec(c, jspec, n))(
        jcache.StreamingCache(k=jnp.asarray(k), v=jnp.asarray(v),
                              seq_len=jnp.zeros((3,), jnp.int32)),
        jnp.asarray(count))
    got = tcache.streaming_evict_for_spec_rows(
        tcache.StreamingCache(_t(k[:, :, 0]).clone(), _t(v[:, :, 0]).clone(),
                              torch.zeros(3, dtype=torch.int32)),
        tspec, _t(count))
    np.testing.assert_array_equal(got.k.numpy(), _np(want.k)[:, :, 0])
    np.testing.assert_array_equal(got.v.numpy(), _np(want.v)[:, :, 0])


def test_write_row_row_view_and_stack_rows_round_trip():
    """``write_row`` fills one row of a blank pool in place (codes, scales
    and length), ``row_view`` shares the pool's buffers, ``stack_rows``
    copies."""
    cfg, spec = tcfg.TINY_TARGET, tcfg.SpecConfig(**SPEC_KW)
    pool = tcache.init_kv_rows(cfg, 24, 3, torch.float32, device="cpu",
                               quant=True)
    assert pool.k.shape == (3, cfg.num_layers, cfg.num_kv_heads, 24,
                            cfg.head_dim)
    assert pool.k_scale.shape == pool.k.shape[:4]
    assert pool.seq_len.tolist() == [0, 0, 0]
    row = tcache.init_kv(cfg, 24, device="cpu", quant=True)
    row.k.fill_(7)
    row.v_scale.fill_(0.5)
    row = tcache.KVCache(row.k, row.v, torch.tensor(9, dtype=torch.int32),
                         row.k_scale, row.v_scale)
    ptr = pool.k.data_ptr()
    pool = tcache.write_row(pool, 1, row)
    assert pool.k.data_ptr() == ptr                 # in place
    assert pool.seq_len.tolist() == [0, 9, 0]
    assert (pool.k[1] == 7).all() and (pool.k[0] == 0).all()
    view = tcache.row_view(pool, 1)
    assert view.k.shape == row.k.shape and int(view.seq_len) == 9
    view.k[0, 0, 0, 0, 0] = 3                       # writes through
    assert pool.k[1, 0, 0, 0, 0] == 3
    stacked = tcache.stack_rows([row, row])
    assert stacked.k.shape == (2,) + pool.k.shape[1:]
    assert stacked.seq_len.tolist() == [9, 9]
    r = tcache.init_retrieval_rows(cfg, spec, 2, torch.float32, device="cpu")
    d = tcache.init_streaming_rows(tcfg.TINY_DRAFT, spec, 2, torch.float32,
                                   device="cpu")
    assert r.real_budget == 16 + 3 + 1 and not r.quantized
    assert d.real_budget == 4 + 12 + 3 + 3 and d.seq_len.shape == (2,)


# ---------------------------------------------------------------------------
# batched forwards
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def target():
    pj = jl.init_params(jax.random.PRNGKey(0), jcfg.TINY_TARGET,
                        dtype=jnp.float32)
    pt = tl.params_from_numpy(jax.tree.map(np.asarray, pj), tcfg.TINY_TARGET,
                              "cpu")
    return pj, pt


def _prefilled_rows(pt, lens, max_len, seed):
    """A pool whose row b holds ``lens[b]`` prefilled tokens, and the
    batch-1 caches it was written from."""
    cfg = tcfg.TINY_TARGET
    rng = np.random.default_rng(seed)
    pool = tcache.init_kv_rows(cfg, max_len, len(lens), torch.float32,
                               device="cpu")
    singles = []
    for b, n in enumerate(lens):
        kv = tcache.init_kv(cfg, max_len, dtype=torch.float32, device="cpu")
        if n:
            ids = _t(rng.integers(0, cfg.vocab_size, (1, n)))
            _, kv, _ = tl.forward_append(cfg, pt, ids, kv)
        pool = tcache.write_row(pool, b, kv)
        singles.append(kv)
    return pool, singles


def test_forward_append_rows_matches_jax_rows_and_batch1(target):
    """Row b of the batched forward equals the JAX forward_append of that
    row alone (fp32 tolerance) and the port's batch-1 forward (logits and
    the new K/V it would commit, bit for bit), at ragged lengths."""
    pj, pt = target
    jc, tc = jcfg.TINY_TARGET, tcfg.TINY_TARGET
    lens, t, max_len = [5, 0, 17], 4, 32
    pool, singles = _prefilled_rows(pt, lens, max_len, 11)
    ids = np.random.default_rng(12).integers(0, tc.vocab_size, (3, t))
    logits, nk, nv = tl.forward_append_rows(tc, pt, _t(ids), pool)
    assert logits.shape == (3, t, tc.vocab_size)
    assert nk.shape == (3, tc.num_layers, tc.num_kv_heads, t, tc.head_dim)
    for b, n in enumerate(lens):
        one, kv1, _ = tl.forward_append(tc, pt, _t(ids[b:b + 1]),
                                        singles[b].clone())
        torch.testing.assert_close(logits[b:b + 1], one, rtol=0, atol=0)
        torch.testing.assert_close(nk[b], kv1.k[:, 0, :, n:n + t], rtol=0,
                                   atol=0)
        jkv = jcache.KVCache(k=jnp.asarray(singles[b].k.numpy()),
                             v=jnp.asarray(singles[b].v.numpy()),
                             seq_len=jnp.asarray(n, jnp.int32))
        want, _, _ = jl.forward_append(jc, pj, jnp.asarray(ids[b:b + 1]),
                                       jkv)
        np.testing.assert_allclose(logits[b:b + 1].numpy(), _np(want),
                                   rtol=2e-4, atol=2e-4)


def test_forward_spec_rows_dead_row_reads_no_cache(target):
    """``kv_seq_len[b] == 0`` collapses row b's retrieval read to zero
    columns: poisoning that row's cache does not move its logits, while a
    live row equals the batch-1 ``forward_spec``."""
    _, pt = target
    cfg, spec = tcfg.TINY_TARGET, tcfg.SpecConfig(**SPEC_KW)
    rng = np.random.default_rng(13)
    rkv = tcache.init_retrieval_rows(cfg, spec, 2, torch.float32,
                                     device="cpu")
    rkv.k.copy_(_t(rng.standard_normal(rkv.k.shape).astype(np.float32)))
    rkv.v.copy_(_t(rng.standard_normal(rkv.v.shape).astype(np.float32)))
    ids = _t(rng.integers(0, cfg.vocab_size, (2, spec.gamma + 1)))
    lens = torch.tensor([40, 0], dtype=torch.int32)
    clean = tl.forward_spec_rows(cfg, pt, ids, rkv, lens, spec.budget)
    live, _ = tl.forward_spec(cfg, pt, ids[:1], tcache.row_view(rkv, 0),
                              lens[0], spec.budget, commit=False)
    torch.testing.assert_close(clean[:1], live, rtol=0, atol=0)
    rkv.k[1] = 1e4
    rkv.v[1] = 1e4
    dirty = tl.forward_spec_rows(cfg, pt, ids, rkv, lens, spec.budget)
    torch.testing.assert_close(clean, dirty, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# batched AR and the AR scheduler, near-greedy, against JAX
# ---------------------------------------------------------------------------

GREEDY = dict(SPEC_KW, temperature=1e-4, top_p=0.9)


def _prompts(n, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 199, (PREFILL,)) for _ in range(n)]


def test_batched_ar_step_tokens_match_jax(target):
    """Three rows at ragged lengths (one of them dead) decode 6 tokens:
    tokens, lengths, output buffers and the committed KV match."""
    pj, pt = target
    jc, tc = jcfg.TINY_TARGET, tcfg.TINY_TARGET
    jspec, tspec = jcfg.SpecConfig(**GREEDY), tcfg.SpecConfig(**GREEDY)
    lens, max_len = [9, 14, 20], 40
    pool, _ = _prefilled_rows(pt, lens, max_len, 21)
    toks0 = np.array([5, 17, 101])
    live = np.array([True, False, True])
    ts = tbatching.init_batch(tc, 3, max_len, seed=0, dtype=torch.float32,
                              out_cap=4, device="cpu")
    ts.kv.k.copy_(pool.k)
    ts.kv.v.copy_(pool.v)
    ts = tbatching.BatchState(
        kv=tcache.KVCache(ts.kv.k, ts.kv.v, pool.seq_len), tokens=_t(toks0),
        live=_t(live), out_buf=ts.out_buf, n_out=ts.n_out, gen=ts.gen)
    js = jbatching.init_batch(jc, 3, max_len, jax.random.PRNGKey(0),
                              jnp.float32, out_cap=4)
    js = js.replace(k=jnp.asarray(pool.k.numpy()),
                    v=jnp.asarray(pool.v.numpy()),
                    seq_lens=jnp.asarray(lens, jnp.int32),
                    tokens=jnp.asarray(toks0, jnp.int32),
                    live=jnp.asarray(live))
    step = jax.jit(lambda s: jbatching.batched_ar_step(jc, jspec, pj, s))
    for _ in range(6):
        js = step(js)
        ts = tbatching.batched_ar_step(tc, tspec, pt, ts)
        assert ts.tokens.tolist() == _np(js.tokens).tolist()
    assert ts.seq_lens.tolist() == _np(js.seq_lens).tolist() == [15, 14, 26]
    # the buffer holds 4 tokens: recording and counting stop at capacity
    assert ts.n_out.tolist() == _np(js.n_out).tolist() == [4, 0, 4]
    np.testing.assert_array_equal(ts.out_buf.numpy(), _np(js.out_buf))
    np.testing.assert_allclose(ts.kv.k.numpy(), _np(js.k), **TOL)


def test_ar_scheduler_outputs_match_jax(target):
    """6 requests through 4 slots, one of them retiring on EOS: every
    request's ``out`` is identical in the two packages."""
    pj, pt = target
    jspec, tspec = jcfg.SpecConfig(**GREEDY), tcfg.SpecConfig(**GREEDY)
    prompts, max_new = _prompts(6), 10

    def serve(sched, req_cls):
        for i, p in enumerate(prompts):
            sched.submit(req_cls(rid=i, prompt=p, max_new_tokens=max_new))
        done = sched.run(max_wall_s=600)
        assert len(done) == 6 and all(r.done for r in done)
        return {r.rid: r.out for r in done}

    kw = dict(batch=4, max_len=PREFILL + 32, segment=4)
    probe = serve(jbatching.Scheduler(jcfg.TINY_TARGET, jspec, pj,
                                      dtype=jnp.float32, **kw),
                  jbatching.Request)
    assert all(len(o) == max_new for o in probe.values())
    eos = probe[2][4]                     # request 2 now stops mid-stream
    jout = serve(jbatching.Scheduler(jcfg.TINY_TARGET, jspec, pj,
                                     dtype=jnp.float32, eos_token_id=eos,
                                     **kw), jbatching.Request)
    tsched = tbatching.Scheduler(tcfg.TINY_TARGET, tspec, pt,
                                 dtype=torch.float32, eos_token_id=eos,
                                 prefill_chunk=16, device="cpu", **kw)
    tout = serve(tsched, tbatching.Request)
    assert tout == jout
    assert tout[2][-1] == eos and len(tout[2]) <= 5
    assert tsched.stats["prefill_tokens"] == 6 * PREFILL
    assert not tsched.state.live.any()


@pytest.mark.parametrize("build", [
    lambda pt: tbatching.init_batch(tcfg.TINY_TARGET, 2, 8),
    lambda pt: tbatching.Scheduler(tcfg.TINY_TARGET,
                                   tcfg.SpecConfig(**SPEC_KW), pt),
    lambda pt: tcache.init_kv_rows(tcfg.TINY_TARGET, 8, 2),
    lambda pt: tcache.init_retrieval_rows(tcfg.TINY_TARGET,
                                          tcfg.SpecConfig(**SPEC_KW), 2),
    lambda pt: tcache.init_streaming_rows(tcfg.TINY_DRAFT,
                                          tcfg.SpecConfig(**SPEC_KW), 2),
], ids=["init_batch", "Scheduler", "init_kv_rows", "init_retrieval_rows",
        "init_streaming_rows"])
def test_entry_points_without_device_raise(target, build, monkeypatch):
    """No device given and no CUDA card: the new entry points raise
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(target[1])
