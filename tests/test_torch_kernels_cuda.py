"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a card (the kernels
have no CPU mode). This file imports only torch and the port, so it runs on
a machine without JAX:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

chip_smoke.py holds the same kernels against the same plain versions at the
main path's full shapes. The row-batched kernels (B3, B3-int8) are also held
against the single-row ones row by row, bit for bit, and the partials
kernels (B4, B4-int8) merged with a new block against B1 (B4-int8 at a
rank's shard shapes against the same merge of its plain partials, with
B1-int8 against its plain version beside it).
"""

import dataclasses
import random

import pytest
import torch

from triforce_tpu_torch import cache as tcache
from triforce_tpu_torch.models import llama as tl
from triforce_tpu_torch.ops import attention as tatt
from triforce_tpu_torch.ops import flash_decode as tfd
from triforce_tpu_torch.ops import retrieval_kernel as trk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(dev, seed, *shape):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)


# B1's shapes: the decode path (GT <= 16) at its edges (a k_len that is not
# a whole number of 64-key tiles, one shorter than a tile, GT = 16, a GQA
# decode row at D = 64: tinyllama-1.1b-128k's 4 KV heads, G = 8), the wide
# path from GT = 17 on
B1_CASES = [(1, 1, 1000, 1100, 128), (7, 7, 4096, 4103, 128),
            (8, 8, 0, 64, 128), (200, 200, 777, 1000, 128),
            (16, 4, 333, 400, 64), (1, 1, 4133, 4200, 128),
            (1, 1, 37, 64, 128), (16, 16, 1000, 1100, 128),
            (17, 17, 1000, 1100, 128), (8, 1, 32768, 32800, 64)]


@pytest.mark.parametrize("gt,tn,k_len,s,d", B1_CASES)
def test_flash_decode_matches_plain(dev, gt, tn, k_len, s, d):
    q, kn, vn = (_randn(dev, 0, 4, gt, d), _randn(dev, 1, 4, tn, d),
                 _randn(dev, 2, 4, tn, d))
    k, v = _randn(dev, 3, 4, s, d), _randn(dev, 4, 4, s, d)
    k[:, k_len:] = 50.0      # stale slots past k_len must never be read
    mask = tfd.causal_mask(gt, tn, 1, dev) if gt == tn else \
        torch.ones((gt, tn), dtype=torch.bool, device=dev)
    kl = torch.tensor(k_len, dtype=torch.int32, device=dev)
    before = tfd.flash_decode_append.launches
    out = tfd.flash_decode_append(q, k, v, kn, vn, kl, mask)
    ref = tfd.flash_decode_append_plain(q, k, v, kn, vn, kl, mask)
    torch.cuda.synchronize()
    assert tfd.flash_decode_append.launches == before + 1
    # bf16 p rounded against split-local maxima: the error shrinks as
    # 1/sqrt(keys); chip_smoke.py states the same bound
    tol = 0.05 / (k_len + tn) ** 0.5
    assert (out - ref).abs().max().item() <= tol


def _mask(dev, kind, gt, tn, seed=5):
    """[GT, Tn] bool: "causal" (row r attends token j <= r % Tn), "random"
    (60%, token 0 always) or "ancestor" (a random tree of Tn nodes: a
    node attends itself and its ancestors; with GT = G * Tn, each of the G
    groups of rows in turn)."""
    if kind == "causal":
        return tfd.causal_mask(tn, tn, gt // tn, dev)
    if kind == "random":
        g = torch.Generator(device=dev).manual_seed(seed)
        m = torch.rand((gt, tn), generator=g, device=dev) < 0.6
        m[:, 0] = True
        return m
    rng = random.Random(seed)
    parent = [-1] + [rng.randrange(i) for i in range(1, tn)]
    m = torch.zeros((tn, tn), dtype=torch.bool)
    for i in range(tn):
        j = i
        while j >= 0:
            m[i, j] = True
            j = parent[j]
    return m.repeat(gt // tn, 1).to(dev)     # each group's rows, in turn


# the wide path (GT > 16) at its edges: the first wide GT with a k_len
# that is not a whole number of tiles, one warpgroup's 64 rows with a
# k_len shorter than a tile, the first two-warpgroup GT, the tree verify's
# 128 rows under an ancestor mask, an empty prefix, a GQA prefill tile at
# D = 64 (tinyllama-1.1b-128k: 4 KV heads, G 8 x T 512), and one warpgroup
# at D = 64 (GT 17, 40 and 64; an empty prefix at 40), whose q' fragments
# phase 1 keeps in registers
WIDE_CASES = [
    # hkv, gt, tn, k_len, s, d, mask
    (4, 17, 17, 4133, 4200, 128, "causal"),
    (4, 64, 64, 37, 100, 128, "random"),
    (4, 65, 65, 1000, 1100, 128, "causal"),
    (4, 128, 128, 4096, 4300, 128, "ancestor"),
    (4, 40, 8, 0, 64, 128, "random"),
    (4, 4096, 512, 16384, 16896, 64, "causal"),
    (4, 17, 17, 4133, 4200, 64, "causal"),
    (4, 40, 40, 1000, 1100, 64, "random"),
    (4, 64, 64, 4096, 4300, 64, "ancestor"),
    (4, 40, 8, 0, 64, 64, "random"),
    # tinyllama-1.1b-128k's run (Hkv 4, D 64, G 8): the target verify
    # (GT 64, Tn 8) over its 32K prefix, the middle verify (GT 56, Tn 7)
    # over the 4096-token retrieval cache, the tree verify (GT 1024, Tn 128)
    # under an ancestor mask
    (4, 64, 8, 32768, 32912, 64, "causal"),
    (4, 56, 7, 4096, 4103, 64, "causal"),
    (4, 1024, 128, 32768, 33200, 64, "ancestor"),
]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("hkv,gt,tn,k_len,s,d,mask", WIDE_CASES)
def test_flash_decode_wide_matches_plain(dev, hkv, gt, tn, k_len, s, d, mask,
                                         quant):
    """B1 and B1-int8 on the wide path against their plain versions, with
    the cache past k_len poisoned (never read)."""
    q, kn, vn = (_randn(dev, 0, hkv, gt, d), _randn(dev, 1, hkv, tn, d),
                 _randn(dev, 2, hkv, tn, d))
    kb, vb = _randn(dev, 3, hkv, s, d), _randn(dev, 4, hkv, s, d)
    m = _mask(dev, mask, gt, tn)
    kl = torch.tensor(k_len, dtype=torch.int32, device=dev)
    if quant:
        (k, ks), (v, vs) = tcache.quantize_tokens(kb), tcache.quantize_tokens(vb)
        k[:, k_len:], v[:, k_len:] = 127, -127
        ks[:, k_len:], vs[:, k_len:] = 1e3, 1e3
        fn = tfd.flash_decode_append_int8
        before = fn.launches
        out = fn(q, k, v, kn, vn, kl, m, ks, vs)
        ref = tfd.flash_decode_append_int8_plain(q, k, v, kn, vn, kl, m, ks,
                                                 vs, group=tfd.KERNEL_GROUP)
        tol = 0.005
    else:
        kb[:, k_len:], vb[:, k_len:] = 50.0, 50.0
        fn = tfd.flash_decode_append
        before = fn.launches
        out = fn(q, kb, vb, kn, vn, kl, m)
        ref = tfd.flash_decode_append_plain(q, kb, vb, kn, vn, kl, m)
        tol = 0.05
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.isfinite(out).all()
    # chip_smoke.py states the same bounds
    assert (out - ref).abs().max().item() <= tol / (k_len + tn) ** 0.5


def test_flash_decode_rejects_fp32_on_cuda(dev):
    """A CUDA tensor the kernel does not take raises; it never falls back to
    the plain version."""
    q = torch.zeros((2, 1, 128), device=dev)
    mask = torch.ones((1, 1), dtype=torch.bool, device=dev)
    with pytest.raises(TypeError):
        tfd.flash_decode_append(q, q, q, q, q, 0, mask)


# B2's shapes (g, chunk, prefill, d): the first ones, then the wrappers'
# envelope at its edges: chunk 1 and 256, a chunk that is no power of two,
# a prefill of one chunk, G 3, 5, 7 and 8, D 64
B2_CASES = [(1, 8, 2048, 128), (2, 4, 1000, 128), (4, 16, 512, 128),
            (8, 1, 300, 64), (3, 256, 2560, 128), (8, 256, 256, 64),
            (5, 8, 8, 128), (7, 12, 2004, 64), (8, 8, 2048, 64)]


@pytest.mark.parametrize("g,chunk,prefill,d", B2_CASES)
def test_chunk_scores_matches_plain(dev, g, chunk, prefill, d):
    q = _randn(dev, 5, 4, g, d)
    k = _randn(dev, 6, 4, 3000, d)
    k[:, prefill:] = 50.0    # past the live prefill: never read
    before = trk.chunk_scores.launches
    out = trk.chunk_scores(q, k, chunk=chunk, prefill=prefill)
    ref = trk.chunk_scores_plain(q, k, chunk=chunk, prefill=prefill)
    torch.cuda.synchronize()
    assert trk.chunk_scores.launches == before + 1
    # the same fp32 products summed in another order
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("quant", [False, True])
def test_chunk_scores_gqa_widths(dev, quant):
    """B2 and B2-int8 at tinyllama-1.1b-128k's retrieval build: 4 KV heads
    x 64, 8 query rows a head, a 32K prefill in chunks of 8."""
    q = _randn(dev, 5, 4, 8, 64)
    kb = _randn(dev, 6, 4, 32912, 64)
    prefill = 32768
    if quant:
        k, ks = tcache.quantize_tokens(kb)
        k[:, prefill:], ks[:, prefill:] = 127, 1e3    # never read
        fn = trk.chunk_scores_int8
        before = fn.launches
        out = fn(q, k, ks, chunk=8, prefill=prefill)
        ref = trk.chunk_scores_int8_plain(q, k, ks, chunk=8, prefill=prefill)
        tol = 1e-6
    else:
        kb[:, prefill:] = 50.0
        fn = trk.chunk_scores
        before = fn.launches
        out = fn(q, kb, chunk=8, prefill=prefill)
        ref = trk.chunk_scores_plain(q, kb, chunk=8, prefill=prefill)
        tol = 1e-5
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    # chip_smoke.py's bounds, of the score scale
    assert (out - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.parametrize("quant", [False, True])
def test_chunk_scores_q_off_16_bytes(dev, quant):
    """q a contiguous bf16 view one element into its storage (not 16-byte
    aligned): the bf16 kernel reads q in 16-byte loads, so the wrapper
    hands it an aligned copy; the int8 kernel widens q element by element.
    Both give the plain version's scores."""
    hkv, g, d, prefill = 4, 8, 64, 2048
    q = _randn(dev, 5, 1 + hkv * g * d)[1:].view(hkv, g, d)
    assert q.is_contiguous() and q.data_ptr() % 16
    kb = _randn(dev, 6, hkv, 2100, d)
    if quant:
        k, ks = tcache.quantize_tokens(kb)
        out = trk.chunk_scores_int8(q, k, ks, chunk=8, prefill=prefill)
        ref = trk.chunk_scores_int8_plain(q, k, ks, chunk=8, prefill=prefill)
        tol = 1e-6
    else:
        out = trk.chunk_scores(q, kb, chunk=8, prefill=prefill)
        ref = trk.chunk_scores_plain(q, kb, chunk=8, prefill=prefill)
        tol = 1e-5
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= tol * ref.abs().max().item()


# ---------------------------------------------------------------------------
# int8 KV: B1-int8 and B2-int8
# ---------------------------------------------------------------------------

def _int8_cache(dev, seed, *shape):
    """int8 codes and fp32 scales of a random bf16 cache, as the model
    commits them."""
    return tcache.quantize_tokens(_randn(dev, seed, *shape))


@pytest.mark.parametrize("gt,tn,k_len,s,d", B1_CASES)
def test_flash_decode_int8_matches_plain(dev, gt, tn, k_len, s, d):
    """The int8 kernel against its plain version at the kernel's group,
    with codes and scales past k_len poisoned (never read) and k_len = 0
    (the new block alone)."""
    q, kn, vn = (_randn(dev, 0, 4, gt, d), _randn(dev, 1, 4, tn, d),
                 _randn(dev, 2, 4, tn, d))
    k, ks = _int8_cache(dev, 3, 4, s, d)
    v, vs = _int8_cache(dev, 4, 4, s, d)
    k[:, k_len:], v[:, k_len:] = 127, -127
    ks[:, k_len:], vs[:, k_len:] = 1e3, 1e3
    mask = tfd.causal_mask(gt, tn, 1, dev) if gt == tn else \
        torch.ones((gt, tn), dtype=torch.bool, device=dev)
    kl = torch.tensor(k_len, dtype=torch.int32, device=dev)
    before = tfd.flash_decode_append_int8.launches
    out = tfd.flash_decode_append_int8(q, k, v, kn, vn, kl, mask, ks, vs)
    ref = tfd.flash_decode_append_int8_plain(q, k, v, kn, vn, kl, mask, ks,
                                             vs, group=tfd.KERNEL_GROUP)
    torch.cuda.synchronize()
    assert tfd.flash_decode_append_int8.launches == before + 1
    assert torch.isfinite(out).all()
    # the same integer codes up to rare one-step flips of p; chip_smoke.py
    # states the same bound
    assert (out - ref).abs().max().item() <= 0.005 / (k_len + tn) ** 0.5


def test_flash_decode_rejects_a_bf16_int8_mix(dev):
    """Each kernel raises on the other's cache type, and the int8 kernel
    on scales that are not fp32 [Hkv, S]; none falls back."""
    q = _randn(dev, 0, 2, 1, 128)
    kb = _randn(dev, 1, 2, 64, 128)
    k8, ks = _int8_cache(dev, 2, 2, 64, 128)
    mask = torch.ones((1, 1), dtype=torch.bool, device=dev)
    with pytest.raises(TypeError):
        tfd.flash_decode_append(q, k8, k8, q, q, 8, mask)
    with pytest.raises(TypeError):
        tfd.flash_decode_append_int8(q, kb, kb, q, q, 8, mask, ks, ks)
    with pytest.raises(ValueError):
        tfd.flash_decode_append_int8(q, k8, k8, q, q, 8, mask, ks.half(),
                                     ks.half())
    with pytest.raises(TypeError):
        trk.chunk_scores(q, k8, chunk=8, prefill=64)
    with pytest.raises(TypeError):
        trk.chunk_scores_int8(q, kb, ks, chunk=8, prefill=64)


@pytest.mark.parametrize("g,chunk,prefill,d", B2_CASES)
def test_chunk_scores_int8_matches_plain(dev, g, chunk, prefill, d):
    q = _randn(dev, 5, 4, g, d)
    k, ks = _int8_cache(dev, 6, 4, 3000, d)
    k[:, prefill:], ks[:, prefill:] = 127, 1e3    # never read
    before = trk.chunk_scores_int8.launches
    out = trk.chunk_scores_int8(q, k, ks, chunk=chunk, prefill=prefill)
    ref = trk.chunk_scores_int8_plain(q, k, ks, chunk=chunk,
                                      prefill=prefill)
    torch.cuda.synchronize()
    assert trk.chunk_scores_int8.launches == before + 1
    # exact integer dots: only the scale products and the means round
    assert (out - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()


@pytest.mark.parametrize("chunk", [8, 12, 256])
@pytest.mark.parametrize("quant", [False, True])
def test_chunk_scores_any_plan_same_bits(dev, quant, chunk):
    """B2 and B2-int8 through their C entry points under plans other than
    the wrapper's: one block a head walking all 6144 keys (the kernel's
    ring of key scores wraps six times), one chunk a block, and 7 blocks a
    head; on a layer whose key rows are padded (token stride D + 16) and,
    in int8, whose scale plane has an odd head stride. A key's score and
    a chunk's sum do not depend on the block, so every plan gives the
    wrapper's bits, and those match the plain version. In int8 the
    entry point gets q in fp32 where the wrapper passed it in bf16: the
    kernel widens the same values. A plan that leaves a chunk out, or a
    block empty, is refused."""
    hkv, g, d, prefill = 4, 8, 64, 6144
    n = prefill // chunk
    buf = _randn(dev, 7, hkv, 6200, d + 16)
    q = _randn(dev, 8, hkv, g, d)
    lib = trk._build.lib(trk._SOURCE)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if quant:
        codes, scales = tcache.quantize_tokens(buf)
        k = codes[..., :d]
        plane = torch.zeros((hkv, 6201), device=dev)
        plane[:, :6200] = scales
        ks = plane[:, :6200]
        qx = q.float().contiguous()
        got = trk.chunk_scores_int8(q, k, ks, chunk=chunk, prefill=prefill)
        ref = trk.chunk_scores_int8_plain(q, k, ks, chunk=chunk,
                                          prefill=prefill)
        tol = 1e-6

        def entry(cpb, bph, out):
            return lib.tf_chunk_scores_int8(
                qx.data_ptr(), 0, k.data_ptr(), k.stride(0), k.stride(1),
                ks.data_ptr(), ks.stride(0), out.data_ptr(), hkv, g, d,
                prefill, chunk, cpb, bph, stream)
    else:
        k = buf[..., :d]
        qx = q.contiguous()
        got = trk.chunk_scores(q, k, chunk=chunk, prefill=prefill)
        ref = trk.chunk_scores_plain(q, k, chunk=chunk, prefill=prefill)
        tol = 1e-5

        def entry(cpb, bph, out):
            return lib.tf_chunk_scores_bf16(
                qx.data_ptr(), k.data_ptr(), k.stride(0), k.stride(1),
                out.data_ptr(), hkv, g, d, prefill, chunk, cpb, bph, stream)
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()
    seven = -(-n // 7)
    for cpb, bph in ((n, 1), (1, n), (seven, -(-n // seven))):
        out = torch.full_like(got, float("nan"))
        assert entry(cpb, bph, out) == 0
        torch.cuda.synchronize()
        assert torch.equal(out, got), (cpb, bph)
    out = torch.empty_like(got)
    assert entry(1, n - 1, out) != 0      # the last chunk left out
    assert entry(1, n + 1, out) != 0      # an empty block


# ---------------------------------------------------------------------------
# row-batched: B3 and B3-int8
# ---------------------------------------------------------------------------

B3_CASES = [
    # gt, tn, k_lens (ragged: a dead row, a row lighter than its new
    # block, a full row), s, d, per-row masks
    (1, 1, [1000, 0, 1, 1100], 1100, 128, False),
    (7, 7, [4096, 0, 3, 2500], 4103, 128, False),
    (8, 8, [0, 0, 0, 0], 64, 128, True),
    (40, 8, [777, 0, 5, 1000], 1000, 128, True),
    (16, 4, [333, 0, 2, 400], 400, 64, True),
    # the decode path's edges: GT = 16 with a row shorter than a tile and
    # one not a whole number of tiles; the GQA decode row at D = 64
    (16, 16, [1100, 0, 37, 1000], 1100, 128, False),
    (8, 1, [32768, 0, 37, 4133], 32800, 64, False),
    # the wide path's edges: GT 17, 64 and 65, the tree verify's 128 rows
    (17, 17, [4133, 0, 37, 1000], 4200, 128, False),
    (64, 64, [37, 0, 1, 1100], 1100, 128, True),
    (65, 65, [1000, 0, 3, 777], 1100, 128, False),
    (128, 128, [4096, 0, 5, 2500], 4300, 128, True),
    # tinyllama-1.1b-128k's served rows: the target verify, G 8 x Tn 8
    (64, 8, [8192, 0, 37, 4133], 8528, 64, False),
]


def _b3_inputs(dev, gt, tn, k_lens, s, d, per_row_mask, hkv=4):
    """Row-batched inputs: q [rows, Hkv, GT, D], the new block, a strided
    row-stacked cache layer, the mask and the lengths."""
    rows = len(k_lens)
    q, kn, vn = (_randn(dev, 0, rows, hkv, gt, d),
                 _randn(dev, 1, rows, hkv, tn, d),
                 _randn(dev, 2, rows, hkv, tn, d))
    # layer 1 of a row-stacked [B, L, Hkv, S, D] pool: a strided view
    k = _randn(dev, 3, rows, 2, hkv, s, d)
    v = _randn(dev, 4, rows, 2, hkv, s, d)
    if per_row_mask:
        g = torch.Generator(device=dev).manual_seed(5)
        mask = torch.rand((rows, gt, tn), generator=g, device=dev) < 0.7
        mask[:, :, 0] = True
    else:
        mask = tfd.causal_mask(tn, tn, gt // tn, dev)
    kl = torch.tensor(k_lens, dtype=torch.int32, device=dev)
    return q, kn, vn, k, v, mask, kl


@pytest.mark.parametrize("gt,tn,k_lens,s,d,per_row_mask", B3_CASES)
def test_flash_decode_batched_matches_plain_and_b1(dev, gt, tn, k_lens, s, d,
                                                   per_row_mask):
    q, kn, vn, k, v, mask, kl = _b3_inputs(dev, gt, tn, k_lens, s, d,
                                           per_row_mask)
    for b, n in enumerate(k_lens):
        k[b, 1, :, n:] = 50.0     # stale slots past k_len must never be read
        v[b, 1, :, n:] = 50.0
    k, v = k[:, 1], v[:, 1]
    before = tfd.flash_decode_append_batched.launches
    out = tfd.flash_decode_append_batched(q, k, v, kn, vn, kl, mask)
    ref = tfd.flash_decode_append_batched_plain(q, k, v, kn, vn, kl, mask)
    torch.cuda.synchronize()
    assert tfd.flash_decode_append_batched.launches == before + 1
    assert torch.isfinite(out).all()
    for b, n in enumerate(k_lens):
        # B1's bound per row; chip_smoke.py states the same one
        assert (out[b] - ref[b]).abs().max().item() <= 0.05 / (n + tn) ** 0.5
        # the same device code as B1, split the same way: bit equality
        m = mask[b] if per_row_mask else mask
        one = tfd.flash_decode_append(q[b], k[b], v[b], kn[b], vn[b], kl[b],
                                      m.contiguous())
        assert torch.equal(out[b], one)


@pytest.mark.parametrize("quant", [False, True])
def test_flash_decode_batched_over_16_heads(dev, quant):
    """B3 at a tp-2 rank of Llama2-7B: 16 KV heads, 2 rows at 8192 keys
    (one ragged), the outer verify's 8 rows: within B1's bound of the
    plain version, and row by row B1's bits."""
    k_lens = [8192, 5000]
    q, kn, vn, k, v, mask, kl = _b3_inputs(dev, 8, 8, k_lens, 8192 + 64,
                                           128, False, hkv=16)
    k, v = k[:, 1], v[:, 1]
    if quant:
        (k, ks), (v, vs) = tcache.quantize_tokens(k), \
            tcache.quantize_tokens(v)
        out = tfd.flash_decode_append_batched_int8(q, k, v, kn, vn, kl, mask,
                                                   ks, vs)
        ref = tfd.flash_decode_append_batched_int8_plain(
            q, k, v, kn, vn, kl, mask, ks, vs, group=tfd.KERNEL_GROUP)
        ones = [tfd.flash_decode_append_int8(q[b], k[b], v[b], kn[b], vn[b],
                                             kl[b], mask, ks[b], vs[b])
                for b in range(2)]
        tol = 0.005
    else:
        out = tfd.flash_decode_append_batched(q, k, v, kn, vn, kl, mask)
        ref = tfd.flash_decode_append_batched_plain(q, k, v, kn, vn, kl,
                                                    mask)
        ones = [tfd.flash_decode_append(q[b], k[b], v[b], kn[b], vn[b],
                                        kl[b], mask) for b in range(2)]
        tol = 0.05
    torch.cuda.synchronize()
    for b, n in enumerate(k_lens):
        assert (out[b] - ref[b]).abs().max().item() <= tol / (n + 8) ** 0.5
        assert torch.equal(out[b], ones[b])


@pytest.mark.parametrize("quant", [False, True])
def test_rows_partials_merged_over_sp_match_b3(dev, quant):
    """Rows over sp: each row's B4 partials over its part of each rank's
    slots (two ranks as threads, ``torch_mesh_worker.run_threads``),
    merged over sp and folded with the new block
    (``append_attention_rows_sharded``), against B3 on the whole cache:
    three rows at 3000, 0 (a dead row) and 1500 keys over 2 x 2048 slots,
    within B1's bound over sqrt(k_len + Tn) plus one bf16 ulp of the
    row's largest output (both round their fp32 result to bf16)."""
    from torch_mesh_worker import run_threads
    from triforce_tpu_torch.ops import sp_attention as tsp
    k_lens, tn, hkv, d, s = [3000, 0, 1500], 8, 4, 128, 4096
    q, kn, vn, k, v, _, kl = _b3_inputs(dev, tn, tn, k_lens, s, d, False,
                                        hkv=hkv)
    k, v = k[:, 1].contiguous(), v[:, 1].contiguous()   # q: G 1
    ks = vs = None
    if quant:
        (k, ks), (v, vs) = tcache.quantize_tokens(k), \
            tcache.quantize_tokens(v)
    want = tatt.append_attention_rows(q, k, v, kn, vn, k_len=kl, k_scale=ks,
                                      v_scale=vs)

    def rank(mesh):
        half = s // 2
        i = mesh.index("sp")

        def cut(x):
            return None if x is None else \
                x[:, :, i * half:(i + 1) * half].contiguous()
        return tsp.append_attention_rows_sharded(
            mesh, q, cut(k), cut(v), kn, vn, k_len=kl, k_scale=cut(ks),
            v_scale=cut(vs))

    before = tfd.flash_decode_partials_int8.launches if quant \
        else tfd.flash_decode_partials.launches
    outs = run_threads(rank, sp=2)
    torch.cuda.synchronize()
    after = tfd.flash_decode_partials_int8.launches if quant \
        else tfd.flash_decode_partials.launches
    assert after - before == 2 * len(k_lens)      # one a row a rank
    assert torch.equal(outs[0], outs[1])
    for b, n in enumerate(k_lens):
        err = (outs[0][b].float() - want[b].float()).abs().max().item()
        ulp = want[b].float().abs().max().item() * 2 ** -7
        assert err <= (0.005 if quant else 0.05) / (n + tn) ** 0.5 + ulp


@pytest.mark.parametrize("gt,tn,k_lens,s,d,per_row_mask", B3_CASES)
def test_flash_decode_batched_int8_matches_plain_and_b1(dev, gt, tn, k_lens,
                                                        s, d, per_row_mask):
    q, kn, vn, k, v, mask, kl = _b3_inputs(dev, gt, tn, k_lens, s, d,
                                           per_row_mask)
    (k, ks), (v, vs) = tcache.quantize_tokens(k), tcache.quantize_tokens(v)
    for b, n in enumerate(k_lens):    # poisoned codes and scales: never read
        k[b, 1, :, n:], v[b, 1, :, n:] = 127, -127
        ks[b, 1, :, n:], vs[b, 1, :, n:] = 1e3, 1e3
    k, v, ks, vs = k[:, 1], v[:, 1], ks[:, 1], vs[:, 1]
    before = tfd.flash_decode_append_batched_int8.launches
    out = tfd.flash_decode_append_batched_int8(q, k, v, kn, vn, kl, mask, ks,
                                               vs)
    ref = tfd.flash_decode_append_batched_int8_plain(
        q, k, v, kn, vn, kl, mask, ks, vs, group=tfd.KERNEL_GROUP)
    torch.cuda.synchronize()
    assert tfd.flash_decode_append_batched_int8.launches == before + 1
    assert torch.isfinite(out).all()
    for b, n in enumerate(k_lens):
        assert (out[b] - ref[b]).abs().max().item() <= 0.005 / (n + tn) ** 0.5
        m = mask[b] if per_row_mask else mask
        one = tfd.flash_decode_append_int8(q[b], k[b], v[b], kn[b], vn[b],
                                           kl[b], m.contiguous(), ks[b],
                                           vs[b])
        assert torch.equal(out[b], one)


def test_flash_decode_batched_rejects_what_it_does_not_take(dev):
    """fp32 tensors, a k_len of the wrong length and the other kernel's
    cache type raise; nothing falls back to the plain version."""
    q = _randn(dev, 0, 2, 2, 1, 128)
    kb = _randn(dev, 1, 2, 2, 64, 128)
    k8, ks = _int8_cache(dev, 2, 2, 2, 64, 128)
    mask = torch.ones((1, 1), dtype=torch.bool, device=dev)
    with pytest.raises(TypeError):
        tfd.flash_decode_append_batched(q.float(), kb, kb, q, q, [8, 8], mask)
    with pytest.raises(ValueError):
        tfd.flash_decode_append_batched(q, kb, kb, q, q, [8], mask)
    with pytest.raises(TypeError):
        tfd.flash_decode_append_batched(q, k8, k8, q, q, [8, 8], mask)
    with pytest.raises(TypeError):
        tfd.flash_decode_append_batched_int8(q, kb, kb, q, q, [8, 8], mask,
                                             ks, ks)
    with pytest.raises(ValueError):
        tfd.flash_decode_append_batched_int8(q, k8, k8, q, q, [8, 8], mask,
                                             ks.half(), ks.half())


# ---------------------------------------------------------------------------
# cache-only partials: B4 and B4-int8
# ---------------------------------------------------------------------------

B4_CASES = [
    # gt, k_len, s, d
    (1, 1000, 1100, 128),
    (22, 4096, 4246, 128),
    (22, 0, 300, 128),        # an empty prefix: (-1e30, 0, 0)
    (16, 5, 64, 128),         # warps of the key-split path with no live key
    (200, 777, 1000, 128),
    (40, 333, 400, 64),
    (1, 37, 64, 128),         # the root, shorter than one 64-key tile
    (1, 4133, 4246, 64),      # the root, not a whole number of tiles
    # the wide path's edges: GT 17, 64, 65 and 128, ragged and sub-tile
    # k_len, an empty prefix
    (17, 4133, 4200, 128),
    (64, 37, 100, 128),
    (65, 1000, 1100, 64),
    (128, 4096, 4300, 128),
    (128, 0, 300, 128),
    # tinyllama-1.1b-128k's tree grow (G 8): a level of the CLI's 128-node
    # tree (W 36, GT 288), of the 11-level one (W 22, GT 176), the root
    (288, 4096, 4260, 64),
    (176, 4096, 4260, 64),
    (8, 4096, 4260, 64),
    # over a mesh every attention is B4: the tree verify (GT 128 at D 128;
    # tinyllama-1.1b-128k's G 8 x 128 = 1024 at D 64) and a row's verify
    # over a shard
    (128, 8192, 8400, 128),
    (1024, 8192, 8400, 64),
    (8, 4096, 4160, 128),
]


def _assert_partials(got, ref, k_len, tol):
    """m equal to 1e-5 and l to 1e-4 relative (fp32 sums in another
    order), the normalised acc / l within B1's bound ``tol / sqrt(k_len)``;
    with k_len = 0 exactly (-1e30, 0, 0)."""
    (m, l, acc), (mr, lr, accr) = got, ref
    assert all(torch.isfinite(x).all() for x in got)
    if k_len == 0:
        assert (m == -1e30).all() and (l == 0).all() and (acc == 0).all()
        return
    torch.testing.assert_close(m, mr, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, lr, rtol=1e-4, atol=0)
    err = (acc / l[..., None] - accr / lr[..., None]).abs().max().item()
    assert err <= tol / k_len ** 0.5


def _as_partials(p, hkv, gt, d):
    m, l, acc = p
    return (m.reshape(1, hkv, 1, gt), l.reshape(1, hkv, 1, gt),
            acc.reshape(1, hkv, 1, gt, d))


@pytest.mark.parametrize("gt,k_len,s,d", B4_CASES)
def test_flash_decode_partials_matches_plain_and_b1(dev, gt, k_len, s, d):
    hkv = 4
    q = _randn(dev, 0, hkv, gt, d)
    # layer 1 of a stacked [L, 1, Hkv, S, D] cache: a view
    k, v = _randn(dev, 3, 2, 1, hkv, s, d), _randn(dev, 4, 2, 1, hkv, s, d)
    k[1, :, :, k_len:] = 50.0    # stale slots past k_len must never be read
    v[1, :, :, k_len:] = 50.0
    k, v = k[1, 0], v[1, 0]
    kl = torch.tensor(k_len, dtype=torch.int32, device=dev)
    before = tfd.flash_decode_partials.launches
    got = tfd.flash_decode_partials(q, k, v, kl)
    ref = tfd.flash_decode_partials_plain(q, k, v, kl)
    torch.cuda.synchronize()
    assert tfd.flash_decode_partials.launches == before + 1
    assert got[0].shape == (hkv, gt) and got[2].shape == (hkv, gt, d)
    _assert_partials(got, ref, k_len, 0.05)
    # merged with a new block and normalised, B4 is B1 on the same inputs
    tn = min(gt, 24)
    kn, vn = _randn(dev, 1, hkv, tn, d), _randn(dev, 2, hkv, tn, d)
    g = torch.Generator(device=dev).manual_seed(5)
    mask = torch.rand((gt, tn), generator=g, device=dev) < 0.6
    mask[:, 0] = True
    pn = tatt.new_block_partials(q[None], kn[None], vn[None], mask)
    out = tatt.finalize(tatt.merge_partials(_as_partials(got, hkv, gt, d),
                                            pn), torch.float32)[0]
    b1 = tfd.flash_decode_append(q, k, v, kn, vn, kl, mask)
    assert torch.isfinite(out).all()
    assert (out - b1).abs().max().item() <= 0.05 / (k_len + tn) ** 0.5


@pytest.mark.parametrize("gt,k_len,s,d", B4_CASES)
def test_flash_decode_partials_int8_matches_plain_and_b1(dev, gt, k_len, s,
                                                         d):
    hkv = 4
    q = _randn(dev, 0, hkv, gt, d)
    k, ks = _int8_cache(dev, 3, 2, 1, hkv, s, d)
    v, vs = _int8_cache(dev, 4, 2, 1, hkv, s, d)
    k[1, :, :, k_len:], v[1, :, :, k_len:] = 127, -127    # never read
    ks[1, :, :, k_len:], vs[1, :, :, k_len:] = 1e3, 1e3
    k, v, ks, vs = k[1, 0], v[1, 0], ks[1, 0], vs[1, 0]
    kl = torch.tensor(k_len, dtype=torch.int32, device=dev)
    before = tfd.flash_decode_partials_int8.launches
    got = tfd.flash_decode_partials_int8(q, k, v, kl, ks, vs)
    ref = tfd.flash_decode_partials_int8_plain(q, k, v, kl, ks, vs,
                                               group=tfd.KERNEL_GROUP)
    torch.cuda.synchronize()
    assert tfd.flash_decode_partials_int8.launches == before + 1
    _assert_partials(got, ref, k_len, 0.005)
    # against B1-int8: the same codes of q and the cache, but B1-int8 shows
    # its new block bf16(q8 * qs) where the merge here shows it q itself,
    # so the two agree to q's quantization step, not to rounding
    tn = min(gt, 24)
    kn, vn = _randn(dev, 1, hkv, tn, d), _randn(dev, 2, hkv, tn, d)
    mask = torch.ones((gt, tn), dtype=torch.bool, device=dev)
    pn = tatt.new_block_partials(q[None], kn[None], vn[None], mask)
    out = tatt.finalize(tatt.merge_partials(_as_partials(got, hkv, gt, d),
                                            pn), torch.float32)[0]
    b1 = tfd.flash_decode_append_int8(q, k, v, kn, vn, kl, mask, ks, vs)
    assert torch.isfinite(out).all()
    assert (out - b1).abs().max().item() <= 0.1


# a rank's shard over a mesh (sp 2; tp 2 of Llama2-7B's 32 heads): gt, hkv,
# d, tn, k_len
SHARD_CASES = [
    # the world-1 prefill's 17th 512-token chunk over 8192 keys, where
    # merge(plain B4-int8, new block) missed plain B1-int8 by 1.03x the
    # tolerance (ROADMAP C item 2)
    (512, 32, 128, 512, 8192),
    (8, 16, 128, 8, 8192),          # the verify over a 16384-token prompt
    (4096, 4, 64, 512, 8192),       # tinyllama's G 8 x 512-token chunk
    (8, 16, 128, 8, 2048),          # the verify of the two-rank runs
    (512, 32, 128, 512, 2048),      # their prefill chunk
]


@pytest.mark.parametrize("gt,hkv,d,tn,k_len", SHARD_CASES)
def test_partials_int8_merge_at_shard_shapes(dev, gt, hkv, d, tn, k_len):
    """B4-int8 merged with a new block (q'' = bf16(q8 * qs), as B1-int8
    shows its new block) against the same merge of its plain partials, and
    B1-int8 against its plain version on the same inputs, each at
    chip_smoke.py's int8 tolerance 0.005 / sqrt(k_len + Tn); the plain
    partials with B1's fold are plain B1-int8 bit for bit. merge(plain) is
    not held to B1-int8 at that tolerance: the merge rounds the new block's
    p against the block's own maximum, B1's fold against the row's, which
    moves each p.v term by up to 2^-7 of itself."""
    q, kn, vn = (_randn(dev, 0, hkv, gt, d), _randn(dev, 1, hkv, tn, d),
                 _randn(dev, 2, hkv, tn, d))
    s = k_len + 64
    k, ks = _int8_cache(dev, 3, hkv, s, d)
    v, vs = _int8_cache(dev, 4, hkv, s, d)
    k[:, k_len:], v[:, k_len:] = 127, -127        # never read
    ks[:, k_len:], vs[:, k_len:] = 1e3, 1e3
    kl = torch.tensor(k_len, dtype=torch.int32, device=dev)
    mask = _mask(dev, "random", gt, tn)
    got = tfd.flash_decode_partials_int8(q, k, v, kl, ks, vs)
    ref = tfd.flash_decode_partials_int8_plain(q, k, v, kl, ks, vs,
                                               group=tfd.KERNEL_GROUP)
    b1 = tfd.flash_decode_append_int8(q, k, v, kn, vn, kl, mask, ks, vs)
    b1_plain = tfd.flash_decode_append_int8_plain(
        q, k, v, kn, vn, kl, mask, ks, vs, group=tfd.KERNEL_GROUP)
    torch.cuda.synchronize()
    _assert_partials(got, ref, k_len, 0.005)
    tol = 0.005 / (k_len + tn) ** 0.5
    assert (b1 - b1_plain).abs().max().item() <= tol
    assert torch.equal(tfd.flash_decode_fold_int8_plain(q, *ref, kn, vn,
                                                        mask), b1_plain)
    q8, qs = tfd._quantize_rows(
        (q.float() * tfd._scale(d)).to(torch.bfloat16).float())
    qn = (q8 * qs).to(torch.bfloat16).reshape(1, hkv, 1, gt, d)
    pn = tatt._update(qn, *tatt._init_partials(q[None], hkv), kn[None],
                      vn[None], mask)

    def merge(p, *blocks):
        p = _as_partials(p, hkv, gt, d)
        for b in blocks:
            p = tatt.merge_partials(p, b)
        return tatt.finalize(p, torch.float32)[0]

    out, want = merge(got, pn), merge(ref, pn)
    assert torch.isfinite(out).all()
    assert (out - want).abs().max().item() <= tol
    # the check would catch a lost or a doubled new block
    for alt in (merge(ref), merge(ref, pn, pn)):
        assert (alt - want).abs().max().item() > 10 * tol


def test_flash_decode_partials_rejects_what_it_does_not_take(dev):
    q = _randn(dev, 0, 2, 1, 128)
    kb = _randn(dev, 1, 2, 64, 128)
    k8, ks = _int8_cache(dev, 2, 2, 64, 128)
    with pytest.raises(TypeError):
        tfd.flash_decode_partials(q.float(), kb, kb, 8)
    with pytest.raises(TypeError):
        tfd.flash_decode_partials(q, k8, k8, 8)
    with pytest.raises(TypeError):
        tfd.flash_decode_partials_int8(q, kb, kb, 8, ks, ks)
    with pytest.raises(ValueError):
        tfd.flash_decode_partials_int8(q, k8, k8, 8, ks.half(), ks.half())
    with pytest.raises(ValueError):
        tfd.flash_decode_partials(q, kb[:, :, :96], kb[:, :, :96], 8)


@pytest.mark.parametrize("rows,k,n", [(1, 4096, 4096), (22, 4096, 11008),
                                      (128, 11008, 4096), (7, 64, 32000)])
def test_int_matmul_matches_int64_reference(dev, rows, k, n):
    """The int8 x int8 product of ``_wmm(aq=True)`` on the card (the
    library's integer GEMM over zero-padded rows) is exact: equal to an
    int64 reference, at row counts below and above the GEMM's minimum."""
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randint(-127, 128, (rows, k), generator=g, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (2, k, n), generator=g, device=dev,
                      dtype=torch.int8)[1]          # a layer of a stack
    out = tl._int_matmul(x, w)
    assert out.dtype == torch.int32 and out.shape == (rows, n)
    ref = (x.double() @ w.double()).to(torch.int64)   # exact: < 2^53
    assert torch.equal(out.to(torch.int64), ref)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("quant", [False, True])
def test_decode_plan_on_the_card(dev, d, quant):
    """The decode path's plan from the built kernel: at least one CTA per
    SM, one partial per split, and the splits of one row's heads in one
    wave of the card."""
    sms, per_sm = tfd._wave(dev, d, quant)
    assert sms == torch.cuda.get_device_properties(dev).multi_processor_count
    assert per_sm >= 1
    q = torch.empty((32, 1, d), dtype=torch.bfloat16, device=dev)
    nsplit, parts = tfd._plan(q, 32928, quant)
    assert parts == nsplit == tfd.decode_nsplit(32, 32928, sms, per_sm)
    assert 32 * nsplit <= sms * per_sm
    # the library takes the decode path up to the wrapper's DECODE_ROWS
    lib = tfd._build.lib(tfd._SOURCE)
    assert lib.tf_flash_decode_ctas_per_sm(tfd.DECODE_ROWS, d, quant) == per_sm
    assert lib.tf_flash_decode_ctas_per_sm(1, d, quant) == per_sm



@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("quant", [False, True])
def test_wide_plan_on_the_card(dev, d, quant):
    """The wide path's plan from the built library: a q tile of 64 or 128
    rows (the library's choice, more rows for more GT), at least one CTA
    per SM, and the splits of all q tiles of one row's heads in whole
    waves of the card."""
    lib = tfd._build.lib(tfd._SOURCE)
    assert lib.tf_flash_decode_cta_rows(1) == 1
    tiles = [lib.tf_flash_decode_cta_rows(gt) for gt in (17, 64, 65, 4096)]
    assert set(tiles) <= {64, 128} and tiles == sorted(tiles)
    for hkv, gt in ((32, 17), (32, 128), (32, 512), (4, 4096)):
        sms, per_sm = tfd._wave(dev, d, quant, gt)
        assert per_sm >= 1
        q = torch.empty((hkv, gt, d), dtype=torch.bfloat16, device=dev)
        nsplit, parts = tfd._plan(q, 32928, quant)
        cta = tfd._cta_rows(gt)
        assert parts == nsplit == tfd.wide_nsplit(hkv, gt, 32928, sms, per_sm,
                                                  cta)
        tiles = hkv * -(-gt // cta)
        assert nsplit == 1 or tiles * nsplit <= sms * per_sm


# ---------------------------------------------------------------------------
# The layer glue (ops/layer_glue.py): residual add + RMSNorm, RoPE on q and
# k, silu(gate) * up, against their plain versions at the cells' shapes
# ---------------------------------------------------------------------------

from triforce_tpu_torch import config as tcfg  # noqa: E402
from triforce_tpu_torch.models import rope as trope  # noqa: E402
from triforce_tpu_torch.ops import layer_glue as tlg  # noqa: E402


def _bf16_ulps(a, b):
    """Elementwise distance in bf16 ulps (bit patterns in sign-magnitude
    order, so -0 and +0 are one value)."""
    def key(x):
        k = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(k < 0, -(k & 0x7FFF), k)
    return (key(a) - key(b)).abs()


def _rand(dev, seed, *shape, dtype=torch.bfloat16, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


# rows x hidden: a verify (7, 8), the rows step (8 x 7), a prefill chunk,
# the drafter's width
NORM_CASES = [(1, 4096), (7, 4096), (8, 4096), (56, 4096), (512, 4096),
              (7, 768), (266, 768)]


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("rows,hidden", NORM_CASES)
def test_add_rms_norm_matches_plain(dev, rows, hidden, residual):
    """bf16: x + y bit-equal; the normalised value (gain 1) within one
    ulp, since only the order of the fp32 sum of squares differs; with a
    gain, h = bf16(w * n) moves by at most two ulps when n moves by one.
    fp32: the same chain to fp32 rounding."""
    for dtype in (torch.bfloat16, torch.float32):
        x = _rand(dev, 0, 1, rows, hidden, dtype=dtype)
        y = _rand(dev, 1, 1, rows, hidden, dtype=dtype, scale=0.3) \
            if residual else None
        w = 1 + _rand(dev, 2, hidden, dtype=dtype, scale=0.1)
        ones = torch.ones_like(w)
        before = tlg.add_rms_norm.launches
        xo, h = tlg.add_rms_norm(x, y, w, 1e-5)
        _, n = tlg.add_rms_norm(x, y, ones, 1e-5)
        torch.cuda.synchronize()
        assert tlg.add_rms_norm.launches == before + 2
        px, ph = tlg.add_rms_norm_plain(x, y, w, 1e-5)
        _, pn = tlg.add_rms_norm_plain(x, y, ones, 1e-5)
        assert torch.equal(xo, px)
        if not residual:
            assert xo is x
        if dtype == torch.bfloat16:
            assert _bf16_ulps(n, pn).max().item() <= 1
            assert _bf16_ulps(h, ph).max().item() <= 2
        else:
            torch.testing.assert_close(h, ph, rtol=2e-6, atol=1e-7)


# (B, Hq, Hkv, T, D, a position per row): Mistral's verifies (GQA 4), Yi's
# rows step (8 rows x 7, GQA 8), a 512-token prefill chunk, the drafter's
# q and k (12 heads, D 64)
ROPE_CARD_CASES = [(1, 32, 8, 7, 128, False), (1, 32, 8, 8, 128, False),
                   (8, 32, 4, 7, 128, True), (1, 32, 8, 512, 128, False),
                   (1, 12, 12, 7, 64, False), (1, 32, 4, 1, 128, True)]


@pytest.mark.parametrize("b,hq,hkv,t,d,per_row", ROPE_CARD_CASES)
def test_rope_matches_plain(dev, b, hq, hkv, t, d, per_row):
    """q and k, as the projections leave them (a [B, T, H, D] buffer seen
    as [B, H, T, D]), rotated in one launch: bit-equal to the plain
    version in bf16 and fp32."""
    cfg = tcfg.LLAMA2_7B_128K.with_(head_dim=d)
    cos, sin = trope.cos_sin_tables(cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(t)
    shape = (b, t) if per_row else (t,)
    positions = torch.randint(0, cos.shape[0], shape, generator=g,
                              device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        q = _rand(dev, 3, b, t, hq, d, dtype=dtype).transpose(1, 2)
        k = _rand(dev, 4, b, t, hkv, d, dtype=dtype).transpose(1, 2)
        before = tlg.rope.launches
        rq, rk = tlg.rope((q, k), cos, sin, positions)
        torch.cuda.synchronize()
        assert tlg.rope.launches == before + 1
        assert rq.is_contiguous() and rk.is_contiguous()
        assert torch.equal(rq, tlg.rope_plain(q, cos, sin, positions))
        assert torch.equal(rk, tlg.rope_plain(k, cos, sin, positions))


@pytest.mark.parametrize("rows", [1, 8])
def test_rope_over_the_drafters_window_matches_plain(dev, rows):
    """The drafter's re-rotation of one layer of its un-rotated cache (a
    view of the stacked planes) at every slot: 275 slots (start 16 +
    recent 250 + gamma 6 + 3) at D 64, bit-equal."""
    cfg = tcfg.TINY_DRAFT.with_(num_heads=12, num_kv_heads=12, head_dim=64,
                                hidden_size=768)
    spec = tcfg.SpecConfig(gamma=6)
    if rows == 1:
        dkv = tcache.init_streaming(cfg, spec, device=dev)
        layer = dkv.k[1]
    else:
        dkv = tcache.init_streaming_rows(cfg, spec, rows, device=dev)
        layer = dkv.k[:, 1]
    dkv.k.copy_(_rand(dev, 5, *dkv.k.shape))
    s = dkv.real_budget
    cos, sin = trope.cos_sin_tables(cfg, max_len=s, device=dev)
    slot_pos = torch.arange(s, device=dev)
    (got,) = tlg.rope((layer,), cos, sin, slot_pos)
    torch.cuda.synchronize()
    assert torch.equal(got, tlg.rope_plain(layer, cos, sin, slot_pos))


@pytest.mark.parametrize("shape", [(1, 7, 14336), (8, 7, 11008),
                                   (1, 512, 14336), (1, 7, 3072)])
def test_silu_mul_matches_plain(dev, shape):
    for dtype in (torch.bfloat16, torch.float32):
        gate = _rand(dev, 6, *shape, dtype=dtype, scale=3.0)
        up = _rand(dev, 7, *shape, dtype=dtype)
        before = tlg.silu_mul.launches
        out = tlg.silu_mul(gate, up)
        torch.cuda.synchronize()
        assert tlg.silu_mul.launches == before + 1
        assert torch.equal(out, tlg.silu_mul_plain(gate, up))


def test_layer_glue_refuses_off_16_byte_packs(dev):
    """The kernels move 16-byte packs only: a row, a half head or a length
    that is not a whole number of packs, and an operand that does not
    start on 16 bytes, are refused before any launch."""
    def offset(*shape):       # contiguous, 2 bytes past a 16-byte boundary
        return _rand(dev, 9, int(torch.tensor(shape).prod()) + 1)[1:] \
            .view(*shape)
    counters = (tlg.add_rms_norm, tlg.rope, tlg.silu_mul)
    before = [c.launches for c in counters]
    w = 1 + _rand(dev, 2, 4100, scale=0.1)
    with pytest.raises(ValueError):      # hidden 4100: not whole packs
        tlg.add_rms_norm(_rand(dev, 0, 7, 4100), None, w, 1e-5)
    w = 1 + _rand(dev, 2, 4096, scale=0.1)
    with pytest.raises(ValueError):      # y off 16 bytes
        tlg.add_rms_norm(_rand(dev, 0, 7, 4096), offset(7, 4096), w, 1e-5)
    cfg = tcfg.LLAMA2_7B_128K.with_(head_dim=36)
    cos, sin = trope.cos_sin_tables(cfg, device=dev)
    pos = torch.arange(5, 12, device=dev)
    with pytest.raises(ValueError):      # D / 2 = 18: not whole packs
        tlg.rope((_rand(dev, 3, 1, 7, 8, 36).transpose(1, 2),), cos, sin,
                 pos)
    with pytest.raises(ValueError):      # n = 7007: not whole packs
        tlg.silu_mul(_rand(dev, 6, 7, 1001), _rand(dev, 7, 7, 1001))
    with pytest.raises(ValueError):      # gate off 16 bytes
        tlg.silu_mul(offset(7, 1024), _rand(dev, 7, 7, 1024))
    assert [c.launches for c in counters] == before


ROPE_TRAP_CHILD = """
import sys, torch
from triforce_tpu_torch.ops import layer_glue as lg
dev = torch.device("cuda")
cos = torch.zeros((16, 64), device=dev)
q = torch.zeros((1, 4, 3, 64), dtype=torch.bfloat16, device=dev)
try:
    lg.rope((q,), cos, cos, torch.tensor([0, int(sys.argv[1]), 1],
                                         device=dev))
    torch.cuda.synchronize()
except RuntimeError as e:
    print("stopped:", str(e).splitlines()[0])
else:
    print("rotated")
"""


@pytest.mark.parametrize("position,want", [(16, "stopped"), (-1, "stopped"),
                                           (15, "rotated")])
def test_rope_stops_at_a_position_outside_the_table(dev, position, want):
    """A position outside the table's 16 rows stops the kernel (a device
    trap) rather than rotating by some other row; the last row rotates.
    In a child process: the trap ends its CUDA context."""
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", ROPE_TRAP_CHILD,
                        str(position)], cwd=root, capture_output=True,
                       text=True, timeout=600)
    assert r.stdout.startswith(want), (r.stdout, r.stderr[-2000:])


def test_layer_glue_refuses_what_it_does_not_take(dev):
    x = _rand(dev, 0, 1, 7, 256)
    with pytest.raises(ValueError):      # y of another dtype
        tlg.add_rms_norm(x, x.float(), torch.ones(256, device=dev,
                                                  dtype=x.dtype), 1e-5)
    with pytest.raises(ValueError):      # a transposed x
        tlg.add_rms_norm(x.transpose(1, 2), None, torch.ones(
            7, device=dev, dtype=x.dtype), 1e-5)
    with pytest.raises(ValueError):      # a strided gate
        tlg.silu_mul(x[..., ::2], x[..., ::2])
    cos = torch.zeros((16, 64), device=dev)
    with pytest.raises(ValueError):      # int32 positions
        tlg.rope((_rand(dev, 1, 1, 4, 7, 64),), cos, cos,
                 torch.zeros(7, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# CUDA graphs: every graphed decode region against its eager witness
# ---------------------------------------------------------------------------

from triforce_tpu_torch import batched_spec as tbs  # noqa: E402
from triforce_tpu_torch import batching as tbatching  # noqa: E402
from triforce_tpu_torch import graphs as tgraphs  # noqa: E402
from triforce_tpu_torch.engine import Engine as TEngine  # noqa: E402
from triforce_tpu_torch.tree import planner as tplanner  # noqa: E402
from triforce_tpu_torch.tree import spectree as tspectree  # noqa: E402

# small configs the kernels take (head_dim 64, bf16 on the card)
CARD_TARGET = tcfg.TINY_TARGET.with_(vocab_size=512, hidden_size=256,
                                     intermediate_size=512, num_heads=4,
                                     num_kv_heads=2, head_dim=64)
CARD_DRAFT = tcfg.TINY_DRAFT.with_(vocab_size=512, hidden_size=128,
                                   intermediate_size=256, num_heads=2,
                                   num_kv_heads=2, head_dim=64)
CARD_SPEC = tcfg.SpecConfig(gamma=3, budget=64, chunk_size=8,
                            draft_start_size=4, draft_recent_size=60,
                            temperature=0.6, top_p=0.9)
CARD_PREFILL = 256


def _card_engines(dev, quant):
    tp = tl.init_params(CARD_TARGET, device=dev, seed=3)
    dp = tl.init_params(CARD_DRAFT, device=dev, seed=4)
    kw = dict(draft_cfg=CARD_DRAFT, draft_params=dp, prefill=CARD_PREFILL,
              max_cache_len=CARD_PREFILL + 256, prefill_chunk=128,
              device=dev, kv_quant=quant, weight_quant=quant)
    return (TEngine(CARD_TARGET, CARD_SPEC, tp, graphs=True, **kw),
            TEngine(CARD_TARGET, CARD_SPEC, tp, graphs=False, **kw))


def _prompt(dev, seed=0, n=CARD_PREFILL):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, CARD_TARGET.vocab_size, (1, n), generator=g
                         ).to(dev)


def _launches():
    return [fn.launches for fn in tgraphs.COUNTED]


def _zero_launches():
    for fn in tgraphs.COUNTED:
        fn.launches = 0


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("mode,alpha", [("ar", None), ("retrieval", None),
                                        ("triforce", None),
                                        ("triforce", 0.9)])
def test_graphed_engine_equals_eager(dev, quant, mode, alpha):
    """The graphed engine emits the eager engine's tokens bit for bit, with
    the same counters, the same kv length, the same kernel launches and
    the generator in the same state; its captures do not grow with the
    steps (a capture that raises fails the test); its generation loop
    (a graph with if-nodes) reads back once a call."""
    ge, ee = _card_engines(dev, quant)
    ids = _prompt(dev)
    out, readbacks = {}, {}
    for eng in (ge, ee):
        r0 = eng.graphs.readbacks
        state = eng.init_state(7)
        state = eng.prefill_target(state, ids)
        if mode != "ar":
            state = eng.prefill_draft(state, ids)
        _zero_launches()
        if mode == "ar":
            kv, tok, gen, buf = eng.generate_ar(state.kv, state.next_token,
                                                state.gen, 24)
            res = (buf.tolist(), int(kv.seq_len), None)
        elif alpha is None:
            state, buf, n, c = eng.generate(state, 24, mode=mode)
            res = (buf[:n].tolist(), int(state.kv.seq_len), c.tolist())
        else:
            state, buf, n, c = eng.generate_forced(state, 24, alpha, mode=mode)
            res = (buf[:n].tolist(), int(state.kv.seq_len), c.tolist())
        torch.cuda.synchronize()
        readbacks[eng is ge] = eng.graphs.readbacks - r0
        gen = state.gen if mode != "ar" else gen
        out[eng is ge] = res + (_launches(), gen.get_state())
    (gt, gl, gc, gla, gs), (et, el, ec, ela, es) = out[True], out[False]
    assert gt == et and gl == el and gc == ec
    assert gla == ela and any(gla)
    assert torch.equal(gs, es)
    if mode != "ar":
        assert readbacks[True] == 1 and readbacks[False] > 1
    assert ge.graphs.captures >= 1 and ge.graphs.replays >= 1
    assert ee.graphs.captures == 0
    caps = ge.graphs.captures
    # a second state of the same engine captures the same number again
    state = ge.prefill_target(ge.init_state(8), ids)
    if mode == "ar":
        ge.generate_ar(state.kv, state.next_token, state.gen, 48)
    else:
        state = ge.prefill_draft(state, ids)
        ge.generate(state, 48, mode=mode) if alpha is None \
            else ge.generate_forced(state, 48, alpha, mode=mode)
    torch.cuda.synchronize()
    assert ge.graphs.captures == 2 * caps


@pytest.mark.parametrize("quant", [False, True])
def test_graphed_prefill_equals_eager(dev, quant):
    """Three prefills (target, build, drafter) into one state of the
    graphed engine, the second capturing the remainder and the build, the
    third replaying every region, each leave the eager engine's caches,
    lengths, first token and generator bit for bit, with its launches."""
    ge, ee = _card_engines(dev, quant)
    ids = _prompt(dev, 5)

    def prefill(eng, st):
        st = eng.prefill_draft(eng.prefill_target(st, ids), ids)
        torch.cuda.synchronize()
        return st

    _zero_launches()
    want = prefill(ee, ee.init_state(3))
    want_launches = _launches()
    st = ge.init_state(3)
    for rnd in range(3):
        row = dataclasses.replace(
            st, kv=dataclasses.replace(st.kv, seq_len=torch.zeros_like(
                st.kv.seq_len)),
            dkv=dataclasses.replace(st.dkv, seq_len=torch.zeros_like(
                st.dkv.seq_len)),
            gen=torch.Generator(device=dev).manual_seed(3))
        c0 = ge.graphs.captures
        _zero_launches()
        got = prefill(ge, row)
        assert _launches() == want_launches and any(want_launches)
        n = int(want.kv.seq_len)
        assert int(got.kv.seq_len) == n
        for a, b in zip(tgraphs.planes(got.kv), tgraphs.planes(want.kv)):
            assert torch.equal(a[:, :, :, :n], b[:, :, :, :n])
        for a, b in zip(tgraphs.planes(got.rkv, got.dkv),
                        tgraphs.planes(want.rkv, want.dkv)):
            assert torch.equal(a, b)
        assert int(got.dkv.seq_len) == int(want.dkv.seq_len)
        assert torch.equal(got.next_token, want.next_token)
        assert torch.equal(got.gen.get_state(), want.gen.get_state())
        if rnd == 2:
            assert ge.graphs.captures == c0     # every region replayed


@pytest.mark.parametrize("quant", [False, True])
def test_graphed_tree_equals_eager(dev, quant):
    pv = tplanner.modeled_acceptance_vector(0.8, 4)
    gm = tplanner.build_grow_map(*tplanner.plan_tree(pv, 16, 5), 16, 5)
    tp = tl.init_params(CARD_TARGET, device=dev, seed=3)
    kw = dict(prefill=CARD_PREFILL, max_cache_len=CARD_PREFILL + 256,
              budget=64, chunk_size=8, prefill_chunk=128, device=dev,
              kv_quant=quant, weight_quant=quant, eos_ids=())
    ids = _prompt(dev)
    out = {}
    for graphs in (True, False):
        eng = tspectree.TreeEngine(CARD_TARGET, gm, tp, graphs=graphs, **kw)
        state = eng.prefill_target(eng.init_state(5), ids)
        _zero_launches()
        state, buf, n, c, _ = eng.generate(state, 16)
        state, buf2, n2, c2, _ = eng.generate_forced(state, 8, 0.9)
        torch.cuda.synchronize()
        out[graphs] = (buf[:n].tolist(), c[:2].tolist(), buf2[:n2].tolist(),
                       c2[:2].tolist(), int(state.kv.seq_len), _launches(),
                       state.gen.get_state(), eng.graphs.captures,
                       (int(c[2]), int(c2[2])))
    g, e = out[True], out[False]
    assert g[:6] == e[:6] and torch.equal(g[6], e[6])
    # the loop and the forced loop, one read-back a call
    assert g[7] == 2 and e[7] == 0
    assert g[8] == (1, 1) and min(e[8]) > 1


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("mode,alpha", [("retrieval", None),
                                        ("triforce", None),
                                        ("triforce", 0.9)])
def test_graphed_batched_equals_eager(dev, quant, mode, alpha):
    """Two ``decode`` calls of the batched loop (one loop graph with
    if-nodes, replayed) against the eager engine: tokens, counters, eos,
    lengths, launches and every row's generator state bit for bit; one
    capture and one read-back a call (the eager engine reads each
    condition back)."""
    ge, ee = _card_engines(dev, quant)
    prompts = [_prompt(dev, s) for s in (1, 2, 3)]
    out = {}
    for eng in (ge, ee):
        bat = tbs.BatchedSpecEngine(eng, mode=mode, force_accept=alpha)
        state = bat.prefill_rows(prompts, [11, 12, 13])
        pre = eng.graphs.captures
        got = []
        for _ in range(2):
            _zero_launches()
            r0 = eng.graphs.readbacks
            state, toks, ns, c, eos = bat.decode(state, 4)
            torch.cuda.synchronize()
            got.append((toks.tolist(), ns.tolist(), c.tolist(),
                        eos.tolist(), state.kv.seq_len.tolist(),
                        _launches(), eng.graphs.readbacks - r0))
        out[eng is ge] = ([x[:6] for x in got], [x[6] for x in got],
                          [g.get_state() for g in state.gens],
                          eng.graphs.captures - pre, bat.target_forwards)
    g, e = out[True], out[False]
    assert g[0] == e[0] and all(any(x[5]) for x in g[0]) and g[4] == e[4]
    assert all(torch.equal(a, b) for a, b in zip(g[2], e[2]))
    assert g[3] == 1 and g[1] == [1, 1]
    if mode == "triforce":
        assert min(e[1]) > 4


@pytest.mark.parametrize("quant", [False, True])
def test_graphed_spec_scheduler_equals_eager(dev, quant):
    """5 requests through 2 speculative slots: the graphed scheduler serves
    the eager one's tokens with its steps, target forwards and launches,
    captures its loop once for the pool and reads back once a segment."""
    ge, ee = _card_engines(dev, quant)
    out = {}
    for eng in (ge, ee):
        sched = tbs.SpecScheduler(eng, mode="triforce", slots=2, segment=3,
                                  admit_chunks=1)
        for i in range(5):
            sched.submit(tbatching.Request(
                rid=i, prompt=_prompt(dev, 20 + i)[0].cpu().numpy(),
                max_new_tokens=12))
        _zero_launches()
        done = sched.run()
        torch.cuda.synchronize()
        st = sched.stats
        out[eng is ge] = (sorted((r.rid, r.out) for r in done), st["steps"],
                          st["target_forwards"], _launches(),
                          st["captures"], st["readbacks"],
                          st["steps"] // sched.segment)
    g, e = out[True], out[False]
    assert g[:4] == e[:4] and len(g[0]) == 5
    assert g[4] == 1 and e[4] == 0
    assert g[5] == g[6] and e[5] > e[6]


def test_graphed_ar_scheduler_equals_eager(dev):
    tp = tl.init_params(CARD_TARGET, device=dev, seed=3)
    out = {}
    for graphs in (True, False):
        sched = tbatching.Scheduler(CARD_TARGET, CARD_SPEC, tp, batch=2,
                                    max_len=CARD_PREFILL + 64,
                                    prefill_chunk=128, segment=4, device=dev,
                                    eos_token_id=-1, graphs=graphs)
        for i in range(3):
            sched.submit(tbatching.Request(
                rid=i, prompt=_prompt(dev, i)[0].cpu().numpy(),
                max_new_tokens=10))
        done = sched.run()
        out[graphs] = (sorted((r.rid, r.out) for r in done),
                       sched.stats["captures"], sched.graphs.captures)
    assert out[True][0] == out[False][0]
    assert out[True][1] == 1 and out[False][2] == 0


@pytest.mark.parametrize("pdl", [True, False])
def test_if_node_runs_its_body_where_the_predicate_holds(dev, pdl):
    """``GraphSet.cond`` captured as if-nodes (``csrc/graph_cond.cu``),
    nested two deep, holding a cuBLAS product, a B1 launch (its reduce a
    programmatic dependent where ``pdl``) and allocations, in a loop
    region (captured at its first call): every replay runs exactly the
    bodies whose predicates hold, reads nothing back, and ``read`` counts
    the B1 launch once per run of its body."""
    gs = tgraphs.GraphSet(dev, True)
    x, w = _randn(dev, 1, 256, 256), _randn(dev, 2, 256, 256)
    hkv, gt, d, s, klen = 8, 7, 128, 4200, 4100
    q, k, v = (_randn(dev, 3, hkv, gt, d), _randn(dev, 4, hkv, s, d),
               _randn(dev, 5, hkv, s, d))
    kn, vn = _randn(dev, 6, hkv, gt, d), _randn(dev, 7, hkv, gt, d)
    mask = tfd.causal_mask(gt, gt, 1, dev)
    k_len = torch.full((), klen, dtype=torch.int32, device=dev)
    prev = tfd.set_programmatic_launch(pdl)
    try:
        ref_mm = x @ w
        ref_b1 = tfd.flash_decode_append(q, k, v, kn, vn, k_len, mask)
        pred = torch.zeros((), dtype=torch.bool, device=dev)
        pred2 = torch.zeros((), dtype=torch.bool, device=dev)
        mm, b1 = torch.zeros_like(ref_mm), torch.zeros_like(ref_b1)
        cnt = torch.zeros(2, dtype=torch.int64, device=dev)

        def region():
            def inner():
                cnt[1:2].add_(torch.ones(1, dtype=torch.int64, device=dev))

            def outer():
                mm.copy_(x @ w)
                b1.copy_(tfd.flash_decode_append(q, k, v, kn, vn, k_len,
                                                 mask))
                cnt[0:1].add_(1)
                gs.cond(pred2, inner)
            gs.cond(pred, outer)
            return ()

        for p1 in (True, False, True):
            for p2 in (True, False):
                pred.fill_(p1)
                pred2.fill_(p2)
                mm.zero_()
                b1.zero_()
                c0 = cnt.clone()
                l0 = tfd.flash_decode_append.launches
                gs.run("cond", region, (), caches=(mm, b1, cnt),
                       capture_first=True)
                r0 = gs.readbacks
                gs.read(torch.zeros(0, dtype=torch.int64, device=dev))
                torch.cuda.synchronize()
                assert gs.readbacks == r0 + 1
                assert torch.equal(mm, ref_mm) == p1 and bool(mm.any()) == p1
                assert torch.equal(b1, ref_b1) == p1
                assert (cnt - c0).tolist() == [int(p1), int(p1 and p2)]
                assert tfd.flash_decode_append.launches - l0 == int(p1)
        assert gs.captures == 1 and gs.stats()["bodies"] == 2
    finally:
        tfd.set_programmatic_launch(prev)


def test_dead_graphs_give_back_their_body_counters(dev):
    """A graph that dies with its caches gives its if-node bodies'
    counters back: a new state's loop reuses them, and the launches a
    replay's bodies make are still counted once each."""
    gs = tgraphs.GraphSet(dev, True)
    q, k, v = (_randn(dev, 3, 8, 1, 128), _randn(dev, 4, 8, 512, 128),
               _randn(dev, 5, 8, 512, 128))
    kn, vn = _randn(dev, 6, 8, 1, 128), _randn(dev, 7, 8, 1, 128)
    mask = tfd.causal_mask(1, 1, 1, dev)
    k_len = torch.full((), 500, dtype=torch.int32, device=dev)
    tfd.flash_decode_append(q, k, v, kn, vn, k_len, mask)
    pred = torch.ones((), dtype=torch.bool, device=dev)
    for state in range(3):
        out = torch.zeros_like(q)

        def region():
            def body():
                out.copy_(tfd.flash_decode_append(q, k, v, kn, vn, k_len,
                                                  mask))
            gs.cond(pred, body)
            gs.cond(pred, body)
            return ()
        l0 = tfd.flash_decode_append.launches
        for _ in range(2):
            gs.run("loop", region, (), caches=(out,), capture_first=True)
        gs.read(torch.zeros(0, dtype=torch.int64, device=dev))
        torch.cuda.synchronize()
        assert tfd.flash_decode_append.launches - l0 == 4
        assert gs.captures == state + 1 and len(gs._bodies) == 2
        del out, region


def test_graphs_refuse_the_cpu():
    with pytest.raises(ValueError):
        tgraphs.GraphSet("cpu", True)


@pytest.mark.parametrize("which", ["middle verify", "drafter"])
def test_glue_launches_once_a_layer_in_a_graphed_forward(dev, which):
    """A forward through a graph set, called three times (eager, capture
    and replay, replay), leaves the eager forward's logits each time, and
    each glue counter rises by its launches a forward each time: rope and
    silu * up once a layer (the drafter's rope twice: q with k, then the
    window), add + norm twice a layer and once for the final norm."""
    if which == "middle verify":
        cfg = CARD_TARGET
        params = tl.init_params(cfg, device=dev, seed=3)
        rkv = tcache.init_retrieval(cfg, CARD_SPEC, device=dev)
        rkv.k.copy_(_rand(dev, 1, *rkv.k.shape))
        rkv.v.copy_(_rand(dev, 2, *rkv.v.shape))
        kv_len = torch.full((), 300, dtype=torch.int32, device=dev)
        caches = (rkv.k, rkv.v)

        def forward(ids):
            return (tl.forward_spec(cfg, params, ids, rkv, kv_len,
                                    CARD_SPEC.budget, commit=False)[0],)
        ropes = cfg.num_layers
    else:
        cfg = CARD_DRAFT
        params = tl.init_params(cfg, device=dev, seed=4)
        dkv = tcache.init_streaming(cfg, CARD_SPEC, device=dev)
        dkv.k.copy_(_rand(dev, 1, *dkv.k.shape))
        dkv.v.copy_(_rand(dev, 2, *dkv.v.shape))
        caches = (dkv.k, dkv.v)

        def forward(ids):
            return (tl.draft_forward_spec(cfg, params, ids, dkv, CARD_SPEC,
                                          commit=False)[0],)
        ropes = 2 * cfg.num_layers
    ids = torch.randint(0, cfg.vocab_size, (1, CARD_SPEC.gamma + 1),
                        generator=torch.Generator().manual_seed(0)).to(dev)
    (want,) = forward(ids)
    counters = (tlg.add_rms_norm, tlg.rope, tlg.silu_mul)
    per_forward = (2 * cfg.num_layers + 1, ropes, cfg.num_layers)
    gs = tgraphs.GraphSet(dev, True)
    for call in range(1, 4):
        before = [fn.launches for fn in counters]
        (got,) = gs.run("glue", forward, (ids,), caches=caches)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert [fn.launches - b for fn, b in zip(counters, before)] == \
            list(per_forward)
    assert gs.captures == 1 and gs.replays == 2
