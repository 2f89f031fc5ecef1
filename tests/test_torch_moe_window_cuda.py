"""The hybrid path's kernels against their plain versions, on a card: the
router and the expert kernel (``csrc/moe.cu``), the prefill chunks'
grouped GEMM, and B1 over a sliding-window layer's ring
(``tf_flash_decode_window_bf16``). Every test is marked ``cuda`` and skips
without a card; this file imports only torch and the port:

    python -m pytest -m cuda tests/test_torch_moe_window_cuda.py

Shapes are Mellum2-12B-A2.5B's (hidden 2304, 64 experts of 896, top 8;
32 query and 4 KV heads of 128, window 1024 on a 1536-slot ring) at the
token counts the engine runs: AR 1, middle 7, verify 8, a 512-token
prefill chunk.
"""

import pytest
import torch

from triforce_tpu_torch.ops import flash_decode as tfd
from triforce_tpu_torch.ops import moe

pytestmark = pytest.mark.cuda

H, E, I, K = 2304, 64, 896, 8
WINDOW, RING, HKV, G, D = 1024, 1536, 4, 8, 128


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(dev, seed, *shape, std=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * std).to(
        torch.bfloat16)


def _experts(dev, seed=0):
    return (_randn(dev, seed, E, H, std=H ** -0.5),
            _randn(dev, seed + 1, E, I, H, std=H ** -0.5),
            _randn(dev, seed + 2, E, I, H, std=H ** -0.5),
            _randn(dev, seed + 3, E, H, I, std=I ** -0.5))


def _routing(dev, n, kind, seed=0):
    """ids [n, K] int32 and weights [n, K] fp32: "router" (the kernel's
    own, from random h), "skewed" (every token's experts from the first
    12), "one" (expert 5 in every token's first slot, the rest spread)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pool = 12 if kind == "skewed" else E
    ids = torch.stack([torch.randperm(pool, generator=g, device=dev)[:K]
                       for _ in range(n)])
    if kind == "one":
        ids = torch.where(ids == 5, ids[:, :1], ids)
        ids[:, 0] = 5
    w = torch.rand((n, K), generator=g, device=dev)
    return ids.to(torch.int32), w / w.sum(-1, keepdim=True)


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.parametrize("n", [1, 7, 8, 64, 512])
def test_router_matches_plain(dev, n):
    """The router's ids equal the plain version's except where two
    probabilities lie within fp32 summation noise of each other (the
    kernel sums the logit's products in another order); weights within
    fp32 rounding."""
    wr = _experts(dev)[0]
    h = _randn(dev, 10 + n, n, H)
    sink = torch.zeros(3, dtype=torch.int64, device=dev)
    with moe.counting(sink):
        ids, w = moe.route(h, wr, K)
    pids, pw = moe.route_plain(h, wr, K)
    p = torch.softmax(h.float() @ wr.float().T, -1).sort(-1, True).values
    clear = (p[:, :K] - p[:, 1:K + 1]).min(-1).values > 1e-5
    assert torch.equal(ids[clear], pids[clear])
    assert (w[clear] - pw[clear]).abs().max().item() < 1e-5
    assert sink.tolist() == [0, n * K, 1]


@pytest.mark.parametrize("n,kind", [(1, "router"), (7, "router"),
                                    (8, "router"), (8, "skewed"),
                                    (8, "one"), (64, "one"), (64, "skewed"),
                                    (512, "router"), (512, "skewed")])
def test_experts_match_plain(dev, n, kind):
    """The expert kernel (n <= 64) and the grouped GEMM (512) against the
    plain version on the same ids and weights: each sums its dot products
    in another fp32 order before the same bf16 roundings, so an output
    moves by an ulp of bf16 here and there (relative norm well under
    bf16's 2^-8); the counter reads the distinct experts."""
    wr, wg, wu, wd = _experts(dev)
    h = _randn(dev, 20 + n, n, H)
    ids, w = _routing(dev, n, kind)
    sink = torch.zeros(3, dtype=torch.int64, device=dev)
    with moe.counting(sink):
        out = moe.experts(h, ids, w, wg, wu, wd)
    want = moe.combine_plain(moe.expert_outputs_plain(h, ids, wg, wu, wd), w)
    torch.cuda.synchronize()
    assert _rel(out, want) < 2e-3
    assert sink[0].item() == torch.unique(ids).numel()


def test_experts_replay_in_a_graph_bit_for_bit(dev):
    """Captured once, the expert kernel replays new routing correctly and
    repeats its bits: a fixed grid, no float atomics."""
    wr, wg, wu, wd = _experts(dev)
    h = _randn(dev, 30, 8, H)
    ids, w = _routing(dev, 8, "router", seed=1)
    moe.experts(h, ids, w, wg, wu, wd)          # warm up outside capture
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = moe.experts(h, ids, w, wg, wu, wd)
    for seed in (2, 3):
        new_ids, new_w = _routing(dev, 8, "skewed", seed=seed)
        ids.copy_(new_ids)
        w.copy_(new_w)
        g.replay()
        first = out.clone()
        g.replay()
        assert torch.equal(out, first)
        want = moe.combine_plain(moe.expert_outputs_plain(h, ids, wg, wu,
                                                          wd), w)
        assert _rel(out, want) < 2e-3


@pytest.mark.parametrize("tokens", [1, 7, 8, 512])
@pytest.mark.parametrize("length", [1023, 1024, 1536, 1600, 122880])
def test_window_b1_over_a_ring_matches_plain(dev, tokens, length):
    """B1's window kernel over a 1536-slot ring holding a sequence of
    ``length`` tokens (wrapped from 1537 on; stale slots hold large
    values that must never be read) against the plain version: the decode
    path at 1 token (GT 8), the wide path at 7, 8 and a 512-token chunk."""
    if tokens > RING - WINDOW:
        pytest.skip("a forward appends at most the ring's slack")
    q = _randn(dev, 0, HKV, G * tokens, D)
    kn, vn = _randn(dev, 1, HKV, tokens, D), _randn(dev, 2, HKV, tokens, D)
    k, v = _randn(dev, 3, HKV, RING, D), _randn(dev, 4, HKV, RING, D)
    live = torch.arange(RING, device=dev)
    age = torch.remainder(length - 1 - live, RING)
    stale = (live >= length) | (age > WINDOW - 2)
    k[:, stale] = 30.0
    kl = torch.tensor(length, dtype=torch.int32, device=dev)
    mask = tfd.causal_mask(tokens, tokens, G, dev)
    before = tfd.flash_decode_window.launches
    out = tfd.flash_decode_window(q, k, v, kn, vn, kl, mask, WINDOW)
    ref = tfd.flash_decode_append_plain(q, k, v, kn, vn, kl, mask,
                                        window=WINDOW)
    torch.cuda.synchronize()
    assert tfd.flash_decode_window.launches == before + 1
    tol = 0.05 / (min(length, WINDOW) + tokens) ** 0.5   # as B1's tests
    assert (out - ref).abs().max().item() <= tol
