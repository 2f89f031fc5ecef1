"""The launch plan of the chunk-score wrappers, on the CPU.

A launch of ``csrc/chunk_scores.cu`` gives each block a run of whole
chunks of one head: block b scores chunks [b * cpb, min((b + 1) * cpb,
C)), and reads the keys of those chunks and no others. The wrappers choose
(cpb, blocks a head) from the shape, the SM count and the kernel's
occupancy (``ops/retrieval_kernel.py``: ``block_plan``, ``plan``): runs of
at most 64 KB of keys, and no fewer blocks than fill a wave. Here the plan,
as the wrappers compute it (the card's SM count and occupancy stubbed), is
held to that contract over the wrappers' envelope: G 1-8, D 64 and 128,
chunk 1-256. The kernel itself, under the wrapper's plan and under others,
is held to the plain version on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import pytest
import torch

from triforce_tpu_torch.ops import retrieval_kernel as trk

# (SMs, CTAs per SM) of cards the plan may meet: an H100 SXM at the
# kernel's 3 CTAs an SM and at 2, an H100 PCIe, a small card
WAVES = [(132, 3), (132, 2), (114, 3), (20, 1)]

# hkv, d, chunk, prefill: the envelope's chunks, one chunk of prefill, a
# ragged last block, both models' builds (Llama2-7B: 32 x 128; TinyLlama:
# 4 x 64) and served prefills, a long prefill and a head count above a
# small card's wave
CASES = [(4, 128, 1, 300), (4, 64, 4, 1000), (4, 128, 8, 2048),
         (4, 64, 16, 512), (4, 128, 256, 8192), (2, 64, 256, 256),
         (1, 128, 8, 8), (32, 128, 8, 8), (4, 64, 3, 999),
         (32, 128, 8, 32768), (4, 64, 8, 32768), (32, 128, 8, 8192),
         (4, 64, 8, 8192), (8, 128, 8, 131072), (40, 64, 4, 4096)]


def row_bytes(d, quant):
    return d * (1 if quant else 2)


def runs(cpb, bph, n_chunks):
    """[first, end) chunks of each of a head's blocks."""
    return [(b * cpb, min((b + 1) * cpb, n_chunks)) for b in range(bph)]


def _plan(monkeypatch, wave, hkv, g, d, chunk, prefill, quant):
    monkeypatch.setattr(trk, "_wave", lambda device, d, quant: wave)
    q = torch.empty((hkv, g, d), dtype=torch.float32)
    return trk.plan(q, chunk, prefill, quant)


@pytest.mark.parametrize("hkv,d,chunk,prefill", CASES)
@pytest.mark.parametrize("quant", [False, True])
def test_every_chunk_in_exactly_one_block(monkeypatch, hkv, d, chunk,
                                          prefill, quant):
    """Each chunk belongs to exactly one block and no block is empty, so
    the blocks' keys are [0, prefill), each once, and none at or past
    prefill."""
    n = prefill // chunk
    for wave in WAVES:
        cpb, bph = _plan(monkeypatch, wave, hkv, 8, d, chunk, prefill, quant)
        assert cpb >= 1 and bph >= 1
        blocks = runs(cpb, bph, n)
        assert all(first < end for first, end in blocks)
        assert [c for first, end in blocks
                for c in range(first, end)] == list(range(n))
        assert [key for first, end in blocks
                for key in range(first * chunk, end * chunk)] \
            == list(range(prefill))


@pytest.mark.parametrize("hkv,d,chunk,prefill", CASES)
@pytest.mark.parametrize("quant", [False, True])
def test_blocks_of_64kb_filling_a_wave(monkeypatch, hkv, d, chunk, prefill,
                                       quant):
    """A block holds at most BLOCK_BYTES of keys (or one chunk). A shorter
    block is as long as the wave asks: one chunk fewer a block would put
    more blocks in the head than its share of one wave, which it fills; a
    block of BLOCK_BYTES is one the wave's share alone would have let be
    longer."""
    n = prefill // chunk
    cap = max(1, trk.BLOCK_BYTES // (row_bytes(d, quant) * chunk))
    for sms, per_sm in WAVES:
        cpb, bph = _plan(monkeypatch, (sms, per_sm), hkv, 1, d, chunk,
                         prefill, quant)
        per_head = max(1, sms * per_sm // hkv)
        assert cpb <= cap
        if cpb < cap:
            assert bph <= per_head
            assert cpb == 1 or -(-n // (cpb - 1)) > per_head
        else:
            assert -(-n // per_head) >= cap


@pytest.mark.parametrize("quant", [False, True])
def test_plan_at_the_build_shapes(monkeypatch, quant):
    """Both models' retrieval builds (prefill 32768, chunk 8) and served
    prefills (8192) on an H100 SXM at the kernel's 3 CTAs an SM: Llama2-7B's
    32 heads take blocks of 64 KB of keys (bf16: 256 keys, 4096 blocks at
    32768, 1024 at 8192; int8: 512 keys, 2048 and 512 blocks), TinyLlama's
    4 heads one wave: 98 blocks of 42 chunks a head (392 of 396 slots), or
    94 of 11 at 8192."""
    want = {32768: (64, 64), 8192: (64, 16)} if quant \
        else {32768: (32, 128), 8192: (32, 32)}
    for prefill, plan in want.items():
        assert _plan(monkeypatch, (132, 3), 32, 1, 128, 8, prefill,
                     quant) == plan
    assert _plan(monkeypatch, (132, 3), 4, 8, 64, 8, 32768, quant) \
        == (42, 98)
    assert _plan(monkeypatch, (132, 3), 4, 8, 64, 8, 8192, quant) \
        == (11, 94)


@pytest.mark.parametrize("g", range(1, 9))
def test_plan_does_not_read_the_group(monkeypatch, g):
    """Every G of the envelope gets the plan of G = 1: the query rows are
    the products' N, padded to 8, and change no block's keys."""
    for d in (64, 128):
        for chunk, prefill in ((1, 300), (8, 32768), (256, 8192)):
            for quant in (False, True):
                assert _plan(monkeypatch, (132, 3), 4, g, d, chunk, prefill,
                             quant) == _plan(monkeypatch, (132, 3), 4, 1, d,
                                             chunk, prefill, quant)


def test_plan_covers_small_heads():
    """block_plan over a dense grid of small heads: for every n_chunks,
    chunk, key row and wave, the blocks cover the head's chunks and the
    last of them is not empty."""
    for sms, per_sm in WAVES:
        for hkv in (1, 3, 32, 300):
            for chunk in (1, 2, 7, 8, 255, 256):
                for rb in (64, 128, 256):
                    for n in range(1, 300, 7):
                        cpb, bph = trk.block_plan(hkv, n, chunk, rb, sms,
                                                  per_sm)
                        assert 1 <= cpb <= n and bph >= 1
                        assert (bph - 1) * cpb < n <= bph * cpb
