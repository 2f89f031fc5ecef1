"""The split plan of the flash-decode wrappers, on the CPU.

A launch splits each row's live prefix [0, k_len) over ``nsplit`` CTAs of
phase 1 (``csrc/flash_decode.cu``: ``split_share``); phase 2 merges the
partials those CTAs wrote. The wrappers choose nsplit from the shape alone
(``ops/flash_decode.py``: ``_plan``), and the kernel reads k_len on the
card, so the plan has to hold for every k_len a launch may meet. Here the
plan, as the wrappers compute it (the card's SM count and occupancy
stubbed), and a mirror of ``split_share`` are held to that contract over a
grid of shapes and lengths.
"""

import pytest
import torch

from triforce_tpu_torch.ops import flash_decode as tfd

KT = 64   # keys per tile of phase 1: each split's share is a multiple

# (SMs, CTAs per SM) of cards the plan may meet: an H100 SXM at the decode
# kernel's D = 128 and D = 64 occupancy, an H100 PCIe, a small card
WAVES = [(132, 2), (132, 4), (114, 2), (20, 1)]
LENGTHS = (0, 1, 37, 64, 4133)
CACHES = (64, 1100, 4103, 32928, 131072)


def split_share(klen, s, nsplit):
    """Mirror of the kernel's ``split_share``: the live length clamped into
    [0, s] and the keys each split takes (a multiple of KT)."""
    klen = min(max(klen, 0), s)
    p = -(-klen // nsplit)
    return klen, -(-p // KT) * KT


def _plan(monkeypatch, wave, hkv, gt, s, quant=False, d=128):
    """nsplit and partials per row as ``_plan`` computes them on a card of
    the given (SMs, CTAs per SM)."""
    monkeypatch.setattr(tfd, "_wave", lambda device, d, quant: wave)
    monkeypatch.setattr(tfd, "_n_parts", lambda gt, nsplit: nsplit)
    q = torch.empty((hkv, gt, d), dtype=torch.bfloat16)
    return tfd._plan(q, s, quant)


@pytest.mark.parametrize("hkv,gt", [(1, 1), (4, 8), (8, 16), (32, 1),
                                    (32, 7), (32, 8), (32, 16), (40, 1),
                                    (64, 4), (32, 17), (32, 22), (32, 128),
                                    (8, 512)])
def test_every_key_in_exactly_one_split(monkeypatch, hkv, gt):
    """Every key of [0, k_len) belongs to exactly one split, the splits
    past the live length are empty, and phase 1 writes partials
    0 .. live - 1, all within the scratch's n_parts, which phase 2 reads
    back by the same arithmetic."""
    for wave in WAVES:
        for s in CACHES:
            nsplit, parts = _plan(monkeypatch, wave, hkv, gt, s)
            assert 1 <= nsplit <= parts
            for k_len in LENGTHS + (s - 1, s, s + 5):
                klen, per = split_share(k_len, s, nsplit)
                assert per % KT == 0
                shares = [(i * per, min(klen, (i + 1) * per))
                          for i in range(nsplit)]
                written = [i for i, (b, e) in enumerate(shares) if b < e]
                # contiguous, disjoint, covering [0, klen)
                assert sum(e - b for b, e in shares if b < e) == klen
                assert all(shares[i][1] == shares[i + 1][0]
                           for i in written[:-1])
                assert not written or (shares[written[0]][0] == 0
                                       and shares[written[-1]][1] == klen)
                # the live splits come first; the rest are empty
                live = 0 if klen == 0 else -(-klen // per)
                assert written == list(range(live))
                assert live <= parts


@pytest.mark.parametrize("wave", WAVES)
def test_decode_plan_fills_one_wave(monkeypatch, wave):
    """GT <= 16: all splits of one row's heads run in one wave of the card,
    and no more splits would fit, unless the cache is too short to give
    each split 256 keys."""
    sms, per_sm = wave
    for hkv in (1, 4, 8, 32, 40, 64, 300):
        for gt in (1, 7, 16):
            for s in CACHES:
                nsplit, _ = _plan(monkeypatch, wave, hkv, gt, s)
                short = nsplit == -(-s // 256)
                if hkv <= sms * per_sm:
                    assert hkv * nsplit <= sms * per_sm
                    assert short or hkv * (nsplit + 1) > sms * per_sm
                else:
                    assert nsplit == 1


@pytest.mark.parametrize("hkv,gt,s", [(32, 17, 32928), (32, 128, 32928),
                                      (32, 512, 16384), (32, 22, 4246),
                                      (4, 4096, 4200)])
def test_wide_plan_is_unchanged(monkeypatch, hkv, gt, s):
    """GT > 16 keeps the wide path's rule: about four CTAs per SM of an
    H100's 132, each split at least 256 keys, at most 64 splits; the card's
    occupancy is not consulted."""
    want = max(1, min(-(-4 * 132 // (hkv * -(-gt // 64))), -(-s // 256), 64))
    for wave in WAVES:
        assert _plan(monkeypatch, wave, hkv, gt, s) == (want, want)


class _Entry:
    """A stand-in for a C entry point: records its arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("gt,tn", [(1, 1), (7, 7), (16, 16), (17, 17)])
@pytest.mark.parametrize("quant", [False, True])
def test_plan_does_not_depend_on_the_batch(monkeypatch, gt, tn, quant):
    """The row-batched launch splits each row as the single-row launch
    splits it, whatever B is: the nsplit each passes its entry point."""
    monkeypatch.setattr(tfd, "_wave", lambda device, d, quant: (132, 2))
    monkeypatch.setattr(tfd, "_n_parts", lambda gt, nsplit: nsplit)
    monkeypatch.setattr(tfd, "_stream", lambda device: 0)
    hkv, s, d = 8, 4103, 64
    cache = torch.int8 if quant else torch.bfloat16
    bf = torch.bfloat16
    scales = (0, 0, 0, 0) if quant else ()
    one = _Entry()
    tfd._launch(one, torch.zeros(hkv, gt, d, dtype=bf),
                torch.zeros(hkv, s, d, dtype=cache),
                torch.zeros(hkv, s, d, dtype=cache),
                torch.zeros(hkv, tn, d, dtype=bf),
                torch.zeros(hkv, tn, d, dtype=bf),
                torch.tensor(5, dtype=torch.int32),
                torch.ones(gt, tn, dtype=torch.bool), scales=scales)
    part = _Entry()
    tfd._launch_partials(part, torch.zeros(hkv, gt, d, dtype=bf),
                         torch.zeros(hkv, s, d, dtype=cache),
                         torch.zeros(hkv, s, d, dtype=cache),
                         torch.tensor(5, dtype=torch.int32), scales=scales)
    nsplit = one.calls[0][-3]
    assert part.calls[0][-3] == nsplit
    for bsz in (1, 2, 5):
        rows = _Entry()
        tfd._launch_batched(
            rows, torch.zeros(bsz, hkv, gt, d, dtype=bf),
            torch.zeros(bsz, hkv, s, d, dtype=cache),
            torch.zeros(bsz, hkv, s, d, dtype=cache),
            torch.zeros(bsz, hkv, tn, d, dtype=bf),
            torch.zeros(bsz, hkv, tn, d, dtype=bf),
            torch.full((bsz,), 5, dtype=torch.int32),
            torch.ones(bsz, gt, tn, dtype=torch.bool),
            scales=(0, 0, 0, 0, 0, 0) if quant else ())
        assert rows.calls[0][0] == bsz and rows.calls[0][-3] == nsplit
