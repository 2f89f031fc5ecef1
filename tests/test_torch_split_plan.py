"""The split plan of the flash-decode wrappers, on the CPU.

A launch splits each row's live prefix [0, k_len) over ``nsplit`` CTAs of
phase 1 (``csrc/flash_decode.cu``: ``split_share``); phase 2 merges the
partials those CTAs wrote. The wrappers choose nsplit from the shape alone
(``ops/flash_decode.py``: ``_plan``), and the kernel reads k_len on the
card, so the plan has to hold for every k_len a launch may meet. Here the
plan, as the wrappers compute it (the card's SM count and occupancy
stubbed), and mirrors of ``split_share`` and of the wide path's grid are
held to that contract over a grid of shapes and lengths.
"""

import itertools

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


def n_parts(gt, nsplit):
    """Mirror of the kernel's ``n_parts``: one partial per split on both
    paths."""
    return nsplit


def _plan(monkeypatch, wave, hkv, gt, s, quant=False, d=128, rows=None,
          cta_rows=128):
    """nsplit and partials per row as ``_plan`` computes them on a card of
    the given (SMs, CTAs per SM) whose library gives a wide CTA
    ``cta_rows`` query rows; ``rows``: a batch of that many rows."""
    monkeypatch.setattr(tfd, "_wave", lambda device, d, quant, gt=1: wave)
    monkeypatch.setattr(tfd, "_n_parts", n_parts)
    monkeypatch.setattr(tfd, "_cta_rows", lambda gt: cta_rows)
    shape = (hkv, gt, d) if rows is None else (rows, hkv, gt, d)
    return tfd._plan(torch.empty(shape, dtype=torch.bfloat16), s, quant)


def _splits(k_len, s, nsplit):
    """The [begin, end) share of each split of a row at ``k_len``."""
    klen, per = split_share(k_len, s, nsplit)
    return klen, [(i * per, min(klen, (i + 1) * per)) for i in range(nsplit)]


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


@pytest.mark.parametrize("hkv,gt,s", [(32, 17, 32928), (32, 22, 4246),
                                      (32, 64, 4113), (32, 65, 32928),
                                      (32, 128, 32928), (32, 512, 16384),
                                      (4, 4096, 16896), (1, 4096, 64)])
def test_wide_plan_covers_once_and_fills_whole_waves(monkeypatch, hkv, gt, s):
    """GT > 16: every key of [0, k_len) is in exactly one cache split and
    every query row in exactly one q tile, whose one phase-2 CTA folds the
    whole new block in (so each new token is covered once per row); the
    splits of all q tiles and heads of a row fill whole waves of the card's
    occupancy (one split each when they outnumber a wave), each at least
    256 keys, at most 64; and the plan is the same for a batch of rows.
    For either q tile the library may give a CTA (64 or 128 rows)."""
    for rows, wave in itertools.product((64, 128), WAVES):
        qtiles = -(-gt // rows)
        cover = [0] * gt
        for qt in range(qtiles):
            for r in range(qt * rows, min(gt, (qt + 1) * rows)):
                cover[r] += 1
        assert cover == [1] * gt
        nsplit, parts = _plan(monkeypatch, wave, hkv, gt, s, cta_rows=rows)
        # phase 1's grid (q tiles, nsplit, heads) writes one partial per
        # split; phase 2's (q tiles, 1, heads) reads them all
        assert 1 <= nsplit <= 64 and parts == nsplit
        tiles, full = hkv * qtiles, wave[0] * wave[1]
        capped = nsplit in (-(-s // 256), 64)
        if tiles <= full:
            assert tiles * nsplit <= full
            assert capped or tiles * (nsplit + 1) > full
        else:
            assert nsplit == 1
        for k_len in LENGTHS + (s - 1, s, s + 5):
            klen, shares = _splits(k_len, s, nsplit)
            keys = [0] * klen
            for b, e in shares:
                for j in range(b, e):
                    keys[j] += 1
            assert keys == [1] * klen
        for bsz in (1, 3):
            assert _plan(monkeypatch, wave, hkv, gt, s, rows=bsz,
                         cta_rows=rows) == (nsplit, parts)


class _Entry:
    """A stand-in for a C entry point: records its arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("gt,tn", [(1, 1), (7, 7), (16, 16), (17, 17),
                                   (128, 128)])
@pytest.mark.parametrize("quant", [False, True])
def test_plan_does_not_depend_on_the_batch(monkeypatch, gt, tn, quant):
    """The row-batched launch splits each row as the single-row launch
    splits it, whatever B is: the nsplit each passes its entry point."""
    monkeypatch.setattr(tfd, "_wave", lambda device, d, quant, gt=1: (132, 2))
    monkeypatch.setattr(tfd, "_n_parts", n_parts)
    monkeypatch.setattr(tfd, "_cta_rows", lambda gt: 128)
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
