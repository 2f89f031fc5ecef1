"""The judge of the cells of a model with sliding-window and expert layers
(``traffic/batch1_forced_moe.py``, ``reference/check_moe.py``) on the CPU
at a tiny size of Mellum2's shape (``tests/data``): the reference matches
the port, a whole run comes out correct, and runs whose timed path is
broken underneath (a sliding layer's ring left stale, an expert's output
halved) come out not correct.

    python3 -m pytest -q portbench/tests
"""

import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
BENCH_DIR = HERE.parent
REPO = BENCH_DIR.parent
DATA = HERE / "data"
sys.path[:0] = [str(BENCH_DIR), str(REPO)]

import harness  # noqa: E402
import run  # noqa: E402
from reference import moe_window  # noqa: E402

SEED = 2**31 + 101
CELL = "tiny.moe"


def _run(trace=False):
    return run.execute(CELL, SEED, 0.5, trace, "cpu", root=DATA)


def test_reference_matches_the_port_forward():
    from triforce_tpu_torch.cache import init_kv
    from triforce_tpu_torch.models import llama
    cell = harness.Cell.find(CELL, DATA)
    drv = cell.driver()
    cfg = cell.model
    tcfg, _, _ = drv.port_configs(cfg)
    gen = torch.Generator().manual_seed(5)
    w = drv.make_weights(cfg, gen, "cpu", dtype=torch.float32)
    ids = torch.randint(3, cfg["vocab_size"], (40,), generator=gen)
    kv = init_kv(tcfg, 64, 1, torch.float32, device="cpu", ring_slack=8)
    parts = []
    for s in range(0, 40, 8):
        out, kv, _ = llama.forward_append(tcfg, w, ids[None, s:s + 8], kv)
        parts.append(out[0])
    logits = torch.cat(parts)
    seen = {}
    ref = moe_window.forward(cfg, w, ids, logits_at=list(range(40)),
                             on_layer=lambda li, q, k, v: seen.update(
                                 {li: (k, v)}))
    assert torch.allclose(ref, logits, atol=1e-4, rtol=1e-4)
    full = torch.stack([seen[li][0] for li in tcfg.plan.full])
    assert torch.allclose(full, kv.k[:, 0, :, :40].transpose(1, 2),
                          atol=1e-5)


def test_sound_run_is_correct():
    out = _run(trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["records"]["moe"]["window"]["target"][2] > 0


def test_stale_ring_is_not_correct(monkeypatch):
    """The sliding layers' rings written by the prefill chunks only:
    every verify reads stale keys."""
    from triforce_tpu_torch.models import llama
    real = llama._ring_attention

    def stale(cfg, q, k_new, v_new, ring, si, k_len, positions,
              commit_idx=None):
        chunk = k_new.shape[2] == 8
        return real(cfg, q, k_new, v_new, ring, si, k_len, positions,
                    commit_idx if chunk else None)
    monkeypatch.setattr(llama, "_ring_attention", stale)
    out = _run()
    assert not out["correct"]
    assert out["readings"]["kv_err"] > 0.5


def test_halved_expert_output_is_not_correct(monkeypatch):
    from triforce_tpu_torch.ops import moe
    real = moe.combine_plain
    monkeypatch.setattr(moe, "combine_plain", lambda y, w: real(y, w / 2))
    out = _run()
    assert not out["correct"]


@pytest.mark.parametrize("kind,tokens", [("prefill", 8), ("middle", 4)])
def test_expert_dropped_in_one_forward_kind_is_not_correct(monkeypatch,
                                                           kind, tokens):
    """Every token's last expert dropped in the forwards of one width
    only (the tiny cell's 8-token prefill chunks, its 4-token middle
    verifies): the caches and the target verify cannot see it, that
    kind's own expert reading does."""
    from triforce_tpu_torch.ops import moe
    real = moe.experts

    def dropping(h, idx, w, *rest):
        if h.shape[0] == tokens:
            w = torch.cat([w[:, :-1], torch.zeros_like(w[:, -1:])], 1)
        return real(h, idx, w, *rest)
    monkeypatch.setattr(moe, "experts", dropping)
    out = _run()
    assert not out["correct"]
    assert out["readings"][f"moe_err_{kind}"] > 0.02
    assert out["readings"]["moe_err"] <= 0.02


def test_int8_expert_control_is_not_correct():
    """The control the limits were set against: the program on every
    matrix, the experts' included, rounded to per-channel int8 and back
    (``--control int8``); each forward kind's expert reading catches
    it."""
    out = run.execute(CELL, SEED, 0.5, False, "cpu", control=True,
                      root=DATA)
    assert not out["correct"]
    for name in ("moe_err", "moe_err_middle", "moe_err_prefill"):
        assert out["readings"][name] > 0.02, name
