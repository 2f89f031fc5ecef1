"""The judge on the CPU at a tiny size (``tests/data``): the reference
matches the port, a whole run comes out correct, and a run whose timed
path is broken underneath comes out not correct, once for each fault a
cell can have (a step that leaves its state unchanged; a token altered
where it is produced; half of the rows left out of a serving step) and
for an attention kernel that is wrong (B1 or B3 returning zeros, or
reading half of the cache). On a
card, the program's own int8 path, the control the limits were set
against, comes out not correct at each cell's own size.

    python3 -m pytest -q portbench/tests            # the card's test skips
    python3 -m pytest -q -m cuda portbench/tests    # on a card
"""

import json
import os
import subprocess
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
from reference import model  # noqa: E402

SEED = 2**31 + 99


def _run(cell, trace=False):
    return run.execute(cell, SEED, 0.5, trace, "cpu", root=DATA)


def test_reference_matches_the_port_forward():
    from triforce_tpu_torch.cache import init_kv
    from triforce_tpu_torch.models import llama
    cell = harness.Cell.find("tiny.batch1", DATA)
    cfg = cell.model
    tcfg, _, _ = harness.port_configs(cfg)
    gen = torch.Generator().manual_seed(5)
    w = harness.make_weights(cfg, gen, "cpu", dtype=torch.float32)
    ids = torch.randint(3, cfg["vocab_size"], (40,), generator=gen)
    kv = init_kv(tcfg, 64, 1, torch.float32, device="cpu")
    logits, kv, _ = llama.forward_append(tcfg, w, ids[None], kv)
    seen = {}
    ref = model.forward(cfg, w, ids, logits_at=list(range(40)),
                        on_layer=lambda li, q, k, v: seen.update(
                            {li: (k, v)}))
    assert torch.allclose(ref, logits[0], atol=1e-4, rtol=1e-4)
    for li, (k, v) in seen.items():
        assert torch.allclose(k, kv.k[li, 0, :, :40].transpose(0, 1),
                              atol=1e-5)
        assert torch.allclose(v, kv.v[li, 0, :, :40].transpose(0, 1),
                              atol=1e-5)


@pytest.mark.parametrize("cell,trace", [("tiny.batch1", False),
                                        ("tiny.batch1", True),
                                        ("tiny.serve", False),
                                        ("tiny.serve", True)])
def test_sound_run_is_correct(cell, trace):
    out = _run(cell, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert all(v > 0 for v in out["e2e"].values() if v == v)


def _forced(monkeypatch, wrap):
    from triforce_tpu_torch.engine import Engine
    real = Engine.generate_forced

    def patched(self, state, *a, **k):
        return wrap(real, self, state, *a, **k)
    monkeypatch.setattr(Engine, "generate_forced", patched)


def test_step_that_leaves_its_state_unchanged(monkeypatch):
    def wrap(real, eng, state, *a, **k):
        _, buf, n, counters = real(eng, state.clone(), *a, **k)
        return state, buf, n, counters
    _forced(monkeypatch, wrap)
    out = _run("tiny.batch1")
    assert not out["correct"]
    assert out["readings"]["kv_len_gap"] > 0


def test_token_altered_where_produced(monkeypatch):
    vocab = harness.Cell.find("tiny.batch1", DATA).model["vocab_size"]

    def wrap(real, eng, state, *a, **k):
        state, buf, n, counters = real(eng, state, *a, **k)
        buf = buf.clone()
        buf[n // 2] = (buf[n // 2] + 1) % vocab
        return state, buf, n, counters
    _forced(monkeypatch, wrap)
    out = _run("tiny.batch1")
    assert not out["correct"]
    assert out["readings"]["kv_err"] > 0.5


def test_half_of_the_rows_left_out_of_a_serving_step(monkeypatch):
    """From the window's start, half of the rows' tokens never reach
    their requests."""
    from triforce_tpu_torch.batched_spec import BatchedSpecEngine
    backlog = harness.load_module(BENCH_DIR / "traffic" / "backlog.py")
    real_decode, real_cycle = BatchedSpecEngine.decode, backlog._Traffic.cycle
    window = []

    def cycle(self):
        if self.recording:
            window.append(True)
        return real_cycle(self)

    def decode(self, state, steps):
        state, toks, ns, counters, eos = real_decode(self, state, steps)
        if window:
            ns = ns.copy()
            ns[: ns.shape[0] // 2] = 0
        return state, toks, ns, counters, eos
    monkeypatch.setattr(BatchedSpecEngine, "decode", decode)
    monkeypatch.setattr(backlog._Traffic, "cycle", cycle)
    monkeypatch.setattr(harness.Cell, "driver", lambda self: backlog)
    out = _run("tiny.serve")
    assert not out["correct"]
    assert out["readings"]["stalled"] > 0 or \
        out["readings"]["kv_len_gap"] > 0


@pytest.mark.parametrize("cell,kernel", [("tiny.batch1", "append_attention_auto"),
                                         ("tiny.serve", "append_attention_rows")])
@pytest.mark.parametrize("fault", ["zeros", "half_cache"])
def test_attention_kernel_fault(monkeypatch, cell, kernel, fault):
    """B1 (batch 1) or B3 (rows) returns zeros, or reads only the first
    half of each row's cached keys, in every forward of the run."""
    from triforce_tpu_torch.models import llama
    real = getattr(llama, kernel)

    def broken(q, *a, k_len, **k):
        if fault == "zeros":
            return torch.zeros_like(real(q, *a, k_len=k_len, **k))
        return real(q, *a, k_len=torch.div(k_len, 2, rounding_mode="floor")
                    if torch.is_tensor(k_len) else k_len // 2, **k)
    monkeypatch.setattr(llama, kernel, broken)
    out = _run(cell)
    assert not out["correct"]
    limit = harness.Cell.find(cell, DATA).spec["limits"]["kv_err"]
    assert out["readings"]["kv_err"] > limit


BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_is_not_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    p = subprocess.run(
        [sys.executable, str(BENCH_DIR / "run.py"), "--workload", cell,
         "--seed", str(SEED), "--seconds", "10", "--trace", "0",
         "--control", "int8"],
        capture_output=True, text=True, timeout=900, cwd=REPO,
        env=dict(os.environ))
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]
