"""The benchmark's cells run under the port's tracer (``profiling.tracing``),
one run a process, for the numbers a cell's per-layer metrics would read
from the trace: the step split into verify, middle, draft and the rest,
the live slots and the admission's device share, the named idle gaps and
the clock, beside what the harness measures from outside.

    python3 probes/torch_trace_cells.py --workload <cell> --seed <n> \
        --seconds 30 --mode traced|on|off [--chrome] [--judge]

``--mode traced``: the harness's traced run (``--trace 1``: CUDA events
around every replay, ``measure_phase_times`` and the eager witness after
the window) with a trace opened before the engine's first capture, so
every graph holds its stamps; the trace is marked at the window's start
and closed at its end (the harness's ``ReplayClock`` enters and leaves
there), before the phase table and the witness. ``on``: an untraced run
(the end-to-end metrics) with the trace opened and closed as in
``traced``; ``off``: an untraced run with no trace. Pair ``on`` and
``off`` on one seed (on, off, off, on) for the cost of tracing. The
judge (the float32 reference) is skipped unless ``--judge``: these runs
measure time, and their ``correct`` is not reported.

The last line of standard output is one JSON object; with ``--out`` it
is also written there, and ``--chrome`` writes the trace's Chrome file
beside it. ``--root portbench/tests/data --workload tiny.batch1 --device
cpu`` rehearses on the CPU (host clocks; not device numbers).
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "portbench"
sys.path[:0] = [str(BENCH), str(ROOT)]

import torch  # noqa: E402

import harness  # noqa: E402
import run as bench_run  # noqa: E402
from reference import check, check_moe  # noqa: E402

from triforce_tpu_torch import profiling  # noqa: E402


class _Window:
    """Marks the trace at the harness's window (``ReplayClock`` is
    entered right before it and left right after it) and closes the
    trace there; in the window, the host time of every
    ``CUDAGraph.replay`` call (the graph's launch, which ``ReplayClock``'s
    events bracket with it)."""

    def __init__(self, device):
        self.cm = profiling.tracing(device)
        self.trace = self.cm.__enter__()
        self.closed = False
        self.launch_ns = []
        enter, leave = harness.ReplayClock.__enter__, \
            harness.ReplayClock.__exit__
        replay = torch.cuda.CUDAGraph.replay
        win = self

        def timed(graph):
            t0 = time.perf_counter_ns()
            replay(graph)
            win.launch_ns.append(time.perf_counter_ns() - t0)

        def entered(clock):
            win.trace.mark("window_start")
            torch.cuda.CUDAGraph.replay = timed
            return enter(clock)

        def left(clock, *exc):
            out = leave(clock, *exc)
            torch.cuda.CUDAGraph.replay = replay
            win.trace.mark("window_end")
            win.close()
            return out

        harness.ReplayClock.__enter__ = entered
        harness.ReplayClock.__exit__ = left

    def close(self):
        if not self.closed:
            self.closed = True
            self.cm.__exit__(None, None, None)


def _skip_judge():
    def judge(m, weights, ids, prog):
        return dict(kv_len_gap=0.0, kv_err=0.0, rkv_err=0.0, build_gap=0.0,
                    logit_err=0.0)
    check.judge = check_moe.judge = judge


def _metrics(summary: dict, rec: dict) -> dict:
    """What the per-layer metrics of the trace would read: the step split
    (``.decode`` in batch-1 cells, ``.serve`` in serving), and in a
    hybrid model's cell the device ms a step spends in its expert layers
    and its sliding-window attention (the ``moe`` and ``window_attn``
    regions inside the forwards), the live slots and the admission's
    device share."""
    kind = "serve" if "serve" in rec else "decode"
    out = {}
    split = summary.get("step")
    if split:
        for part in ("verify", "middle", "draft", "rest"):
            out[f"step_{part}_ms.{kind}"] = split[part + "_ms"]
        for part in ("moe", "window_attn"):
            reg = summary["regions"].get(part)
            if reg and split["steps"]:
                out[f"step_{part}_ms.{kind}"] = reg["ms"] / split["steps"]
    for key, name in (("live_slot_pct", "live_slot_pct.serve"),
                      ("admit_device_pct", "admit_device_pct.serve")):
        if key in summary:
            out[name] = summary[key]
    return out


def _checks(summary: dict, rec: dict) -> dict:
    """The trace held against the run's own counts: steps and middle
    verifies (batch-1), and the window's wall against the steps' device
    time plus the stamped gaps."""
    out = {}
    split, idle = summary.get("step"), summary["idle"]
    wall_ms = 1e3 * summary["window_s"]
    out["stamped_plus_gaps_over_wall"] = (idle["busy_ms"] + idle["gap_ms"]) \
        / wall_ms
    if split:
        covered = split["steps"] * split["step_ms"]
        out["step_share_of_wall"] = covered / wall_ms
        loop = summary["regions"].get("loop")
        if loop:      # the batch-1 loop's turns, less the steps in them
            out["loop_outside_steps_ms"] = loop["ms"] - covered
            out["loop_turns"] = loop["count"]
    d = rec.get("decode")
    if d and split:
        out["step_regions"] = split["steps"]
        out["steps_counted"] = d["steps"]
        out["trace_steps_counter"] = summary["counters"].get("steps")
        out["middle_regions"] = split["middle_count"]
        out["mid_verify_counted"] = d["mid_verify"]
        out["draft_regions"] = split["draft_count"]
        out["mid_draft_plus_steps"] = d["mid_draft"] + d["steps"]
    if "phase_ms" in rec and split:
        out["verify_vs_phase_table"] = split["verify_ms"] \
            / rec["phase_ms"]["target_verify"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--mode", choices=("traced", "on", "off"),
                    required=True)
    ap.add_argument("--root", default=str(BENCH))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--judge", action="store_true")
    ap.add_argument("--chrome", action="store_true")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    dev = torch.device(a.device)
    if dev.type == "cuda":
        torch.set_num_threads(4)
        dev = torch.device("cuda", 0)
    if not a.judge:
        _skip_judge()
    win = _Window(dev) if a.mode != "off" else None
    t0 = time.perf_counter()
    try:
        out = bench_run.execute(a.workload, a.seed, a.seconds,
                                a.mode == "traced", dev, root=Path(a.root))
    finally:
        if win is not None:
            win.close()
    rec = out["records"]
    line = {"workload": a.workload, "seed": a.seed, "mode": a.mode,
            "e2e": out["e2e"], "samples": out["samples"],
            "run_s": time.perf_counter() - t0}
    if dev.type == "cuda":
        line["device"] = harness.device_record(dev, 1)
    if a.judge:
        line["correct"] = bool(out["correct"])
    for key in ("decode", "serve", "phase_ms"):
        if key in rec:
            line[key] = {k: v for k, v in rec[key].items() if k != "cycles"} \
                if isinstance(rec[key], dict) else rec[key]
    if a.mode == "traced":
        line["busy_s"], line["window_s"] = out["busy_s"], out["window_s"]
        line["replay_gaps"] = out["breakdown"]["idle_gaps"]
    if win is not None and win.launch_ns:
        ns = sorted(win.launch_ns)
        line["replay_launch_us"] = {
            "count": len(ns), "median": ns[len(ns) // 2] / 1e3,
            "p90": ns[int(0.9 * len(ns))] / 1e3, "max": ns[-1] / 1e3}
    if win is not None:
        s = win.trace.summary()
        line["trace"] = s
        line["metrics"] = _metrics(s, rec)
        line["checks"] = _checks(s, rec)
    text = json.dumps(line, default=str)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            f.write(text + "\n")
        if a.chrome and win is not None:
            win.trace.export_chrome(os.path.splitext(a.out)[0]
                                    + ".chrome.json")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
