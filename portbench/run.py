"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs the cell named in ``BENCHMARK.json`` on the first CUDA card: its
traffic driver (``traffic/<driver>.py``) sets up, measures for
``--seconds`` and has the program's output judged against the float32
reference (``reference/``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, each
read by ``metrics/<name>.py``), ``device``, with ``--trace 1``
``breakdown``, ``samples`` (the window's counts behind the metrics),
``readings`` (every reading of the judge, compared or not) and last
``checks``: each compared reading beside its limit, also
printed as the last lines of standard error.

Without a card, or with fewer cards than the cell asks for, it prints no
result and exits with 2. It exits with 3, printing no result, if JAX or
the JAX package was loaded. ``--control int8`` runs the program's own
int8 path (weights and KV) in place of the configuration's precision:
the control that the limits were set against, which must come out not
correct; the benchmark's own runs never pass it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
HERE = Path(__file__).resolve().parent
REPO = HERE.parent
for p in (str(HERE), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)
os.environ["USE_FLAX"] = "0"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(HERE / ".cache" / sub)

import torch  # noqa: E402

import harness  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "triforce_tpu")


@dataclasses.dataclass
class Ctx:
    """What a traffic driver is handed."""
    cell: harness.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    control: bool = False
    t_start: float = T_START

    def since_start(self) -> float:
        """Set-up seconds so far: from the process's start, the device
        synchronised."""
        harness.sync(self.device)
        return time.perf_counter() - self.t_start


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def metrics_of(bench: dict, cell: str, out: dict, trace: bool) -> dict:
    """The cell's end-to-end metrics from the driver's ``e2e``, or its
    per-layer metrics, each from its reader (a reader that finds nothing
    returns None, and the metric is left out)."""
    res = {}
    if not trace:
        for m in bench["end_to_end"]:
            if _applies(m, cell):
                res[m["name"]] = {"value": float(out["e2e"][m["name"]]),
                                  "unit": m["unit"]}
        return res
    for m in bench["per_layer"]:
        if not _applies(m, cell):
            continue
        reader = harness.load_module(HERE / "metrics" / f"{m['name']}.py")
        v = reader.read(out["records"])
        if v is not None and math.isfinite(v):
            res[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return res


def execute(cell: str, seed: int, seconds: float, trace: bool, device,
            control: bool = False, root: Path = HERE) -> dict:
    """One run of ``cell`` on ``device``: the driver's record (no check
    of the device; the command line does that)."""
    c = harness.Cell.find(cell, root)
    ctx = Ctx(c, seed, seconds, trace, torch.device(device), control)
    return c.driver().run(ctx)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("int8",), default=None)
    a = ap.parse_args(argv)
    bench = harness.load_json(REPO / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"]
                  if w["name"] == a.workload), None)
    if entry is None:
        print(f"no cell {a.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry["chips"]:
        print(f"the cell needs {entry['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" found", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    dev = torch.device("cuda", 0)
    out = execute(a.workload, a.seed, a.seconds, bool(a.trace), dev,
                  control=a.control == "int8")
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    device = harness.device_record(dev, entry["chips"])
    device["memory_peak_bytes"] = int(out["memory_peak_bytes"])
    if a.trace:
        device["busy_s"] = float(out["busy_s"])
        device["window_s"] = float(out["window_s"])
    line = {"correct": bool(out["correct"]),
            "attempted": int(out["attempted"]),
            "failed": int(out["failed"]),
            "metrics": metrics_of(bench, a.workload, out, bool(a.trace)),
            "device": device}
    if a.trace and "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["samples"] = out["samples"]
    line["readings"] = {k: float(v) for k, v in out["readings"].items()}
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in out["checks"]}
    for name, v, lim in out["checks"]:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
