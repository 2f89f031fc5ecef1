"""The benchmark's files against its contract, on the CPU: names and
units, every cell's files found by name, every per-layer metric reported
where its end-to-end metric is, the roofline's counts against hand-worked
numbers, and no module of JAX or the JAX package loaded by the harness
or the reference.

    python3 -m pytest -q portbench/tests
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH_DIR = HERE.parent
REPO = BENCH_DIR.parent
sys.path[:0] = [str(BENCH_DIR), str(REPO)]

import harness  # noqa: E402
import roofline  # noqa: E402

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_size():
    assert set(BENCH) == KEYS
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"] == ["python3", "portbench/run.py"]


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_units(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for e in BENCH[group]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and group != "end_to_end" and group != "per_layer":
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
        for k in e.get("reduced", []):
            assert NAME.match(k)


def test_end_to_end_bounds_and_sources():
    names = [e["name"] for e in BENCH["end_to_end"]]
    assert "setup_s" in names
    for e in BENCH["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in BENCH["per_layer"]:
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert e["moves"] in names
        assert 1 <= len(e["layer"]) <= 200 and "\n" not in e["layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    c = harness.Cell.find(cell)
    assert c.spec["config"] == w["config"]
    assert c.spec["traffic"] == w["traffic"]
    assert c.spec["chips"] == w["chips"] == 1
    assert c.spec["why"] == w["why"] and len(w["why"]) <= 200
    cfg = next(x for x in BENCH["configs"] if x["name"] == w["config"])
    assert (REPO / cfg["file"]).is_file()
    assert c.model["source"] == cfg["source"]
    assert c.model["reduced"] == cfg["reduced"]
    assert hasattr(c.driver(), "run")
    assert set(c.spec["limits"]) >= {"kv_len_gap", "kv_err", "rkv_err",
                                     "build_gap"}


def _reports(metric, cell):
    return cell in metric.get("workloads", [w["name"]
                                            for w in BENCH["workloads"]])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_moves_a_metric_of_its_cells(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert (BENCH_DIR / "metrics" / f"{metric}.py").is_file()
    moves = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    for cell in m["workloads"]:
        assert _reports(moves, cell), (metric, cell)
    reader = harness.load_module(BENCH_DIR / "metrics" / f"{metric}.py")
    assert reader.read({}) is None          # nothing to read: nothing


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = [e["name"] for e in BENCH["end_to_end"]
               if _reports(e, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_reports(m, w["name"]) for m in BENCH["per_layer"])


def test_roofline_counts_by_hand():
    m = json.loads((BENCH_DIR / "configs" / "yarn-mistral-7b-128k.json")
                   .read_text())
    # per layer: wq, wo 4096^2; wk, wv 4096 x 1024; 3 x 4096 x 14336
    per_layer = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 3 * 4096 * 14336
    assert roofline.matmul_params(m) == 32 * per_layer + 4096 * 32000
    assert roofline.kv_bytes_per_token(m) == 128 * 1024       # 128 KiB
    flops, nbytes = roofline.forward(m, 8, 1000)
    want_flops = 2 * 7110393856 * 8 + 4 * 32 * 128 * 8 * (1000 + 4.5) * 32
    assert flops == pytest.approx(want_flops)
    assert nbytes == 2 * 7110393856 + 1008 * 128 * 1024
    f, b = roofline.attention_kernel(m, 8, 1000)
    assert f == pytest.approx(4 * 32 * 128 * 8 * 1004.5 * 32)
    assert b == 32 * (2 * 8 * 128 * 2 * 1008 + 2 * 32 * 128 * 8 * 2)
    assert roofline.least_s(989e12, 0) == pytest.approx(1.0)
    # a prefill: each chunk's forward its own least time, summed
    assert roofline.prefill_least_s(m, 20, 8) == pytest.approx(
        roofline.least_s(*roofline.forward(m, 8, 0))
        + roofline.least_s(*roofline.forward(m, 8, 8))
        + roofline.least_s(*roofline.forward(m, 4, 16)))
    assert roofline.least_s(0, 3.35e12) == pytest.approx(1.0)


_PROBE = r"""
import sys
sys.path[:0] = [{bench!r}, {repo!r}]
import run, harness, roofline
from reference import check, model
for cell in {cells!r}:
    c = harness.Cell.find(cell)
    c.driver()
for m in {metrics!r}:
    harness.load_module(harness.HERE / "metrics" / (m + ".py"))
print("ROOTS:" + ",".join(sorted({{k.split(".")[0] for k in sys.modules}})))
"""


def test_no_jax_loaded_by_harness():
    code = _PROBE.format(bench=str(BENCH_DIR), repo=str(REPO),
                         cells=[w["name"] for w in BENCH["workloads"]],
                         metrics=[m["name"] for m in BENCH["per_layer"]])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    roots = set(p.stdout.strip().splitlines()[-1][len("ROOTS:"):].split(","))
    assert not roots & {"jax", "jaxlib", "flax", "triforce_tpu"}


def test_reference_imports_nothing_of_the_program():
    code = (f"import sys; sys.path[:0] = [{str(BENCH_DIR)!r}]\n"
            "from reference import check, model\n"
            "print(','.join(sorted({k.split('.')[0] for k in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    roots = set(p.stdout.strip().split(","))
    assert not roots & {"jax", "jaxlib", "flax", "triforce_tpu",
                        "triforce_tpu_torch", "harness"}
    for f in (BENCH_DIR / "reference").glob("*.py"):
        src = f.read_text()
        assert "triforce_tpu" not in src and "import jax" not in src


def test_command_line_refuses_without_a_card(tmp_path):
    p = subprocess.run(
        [sys.executable, str(BENCH_DIR / "run.py"), "--workload",
         BENCH["workloads"][0]["name"], "--seed", str(2**31 + 7),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert p.stdout.strip() == ""
