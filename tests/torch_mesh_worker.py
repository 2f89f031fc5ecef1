"""Helpers for the port's multi-rank tests (``test_torch_sp_attention.py``,
``test_torch_sharding.py``, ``test_torch_sharded_engine.py``,
``test_torch_sharded_rows_tree.py``, ``test_torch_cli.py``); not collected
by pytest.

Two ways to run ranks of a ``triforce_tpu_torch.parallel.mesh.Mesh``:

* ``ThreadMesh`` / ``run_threads``: the ranks as threads of the test
  process, with an ``all_reduce`` that stacks every rank's tensor and
  takes its max or sum (the same order on every rank, so every rank gets
  the same bits). It stands in for the collective wherever a test drives
  the module functions directly.
* ``launch``: the ranks as processes over gloo, ``torchrun``'s way (the
  ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``
  environment): each runs this file as a script on a job written to JSON,
  writes its results to ``<out>.<rank>.json`` and exits. Workers import
  nothing of JAX; the parent computes the JAX references. Every process
  group has a timeout of its own, and so has every ``communicate``, so a
  hang fails the test.

Run as a worker: ``python tests/torch_mesh_worker.py JOB.json``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 120
RUN_TIMEOUT_S = 300


# ---------------------------------------------------------------------------
# Ranks as threads
# ---------------------------------------------------------------------------

class _Hub:
    def __init__(self, shape):
        self.shape = shape
        self.lock = threading.Lock()
        self.groups = {}

    def group(self, key, n):
        with self.lock:
            if key not in self.groups:
                self.groups[key] = (threading.Barrier(n, timeout=60), {})
            return self.groups[key]


class ThreadMesh:
    """One rank of a (dp, tp, sp) mesh whose ranks are threads."""

    def __init__(self, hub: _Hub, coords: dict, device="cpu"):
        self.hub = hub
        self.shape = dict(hub.shape)
        self.coords = dict(coords)
        self.device = torch.device(device)

    def index(self, axis):
        return self.coords[axis]

    def all_reduce(self, x, axis, op="sum"):
        assert x.is_contiguous()
        others = tuple((a, c) for a, c in sorted(self.coords.items())
                       if a != axis)
        barrier, store = self.hub.group((axis, others), self.shape[axis])
        store[self.coords[axis]] = x.clone()
        barrier.wait()
        vals = torch.stack([store[i] for i in range(self.shape[axis])])
        out = vals.amax(0) if op == "max" else vals.sum(0)
        barrier.wait()          # every rank has read before the next call
        x.copy_(out)
        return x


def run_threads(fn, tp=1, sp=1, dp=1):
    """``fn(mesh)`` on every rank of a dp x tp x sp mesh of threads;
    returns the results in rank order (row-major, sp fastest)."""
    hub = _Hub(dict(dp=dp, tp=tp, sp=sp))
    out, errs = {}, []

    def one(r):
        mesh = ThreadMesh(hub, dict(dp=r // (tp * sp), tp=(r // sp) % tp,
                                    sp=r % sp))
        try:
            out[r] = fn(mesh)
        except BaseException as e:          # reported in the caller
            errs.append(e)
            for b, _ in hub.groups.values():
                b.abort()

    n = dp * tp * sp
    threads = [threading.Thread(target=one, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    if errs:
        raise errs[0]
    assert len(out) == n, "a rank thread did not finish"
    return [out[r] for r in range(n)]


# ---------------------------------------------------------------------------
# Ranks as processes
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(job: dict, nproc: int, tmp_path, env_extra=None):
    """Run ``job`` on ``nproc`` gloo ranks (processes of this file); returns
    each rank's result dict."""
    path = os.path.join(str(tmp_path), "job.json")
    out = os.path.join(str(tmp_path), "result")
    with open(path, "w") as f:
        json.dump(dict(job, out=out), f)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, WORLD_SIZE=str(nproc),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               **(env_extra or {}))
    procs = []
    for r in range(nproc):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), path],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RUN_TIMEOUT_S)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    res = []
    for r in range(nproc):
        with open(f"{out}.{r}.json") as f:
            res.append(json.load(f))
    return res


def shared(tmp_path_factory, name: str, make):
    """``make(directory)`` (JSON-able) once per test session, whichever
    pytest-xdist workers ask for it: the first computes it under a file
    lock in the session's directory, the others read it back."""
    from filelock import FileLock
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent                  # the session's, not the worker's
    path = base / f"{name}.json"
    with FileLock(str(path) + ".lock"):
        if path.is_file():
            return json.loads(path.read_text())
        work = base / name
        work.mkdir(exist_ok=True)
        data = make(work)
        path.write_text(json.dumps(data))
    return data


def save_params(path, **trees) -> None:
    """Params pytrees (numpy leaves) into one .npz, each under its prefix
    (``t=`` target, ``d=`` drafter), as ``_engine`` reads them."""
    flat = {}
    for prefix, tree in trees.items():
        for k, v in tree.items():
            if isinstance(v, dict):
                flat.update({f"{prefix}.{k}.{n}": np.asarray(w)
                             for n, w in v.items()})
            else:
                flat[f"{prefix}.{k}"] = np.asarray(v)
    np.savez(path, **flat)


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------

def _tokens(x):
    return [int(t) for t in x]


def _case_attention(mesh, job, case):
    """One rank's sharded attention over its shard of the saved inputs:
    returns its heads of the output."""
    from triforce_tpu_torch.ops.sp_attention import append_attention_sharded
    data = np.load(case["inputs"])
    tp, sp = mesh.shape["tp"], mesh.shape["sp"]
    ti, si = mesh.index("tp"), mesh.index("sp")

    def heads(x):
        n = x.shape[1] // tp
        return torch.from_numpy(x[:, ti * n:(ti + 1) * n].copy())

    def shard(x, axis=2):
        h = heads(x)
        n = h.shape[axis] // sp
        return h.narrow(axis, si * n, n).contiguous()

    kw = {}
    if "k_scale" in data:
        kw = dict(k_scale=shard(data["k_scale"]),
                  v_scale=shard(data["v_scale"]))
    out = append_attention_sharded(
        mesh, heads(data["q"]), shard(data["k"]), shard(data["v"]),
        heads(data["kn"]), heads(data["vn"]), k_len=case["k_len"],
        shard_seq=True, **kw)
    return out.numpy().tolist()


def _load(job):
    """The job's target config and its target and drafter params."""
    from triforce_tpu_torch import config as tcfg
    from triforce_tpu_torch.models import llama as tl
    cfg = dict(job["target_cfg"])
    cfg = tcfg.ModelConfig(rope=tcfg.RopeConfig(**cfg.pop("rope")), **cfg)
    data = np.load(job["params"])

    def tree(prefix):
        out = {"layers": {}}
        for k in data.files:
            if k.startswith(prefix + "layers."):
                out["layers"][k[len(prefix + "layers."):]] = data[k]
            elif k.startswith(prefix):
                out[k[len(prefix):]] = data[k]
        return out

    pt = tl.params_from_numpy(tree("t."), cfg, "cpu")
    pd = tl.params_from_numpy(tree("d."), tcfg.TINY_DRAFT, "cpu")
    return cfg, pt, pd


def _engine(mesh, job, case, temperature, kv_quant, max_new=32):
    from triforce_tpu_torch import config as tcfg
    from triforce_tpu_torch.engine import Engine
    cfg, pt, pd = _load(job)
    spec = tcfg.SpecConfig(**dict(job["spec"], temperature=temperature))
    return Engine(cfg, spec, pt, draft_cfg=tcfg.TINY_DRAFT, draft_params=pd,
                  prefill=job["prefill"],
                  max_cache_len=job["prefill"] + max_new,
                  dtype=torch.float32, prefill_chunk=16,
                  draft_prefill_chunk=8, device="cpu", mesh=mesh,
                  shard_seq=mesh is not None and mesh.shape["sp"] > 1,
                  kv_quant=kv_quant)


def run_engine_case(mesh, job, case):
    """The tokens one engine case emits (the same on every rank): 3
    TriForce steps, or a whole generation of ``case["mode"]``."""
    eng = _engine(mesh, job, case, case["temperature"],
                  case.get("kv_quant", False))
    ids = torch.tensor(job["ids"], dtype=torch.int64)
    st = eng.init_state(7)
    st = eng.prefill_target(st, ids)
    mode = case.get("mode", "steps")
    if mode in ("steps", "triforce", "forced"):
        st = eng.prefill_draft(st, ids)
    if mode == "steps":
        step = eng._step_fn("triforce", None)
        toks = []
        for _ in range(3):
            st, stats = step(st)
            toks += _tokens(stats.tokens[:stats.n_emitted])
        return toks
    if mode == "ar":
        _, _, _, buf = eng.generate_ar(st.kv, st.next_token, st.gen,
                                       case["n"])
        return _tokens(buf)
    if mode == "forced":
        _, buf, n, _ = eng.generate_forced(st, case["n"], 0.5,
                                           mode="triforce")
        return _tokens(buf[:n])
    _, buf, n, _ = eng.generate(st, case["n"], mode=mode)
    return _tokens(buf[:n])


def tree_grow_map(size=8, depth=4, branch=3):
    """The tiny tree of ``tests/test_torch_tree.py`` (8 nodes, depth 4)."""
    from triforce_tpu_torch.tree import planner
    p = planner.modeled_acceptance_vector(0.8, max_branch=branch)
    tree, choice = planner.plan_tree(p, max_budget=size, max_depth=depth)
    return planner.build_grow_map(tree, choice, size, depth)


def run_tree_case(mesh, job, case):
    """Up to 4 steps of a ``TreeEngine`` (tp x sp over ``mesh``, the full
    cache's slots split over sp): per step [n_nodes, n_emitted, tokens,
    kv length]."""
    from triforce_tpu_torch.tree.spectree import TreeEngine
    cfg, pt, _ = _load(job)
    spec = job["spec"]
    eng = TreeEngine(cfg, tree_grow_map(), pt, prefill=job["prefill"],
                     max_cache_len=job["prefill"] + 64,
                     budget=spec["budget"], chunk_size=spec["chunk_size"],
                     temperature=case["temperature"], top_p=0.9,
                     dtype=torch.float32, prefill_chunk=16, device="cpu",
                     mesh=mesh, shard_seq=mesh is not None
                     and mesh.shape["sp"] > 1,
                     kv_quant=case.get("kv_quant", False),
                     weight_quant=case.get("weight_quant", False),
                     ssl=case.get("ssl", 0))
    st = eng.prefill_target(eng.init_state(7),
                            torch.tensor(job["tree_ids"], dtype=torch.int64))
    out = []
    for _ in range(4):
        st, s = eng.step(st)
        out.append([s.n_nodes, s.n_emitted, _tokens(s.tokens),
                    int(st.kv.seq_len)])
        if s.terminal:
            break
    return out


def run_rows_case(mesh, job, case):
    """3 steps of ``BatchedSpecEngine`` over ``job["rows"]``: rows over the
    mesh's dp axis, beside a meshless engine (a dp-only mesh) or with the
    engine over the whole dp x tp x sp mesh. Returns the global tokens,
    emitted counts and counters."""
    from triforce_tpu_torch.batched_spec import BatchedSpecEngine
    composed = mesh is not None and mesh.shape["tp"] * mesh.shape["sp"] > 1
    eng = _engine(mesh if composed else None, job, case,
                  case["temperature"], case.get("kv_quant", False))
    bat = BatchedSpecEngine(eng, mode=case["mode"],
                            mesh=None if composed else mesh)
    st = bat.prefill_rows([torch.tensor([p], dtype=torch.int64)
                           for p in job["rows"]], job["seeds"])
    _, toks, ns, counters, _ = bat.decode(st, 3)
    return dict(tokens=toks.tolist(), n_emitted=ns.tolist(),
                counters=counters.tolist(), rows=len(st.gens))


def run_serve_case(mesh, job, case):
    """``job["requests"]`` through ``SpecScheduler`` (slots over the mesh's
    dp axis, a meshless engine): every request's output by id."""
    from triforce_tpu_torch.batched_spec import SpecScheduler
    from triforce_tpu_torch.batching import Request
    eng = _engine(None, job, case, case["temperature"], False, max_new=256)
    sched = SpecScheduler(eng, mode=case["mode"], slots=case["slots"],
                          segment=2, mesh=mesh)
    for i, p in enumerate(job["requests"]):
        sched.submit(Request(rid=i, prompt=np.asarray(p),
                             max_new_tokens=case["max_new"]))
    done = sched.run(max_wall_s=RUN_TIMEOUT_S)
    return sorted([r.rid, r.out] for r in done)


def _case_cli(job) -> dict:
    """``cli.main`` on this rank (it joins the process group itself): its
    tokens (a served run: every request's, by id) and what it printed."""
    import contextlib
    import io
    from triforce_tpu_torch import cli
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = cli.main(job["argv"])
    if isinstance(res, list):
        return {"tokens": sorted([r.rid, r.out] for r in res),
                "stdout": out.getvalue()}
    return {"tokens": res.tokens, "stdout": out.getvalue()}


_CASES = {"attention": "_case_attention", "engine": "run_engine_case",
          "tree": "run_tree_case", "rows": "run_rows_case",
          "serve": "run_serve_case"}


def main(path: str) -> None:
    torch.set_num_threads(1)
    with open(path) as f:
        job = json.load(f)
    from triforce_tpu_torch.parallel import mesh as mesh_mod
    rank = int(os.environ["RANK"])
    if job["kind"] == "cli":
        out = _case_cli(job)
    else:
        mesh_mod.init_distributed(device="cpu", timeout_s=GROUP_TIMEOUT_S)
        out = {}
        for case in job["cases"]:
            mesh = mesh_mod.make_mesh(tp=case["tp"], sp=case["sp"],
                                      dp=case.get("dp", 1), device="cpu")
            fn = globals()[_CASES[case["kind"]]]
            out[case["name"]] = fn(mesh, job, case)
            out[case["name"] + " collectives"] = dict(mesh.collectives)
        import torch.distributed as dist
        dist.destroy_process_group()
    with open(f"{job['out']}.{rank}.json", "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main(sys.argv[1])
