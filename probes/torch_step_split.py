"""Where a graphed decode step spends its time, and whether the card's
torch can capture conditional graph nodes.

Two parts, each printing JSON lines:

  * ``COND {...}``: does ``torch.cuda.CUDAGraph`` have
    ``begin_capture_to_if_node`` / ``end_capture_to_conditional_node`` (and
    any while-node entry point)? Where it does, one graph is captured with
    an if-node holding a cuBLAS product, a B1 launch (the decode path, a
    programmatic dependent reduce) and a nested if-node that allocates,
    and a draw outside the bodies; it is replayed with every pair of
    predicates and held against eager results.
  * ``STEP {...}`` per mode (``--modes``; 7B bf16: ``triforce``,
    ``retrieval``, ``forced`` = TriForce at forced acceptance 0.9,
    ``tree_forced`` = the 128-node tree at 0.9): a fresh prefilled state,
    one generation of the timed length that captures the graphs, then
    (a) a timed
    generation (host clock, device synchronised at both ends): ms/token,
    steps, host read-backs (``.tolist()``, ``.item()``, ``bool()``,
    ``int()``, ``float()``, ``.cpu()`` of a CUDA tensor); (b) the same
    under ``torch.profiler``: the device's busy time (its kernels and
    copies summed, and the union of their intervals, which counts
    overlapping launches once) against the span, or, for a tree whose
    loop graphs hold if-nodes (the profiler cannot trace those on the
    card), the device time of each graph replay between CUDA events,
    summed, against the wall; (c) two single steps
    (``Engine._step_fn`` / ``TreeEngine.step``), each synchronised at its
    edges and profiled; for the tree one more step split into its graph
    regions by name (grow, tree verify, tree node tests, the rest), each
    synchronised at its edges.

Run on a card from the repository root (or from an unpacked parent, to
measure the parent):

    python3 probes/torch_step_split.py [--modes ...] [--no-cond]

On the CPU (``--device cpu --model tiny``) it runs the same steps at the
tiny configs, as a rehearsal; its times are not device numbers.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from triforce_tpu_torch import config  # noqa: E402
from triforce_tpu_torch import graphs as graphs_mod  # noqa: E402
from triforce_tpu_torch.engine import Engine  # noqa: E402
from triforce_tpu_torch.models import llama  # noqa: E402
from triforce_tpu_torch.tree import planner, spectree  # noqa: E402


class Reads:
    """Counts host read-backs of CUDA tensors while ``on``."""
    NAMES = ("tolist", "item", "__bool__", "__int__", "__float__", "cpu",
             "__index__")

    def __init__(self):
        self.on = False
        self.n = 0
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)

            def wrapped(t, *a, _orig=orig, **k):
                if self.on and t.is_cuda:
                    self.n += 1
                return _orig(t, *a, **k)
            setattr(torch.Tensor, name, wrapped)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_work(prof):
    kern = [e for e in prof.events()
            if str(e.device_type).endswith("CUDA") and e.name]
    if not kern:
        return dict(device_ops=0)
    busy = sum((e.time_range.end - e.time_range.start) for e in kern) / 1e3
    span = (max(e.time_range.end for e in kern)
            - min(e.time_range.start for e in kern)) / 1e3
    union, end = 0.0, None      # overlapping launches counted once
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in kern):
        if end is None or a > end:
            union, end = union + b - a, b
        elif b > end:
            union, end = union + b - end, b
    return dict(device_ops=len(kern), device_busy_ms=busy,
                device_busy_union_ms=union / 1e3, device_span_ms=span)


def profiled(fn, dev):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _sync(dev)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        wall = time.perf_counter() - t0
    return out, dict(wall_ms=1e3 * wall, **device_work(prof))


def replay_busy(fn, dev):
    """``fn()`` whose device work is CUDA-graph replays: the device ms
    between CUDA events recorded just before and after each replay,
    summed, against the call's wall (a graph with if-nodes cannot be
    traced by the profiler on this card's torch: CUPTI crashes)."""
    replay = torch.cuda.CUDAGraph.replay
    marks = []

    def timed(graph):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        replay(graph)
        b.record()
        marks.append((a, b))
    torch.cuda.CUDAGraph.replay = timed
    try:
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        wall = time.perf_counter() - t0
    finally:
        torch.cuda.CUDAGraph.replay = replay
    busy = sum(a.elapsed_time(b) for a, b in marks)
    return out, dict(wall_ms=1e3 * wall, replay_busy_ms=busy,
                     replays=len(marks), busy_share=busy / (1e3 * wall))


def cond_check(dev):
    g = torch.cuda.CUDAGraph
    out = dict(torch=torch.__version__, cuda=torch.version.cuda,
               if_node=hasattr(g, "begin_capture_to_if_node"),
               end_conditional=hasattr(g, "end_capture_to_conditional_node"),
               graph_methods=sorted(n for n in dir(g)
                                    if "capture" in n or "cond" in n
                                    or "while" in n))
    out["cond_module"] = importlib.util.find_spec(
        "torch._higher_order_ops.cudagraph_conditional_nodes") is not None
    if not (out["if_node"] and out["end_conditional"]):
        return out
    from triforce_tpu_torch.ops import flash_decode as fd
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(256, 256, device=dev, generator=gen).bfloat16()
    w = torch.randn(256, 256, device=dev, generator=gen).bfloat16()
    hkv, gt, d, s, klen = 32, 7, 128, 4200, 4100

    def rn(*shape):
        return torch.randn(shape, device=dev, generator=gen).bfloat16()
    q, k, v = rn(hkv, gt, d), rn(hkv, s, d), rn(hkv, s, d)
    kn, vn = rn(hkv, gt, d), rn(hkv, gt, d)
    mask = fd.causal_mask(gt, gt, 1, dev)
    k_len = torch.full((), klen, dtype=torch.int32, device=dev)
    ref_mm = x @ w
    ref_b1 = fd.flash_decode_append(q, k, v, kn, vn, k_len, mask)
    pred = torch.zeros((), dtype=torch.bool, device=dev)
    pred2 = torch.zeros((), dtype=torch.bool, device=dev)
    mm = torch.zeros_like(ref_mm)
    b1 = torch.zeros_like(ref_b1)
    cnt = torch.zeros(4, dtype=torch.int64, device=dev)
    rgen = torch.Generator(device=dev).manual_seed(1)
    draws = torch.zeros(8, device=dev)
    res = {}
    for pdl in (True, False):
        prev = fd.set_programmatic_launch(pdl)
        tag = "pdl" if pdl else "no_pdl"
        try:
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(rgen)
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            l0 = fd.flash_decode_append.launches
            with torch.cuda.stream(stream):
                graph.capture_begin()
                draws.copy_(torch.rand(8, generator=rgen, device=dev))
                graph.begin_capture_to_if_node(pred)
                mm.copy_(x @ w)
                b1.copy_(fd.flash_decode_append(q, k, v, kn, vn, k_len,
                                                mask))
                cnt[0:1].add_(1)
                graph.begin_capture_to_if_node(pred2)
                tmp = torch.ones(3, dtype=torch.int64, device=dev)
                cnt[1:4].add_(tmp)
                graph.end_capture_to_conditional_node()
                graph.end_capture_to_conditional_node()
                graph.capture_end()
            torch.cuda.current_stream(dev).wait_stream(stream)
            captured = fd.flash_decode_append.launches - l0
            runs = []
            for p1 in (True, False):
                for p2 in (True, False):
                    pred.fill_(p1)
                    pred2.fill_(p2)
                    mm.zero_()
                    b1.zero_()
                    c0 = cnt.clone()
                    graph.replay()
                    torch.cuda.synchronize(dev)
                    dc = (cnt - c0).tolist()
                    ok = (torch.equal(mm, ref_mm) if p1
                          else not mm.any().item()) \
                        and (torch.equal(b1, ref_b1) if p1
                             else not b1.any().item()) \
                        and dc == ([1] + [int(p2)] * 3 if p1 else [0] * 4)
                    runs.append(dict(p1=p1, p2=p2, ok=bool(ok), counts=dc))
            res[tag] = dict(ok=all(r["ok"] for r in runs), runs=runs,
                            b1_launches_captured=captured)
            del graph
        except Exception as e:  # noqa: BLE001 - the probe reports it
            res[tag] = dict(ok=False, error=f"{type(e).__name__}: {e}")
        finally:
            fd.set_programmatic_launch(prev)
            torch.cuda.synchronize(dev)
    out["capture"] = res
    return out


def make_engine(mode, tcfg, dcfg, tp, dp, args, dev):
    if mode == "tree_forced":
        pv = planner.modeled_acceptance_vector(0.8, 4)
        T, choice = planner.plan_tree(pv, args.tree_size, args.tree_depth)
        gm = planner.build_grow_map(T, choice, args.tree_size,
                                    args.tree_depth)
        return spectree.TreeEngine(
            tcfg, gm, tp, prefill=args.prefill,
            max_cache_len=args.prefill + 5 * args.gen + 4 * gm.size,
            budget=args.budget, chunk_size=args.chunk, temperature=0.6,
            top_p=0.9, dtype=torch.bfloat16, prefill_chunk=args.pchunk,
            device=dev, eos_ids=())
    spec = config.SpecConfig(gamma=6, budget=args.budget,
                             chunk_size=args.chunk)
    return Engine(tcfg, spec, tp, draft_cfg=dcfg, draft_params=dp,
                  prefill=args.prefill,
                  max_cache_len=args.prefill + 5 * args.gen + 64,
                  dtype=torch.bfloat16, device=dev, eos_token_id=-1,
                  prefill_chunk=args.pchunk)


def run_mode(mode, eng, ids, reads, dev, args):
    tree = mode == "tree_forced"
    alpha = 0.9 if mode in ("forced", "tree_forced") else None
    emode = "retrieval" if mode == "retrieval" else "triforce"

    def prefilled(seed):
        st = eng.prefill_target(eng.init_state(seed), ids)
        if not tree and emode == "triforce":
            st = eng.prefill_draft(st, ids)
        return st

    counters = []

    def generate(st, n):
        if tree:
            st, buf, m, c, _ = eng.generate_forced(st, n, alpha)
        elif alpha is None:
            st, buf, m, c = eng.generate(st, n, mode=emode)
        else:
            st, buf, m, c = eng.generate_forced(st, n, alpha, mode=emode)
        counters.append([int(x) for x in c])
        return st, m, int(c[0])

    out = dict(mode=mode, prefill=args.prefill)
    st = prefilled(3)
    c0, s0 = eng.graphs.captures, eng.graphs.capture_s
    st, _, _ = generate(st, args.gen)   # captures this state's graphs
    _sync(dev)
    out["warm_captures"] = eng.graphs.captures - c0
    out["warm_capture_s"] = eng.graphs.capture_s - s0
    c1, s1 = eng.graphs.captures, eng.graphs.capture_s
    reads.on, reads.n = True, 0
    _sync(dev)
    t0 = time.perf_counter()
    st, m, steps = generate(st, args.gen)
    _sync(dev)
    # capture seconds (none where the warm call captured) left out
    wall = time.perf_counter() - t0 - (eng.graphs.capture_s - s1)
    reads.on = False
    out["timed"] = dict(tokens=m - 1, steps=steps, wall_s=wall,
                        counters=counters[-1],
                        ms_per_token=1e3 * wall / max(m - 1, 1),
                        ms_per_step=1e3 * wall / max(steps, 1),
                        readbacks=reads.n,
                        readbacks_per_step=reads.n / max(steps, 1),
                        captures=eng.graphs.captures - c1)
    # a loop graph holds if-nodes, which the profiler cannot trace here
    loop = hasattr(graphs_mod.GraphSet, "cond") and dev.type == "cuda"
    measure = replay_busy if loop else profiled
    (st, m, steps), prof = measure(lambda: generate(st, args.gen), dev)
    out["profiled"] = dict(tokens=m - 1, steps=steps,
                           counters=counters[-1], **prof)
    if prof.get("device_ops"):
        out["profiled"]["busy_share"] = prof["device_busy_union_ms"] \
            / prof["wall_ms"]
    # two single steps, each synchronised at its edges (and profiled
    # where they hold no if-node)
    step = (lambda s: eng.step(s, force_accept=alpha)) if tree \
        else eng._step_fn(emode, alpha)
    steps_out = []
    for _ in range(2):
        reads.on, reads.n = True, 0
        (st, stats), prof = measure(lambda: step(st), dev)
        reads.on = False
        prof["readbacks"] = reads.n
        if prof.get("device_ops"):
            prof["busy_share"] = prof["device_busy_union_ms"] \
                / prof["wall_ms"]
        steps_out.append(prof)
    out["steps"] = steps_out
    if tree:
        out["tree_split_ms"] = tree_split(eng, st, alpha, dev)
    print(f"STEP {json.dumps(out)}", flush=True)
    return out


def tree_split(eng, st, alpha, dev):
    """One tree step split into its graph regions by name, each
    synchronised at its edges; "rest" is the step's wall less them."""
    secs = {}
    run = graphs_mod.GraphSet.run

    def graph_run(self, name, fn, inputs, **kw):
        _sync(dev)
        t0 = time.perf_counter()
        try:
            return run(self, name, fn, inputs, **kw)
        finally:
            _sync(dev)
            secs[name] = secs.get(name, 0.0) + 1e3 * (time.perf_counter()
                                                      - t0)
    graphs_mod.GraphSet.run = graph_run
    try:
        _sync(dev)
        t0 = time.perf_counter()
        eng.step(st, force_accept=alpha)
        _sync(dev)
        wall = 1e3 * (time.perf_counter() - t0)
    finally:
        graphs_mod.GraphSet.run = run
    secs["rest"] = wall - sum(secs.values())
    secs["step"] = wall
    return secs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--modes", nargs="*",
                    default=["triforce", "retrieval", "forced",
                             "tree_forced"])
    ap.add_argument("--no-cond", action="store_true")
    ap.add_argument("--model", default="7b", choices=["7b", "tiny"])
    ap.add_argument("--prefill", type=int, default=32768)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    dev = config.resolve_device(args.device)
    if args.model == "7b":
        tcfg, dcfg = config.LLAMA2_7B_128K, config.LLAMA_68M
        args.budget, args.chunk, args.pchunk = 4096, 8, 512
        args.tree_size, args.tree_depth = 128, 12
    else:
        tcfg, dcfg = config.TINY_TARGET, config.TINY_DRAFT
        args.budget, args.chunk, args.pchunk = 16, 4, 16
        args.tree_size, args.tree_depth = 8, 4
        args.prefill = min(args.prefill, 64)
    if dev.type == "cuda":
        print("device: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
        if not args.no_cond:
            print(f"COND {json.dumps(cond_check(dev))}", flush=True)
    reads = Reads()
    tp = llama.init_params(tcfg, device=dev, dtype=torch.bfloat16, seed=0)
    dp = llama.init_params(dcfg, device=dev, dtype=torch.bfloat16, seed=1)
    rng = np.random.default_rng(5)
    ids = torch.as_tensor(rng.integers(0, tcfg.vocab_size, args.prefill),
                          device=dev)[None]
    for mode in args.modes:
        eng = make_engine(mode, tcfg, dcfg, tp, dp, args, dev)
        run_mode(mode, eng, ids, reads, dev, args)
        eng.release_graphs()
        del eng
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
