"""Where a served request's admission spends its time: one
``SpecScheduler`` admission (TriForce mode, batch-1 prefill of one prompt
into a row, then the row written into the slot pool) of Llama2-7B-128K +
Llama-68M at full width with random weights, split into its sections, and
one retrieval build traced on its own.

For each engine asked for (``--modes eager graphed``: ``Engine(graphs=
False)`` and the card's default, CUDA graphs), requests are admitted one
after another into the 4-slot pool (``_admit_one`` until the row is
written; no decode segment runs):

  * request 0 warms up (kernels build, cuBLAS starts; a graphed engine
    runs each region's first, eager call), request 1 captures the graphs
    a graphed engine captures per state (none where the row is reused);
  * request 2 is timed as a whole (host clock, device synchronised at
    both ends): ``admit_s``;
  * request 3 is timed per section: the device is synchronised at each
    section's edges and the host clock read there. Sections: target
    chunks, ragged remainder, retrieval build, first-token sampling,
    drafter prefill, ``init_state`` and row reset, ``write_state_row``;
    what the admission spends outside them is "host gaps";
  * request 4 runs under ``torch.profiler``: the device's busy time (sum
    of its kernels and copies) against the admission's wall, and the
    device operations by total time.

Then one retrieval build (the last prompt token's forward over the
admitted row's full cache, into a scratch retrieval cache) is timed and
traced the same way. Each engine prints one ``SPLIT {...}`` JSON line.

Run on a card from the repository root:

    python3 probes/torch_admission_split.py [--modes eager graphed] [--int8]

On the CPU (``--device cpu --model tiny``) it runs the same steps at the
tiny configs, as a rehearsal; its times are not device numbers.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from triforce_tpu_torch import batched_spec, batching, config  # noqa: E402
from triforce_tpu_torch import engine as engine_mod  # noqa: E402
from triforce_tpu_torch import graphs as graphs_mod  # noqa: E402
from triforce_tpu_torch.models import llama  # noqa: E402

SECTIONS = ("target chunks", "remainder", "build", "sampling",
            "drafter prefill", "init_state / row reset", "write_state_row")


class Sections:
    """Seconds per section; only the outermost labelled call is timed (a
    region's first, eager call is labelled twice). With ``sync`` the device
    is synchronised at each section's edges."""

    def __init__(self, dev):
        self.dev = dev
        self.on = False
        self.depth = 0
        self.secs = dict.fromkeys(SECTIONS, 0.0)
        self.calls = dict.fromkeys(SECTIONS, 0)

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    @contextlib.contextmanager
    def section(self, name):
        if not self.on or self.depth:
            self.depth += 1
            try:
                yield
            finally:
                self.depth -= 1
            return
        self._sync()
        t0 = time.perf_counter()
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1
            self._sync()
            self.secs[name] += time.perf_counter() - t0
            self.calls[name] += 1


def instrument(sec, chunk):
    """Label the admission's sections, eager and graphed alike: the
    target forwards by width (eager calls), the graph regions by name
    (replays), the sampling, the drafter prefill, the row's set-up and its
    write into the pool; ``chunk`` is the target's prefill chunk."""

    def fwd_label(args, kw):
        if kw.get("build_rkv") is not None:
            return "build"
        return "target chunks" if args[2].shape[1] == chunk else "remainder"

    fa = llama.forward_append

    def forward_append(*args, **kw):
        with sec.section(fwd_label(args, kw)):
            return fa(*args, **kw)
    llama.forward_append = forward_append

    run = graphs_mod.GraphSet.run
    by_name = {"build": "build", "draft_prefill": "drafter prefill"}

    def graph_run(self, name, fn, inputs, **kw):
        if name == "prefill":
            label = "target chunks" if inputs[0].shape[1] == chunk \
                else "remainder"
        else:
            label = by_name.get(name)
        if label is None:
            return run(self, name, fn, inputs, **kw)
        with sec.section(label):
            return run(self, name, fn, inputs, **kw)
    graphs_mod.GraphSet.run = graph_run

    def wrap(owner, attr, label):
        if not hasattr(owner, attr):
            return
        orig = getattr(owner, attr)

        def wrapped(*a, **k):
            with sec.section(label):
                return orig(*a, **k)
        setattr(owner, attr, wrapped)

    wrap(engine_mod.Engine, "_sample_next", "sampling")
    wrap(engine_mod.Engine, "prefill_draft", "drafter prefill")
    wrap(engine_mod.Engine, "init_state", "init_state / row reset")
    wrap(batched_spec.SpecScheduler, "_reset_row", "init_state / row reset")
    wrap(batched_spec, "write_state_row", "write_state_row")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def admit(sched, slot, req):
    """One request's whole admission (every slice), host seconds with the
    device synchronised at both ends."""
    _sync(sched.device)
    t0 = time.perf_counter()
    while not sched._admit_one(slot, req):
        pass
    _sync(sched.device)
    return time.perf_counter() - t0


def device_work(prof):
    """The device operations (kernels, copies) of a profile: their count,
    busy ms (summed durations), the span from the first one's start to the
    last one's end, and the ten largest names by total ms."""
    kern = [e for e in prof.events()
            if str(e.device_type).endswith("CUDA") and e.name]
    if not kern:
        return dict(device_ops=0)
    by = {}
    for e in kern:
        t, n = by.get(e.name[:60], (0.0, 0))
        by[e.name[:60]] = (t + (e.time_range.end - e.time_range.start) / 1e3,
                           n + 1)
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:10]
    return dict(
        device_ops=len(kern),
        device_busy_ms=sum(t for t, _ in by.values()),
        device_span_ms=(max(e.time_range.end for e in kern)
                        - min(e.time_range.start for e in kern)) / 1e3,
        top=[[k, round(t, 3), n] for k, (t, n) in top])


def profiled(fn, dev):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _sync(dev)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        wall = time.perf_counter() - t0
    return dict(wall_ms=1e3 * wall, **device_work(prof))


def run_mode(mode, sec, tcfg, dcfg, tp, dp, args, dev, prompts):
    spec = config.SpecConfig(gamma=6, budget=args.budget,
                             chunk_size=args.chunk)
    headroom = batched_spec.SpecScheduler.required_headroom(32, 4, 6)
    eng = engine_mod.Engine(
        tcfg, spec, tp, draft_cfg=dcfg, draft_params=dp,
        prefill=args.prefill, max_cache_len=args.prefill + headroom,
        dtype=torch.bfloat16, device=dev, kv_quant=args.int8,
        weight_quant=args.int8, eos_token_id=-1,
        prefill_chunk=args.prefill_chunk,
        graphs=None if mode == "graphed" else False)
    sched = batched_spec.SpecScheduler(eng, mode="triforce", slots=4,
                                       segment=4, admit_chunks=4)
    reqs = [batching.Request(rid=i, prompt=p, max_new_tokens=32)
            for i, p in enumerate(prompts)]
    sec.secs = dict.fromkeys(SECTIONS, 0.0)
    sec.calls = dict.fromkeys(SECTIONS, 0)
    out = dict(mode=mode, int8=args.int8, prefill=args.prefill)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    g0 = eng.graphs.captures
    out["warm_s"] = [admit(sched, 0, reqs[0]), admit(sched, 1, reqs[1])]
    out["captures_first_two"] = eng.graphs.captures - g0
    g1, c1 = eng.graphs.captures, eng.graphs.capture_s
    out["admit_s"] = admit(sched, 2, reqs[2])
    sec.on = True
    out["instrumented_admit_s"] = admit(sched, 3, reqs[3])
    sec.on = False
    out["sections_s"] = dict(sec.secs)
    out["section_calls"] = dict(sec.calls)
    out["host_gaps_s"] = out["instrumented_admit_s"] - sum(sec.secs.values())
    out["trace"] = profiled(lambda: admit(sched, 0, reqs[4]), dev)
    out["captures_after_two"] = eng.graphs.captures - g1
    out["capture_s_after_two"] = eng.graphs.capture_s - c1
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30

    # one retrieval build over the admitted row: the last prompt token's
    # forward at seq_len = prefill - 1, into a scratch retrieval cache
    row = sched._row if hasattr(sched, "_row") else None
    st = row if row is not None else eng.prefill_target(
        eng.init_state(9), torch.as_tensor(prompts[0], device=dev)[None])
    scratch = st.rkv.clone()
    ids = torch.as_tensor(prompts[4][-1:], device=dev)[None]
    kv = dataclasses.replace(st.kv, seq_len=torch.full_like(
        st.kv.seq_len, args.prefill - 1))
    build = getattr(eng, "_build", None)

    def one_build():
        if build is not None:
            build(kv, scratch, ids)
        else:
            llama.forward_append(tcfg, eng.t_params, ids, kv,
                                 build_rkv=scratch, prefill=args.prefill,
                                 chunk_size=spec.chunk_size,
                                 budget=spec.budget)
    for _ in range(3):
        one_build()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(5):
        one_build()
    _sync(dev)
    out["build_ms"] = 1e3 * (time.perf_counter() - t0) / 5
    out["build_trace"] = profiled(one_build, dev)
    out["graphs"] = eng.graphs.stats()
    print(f"SPLIT {json.dumps(out)}", flush=True)
    del sched, eng, st, scratch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--modes", nargs="+", default=["eager"],
                    choices=["eager", "graphed"])
    ap.add_argument("--int8", action="store_true",
                    help="int8 weights and KV (kv_quant, weight_quant)")
    ap.add_argument("--model", default="7b", choices=["7b", "tiny"])
    ap.add_argument("--prefill", type=int, default=8192)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    dev = config.resolve_device(args.device)
    if args.model == "7b":
        tcfg, dcfg = config.LLAMA2_7B_128K, config.LLAMA_68M
        args.budget, args.chunk, args.prefill_chunk = 4096, 8, 512
    else:
        tcfg, dcfg = config.TINY_TARGET, config.TINY_DRAFT
        args.budget, args.chunk, args.prefill_chunk = 16, 4, 16
    if dev.type == "cuda":
        print("device: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    tp = llama.init_params(tcfg, device=dev, dtype=torch.bfloat16, seed=0)
    dp = llama.init_params(dcfg, device=dev, dtype=torch.bfloat16, seed=1)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, tcfg.vocab_size, args.prefill)
               for _ in range(5)]
    sec = Sections(dev)
    instrument(sec, args.prefill_chunk)
    for mode in args.modes:
        run_mode(mode, sec, tcfg, dcfg, tp, dp, args, dev, prompts)


if __name__ == "__main__":
    main()
