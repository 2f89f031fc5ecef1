"""Where the batched speculation steps and speculative serving spend their
time on a card: ``BatchedSpecEngine.decode`` (TriForce at forced
acceptance 0.9) and ``SpecScheduler`` (requests through a fixed pool of
slots, chunked admission between decode segments), at Llama2-7B-128K +
Llama-68M widths.

It prints one ``ROWS {...}`` and one ``SERVE {...}`` JSON line:

  * ``ROWS``: a prefilled pool of ``--rows`` rows; one ``decode`` call of
    ``--steps`` steps that captures the graphs, then (a) a timed call
    (host clock, device synchronised at both ends): ms a step, tokens/s,
    host read-backs a step (``.tolist()``, ``.item()``, ``bool()``,
    ``int()``, ``float()``, ``.cpu()`` of a CUDA tensor, counted in
    Python); (b) one more call measured for the device's busy time: under
    ``torch.profiler`` (its kernels and copies, the union of their
    intervals) where the engine's graphs hold no if-node, else as the sum
    of the device time between CUDA events around each graph replay (the
    profiler crashed on graphs with if-nodes on the card's torch); the
    host's gaps are the wall less the busy time.
  * ``SERVE``: ``--requests`` requests of ``--new`` tokens through the
    pool (segment ``--segment``), twice on one engine: a clean run, each
    decode segment synchronised at its edges (wall ms, live slots, steps,
    tokens emitted and kept, read-backs, graphs captured in it), then a
    run with each segment's busy time measured as in (b). The split
    answers where serving's tokens/s goes against the batched run's: dead
    slots, the tokens a row emits past its length (dropped), the first
    segment's captures and first calls, and the admissions (their seconds
    are not in ``decode_s``).

Run on a card from the repository root (or from an unpacked parent with
this file copied in, to measure the parent):

    python3 probes/torch_rows_split.py [--int8] [--tag TAG]

On the CPU (``--device cpu --model tiny``) it runs the same calls at the
tiny configs, as a rehearsal; its times are not device numbers.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torch_step_split import Reads, profiled, replay_busy  # noqa: E402
from triforce_tpu_torch import batched_spec as bs  # noqa: E402
from triforce_tpu_torch import batching  # noqa: E402
from triforce_tpu_torch import config  # noqa: E402
from triforce_tpu_torch.engine import Engine  # noqa: E402
from triforce_tpu_torch.models import llama  # noqa: E402

GAMMA, ALPHA = 6, 0.9


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _measure(eng, dev):
    """The busy-time measurement this engine's graphs allow."""
    if dev.type != "cuda":
        return profiled
    return replay_busy if eng.graphs.stats()["bodies"] else profiled


def _busy_fields(prof):
    if "replay_busy_ms" in prof:
        return dict(busy_ms=prof["replay_busy_ms"], busy_by="cuda events "
                    "around graph replays", wall_ms=prof["wall_ms"])
    if prof.get("device_ops"):
        return dict(busy_ms=prof["device_busy_union_ms"],
                    busy_by="torch.profiler kernel union",
                    wall_ms=prof["wall_ms"])
    return dict(busy_ms=None, busy_by="not measured", wall_ms=prof["wall_ms"])


def rows_split(eng, prompts, reads, dev, args):
    bat = bs.BatchedSpecEngine(eng, mode="triforce", force_accept=ALPHA)
    state = bat.prefill_rows(prompts[:args.rows], list(range(args.rows)))
    _sync(dev)
    out = dict(rows=args.rows, steps=args.steps, alpha=ALPHA)
    c0, s0 = eng.graphs.captures, eng.graphs.capture_s
    t0 = time.perf_counter()
    state = bat.decode(state, args.steps)[0]
    _sync(dev)
    out["warm"] = dict(captures=eng.graphs.captures - c0,
                       capture_s=eng.graphs.capture_s - s0,
                       wall_s=time.perf_counter() - t0)
    c1, s1, f1 = eng.graphs.captures, eng.graphs.capture_s, \
        bat.target_forwards
    reads.on, reads.n = True, 0
    _sync(dev)
    t0 = time.perf_counter()
    state, toks, ns, counters, _ = bat.decode(state, args.steps)
    _sync(dev)
    wall = time.perf_counter() - t0 - (eng.graphs.capture_s - s1)
    reads.on = False
    tokens = int(ns.sum())
    out["timed"] = dict(
        wall_s=wall, tokens=tokens, tokens_per_s=tokens / wall,
        ms_per_step=1e3 * wall / args.steps, readbacks=reads.n,
        readbacks_per_step=reads.n / args.steps,
        target_forwards=bat.target_forwards - f1,
        accepted=int(counters[:, 0].sum()), proposed=int(counters[:, 1].sum()),
        captures=eng.graphs.captures - c1)
    (state, _, ns, _, _), prof = _measure(eng, dev)(
        lambda: bat.decode(state, args.steps), dev)
    b = _busy_fields(prof)
    out["busy"] = dict(b, steps=args.steps, tokens=int(ns.sum()))
    if b["busy_ms"] is not None:
        out["busy"].update(
            busy_ms_per_step=b["busy_ms"] / args.steps,
            host_gap_ms_per_step=(b["wall_ms"] - b["busy_ms"]) / args.steps,
            busy_share=b["busy_ms"] / b["wall_ms"])
    print(f"ROWS {json.dumps(out)}", flush=True)
    del state
    return bat


def serve_split(eng, bat, prompts, reads, dev, args, busy: bool):
    sched = bs.SpecScheduler(eng, mode="triforce", slots=args.rows,
                             segment=args.segment, bat=bat, admit_chunks=4)
    segs = []
    decode = sched._decode_segment
    measure = None

    def segment():
        live = sum(r is not None for r in sched.slot_req)
        c0 = eng.graphs.captures
        f0 = bat.target_forwards
        reads.on, reads.n = True, 0
        _sync(dev)
        t0 = time.perf_counter()
        if busy:
            (new, force), prof = measure(decode, dev)
        else:
            new, force = decode()
            prof = None
        _sync(dev)
        wall = time.perf_counter() - t0
        reads.on = False
        rec = dict(wall_ms=1e3 * wall, live=live,
                   emitted=sum(len(t) for t in new), readbacks=reads.n,
                   captures=eng.graphs.captures - c0,
                   target_forwards=bat.target_forwards - f0)
        if prof is not None:
            rec.update(_busy_fields(prof))
        segs.append(rec)
        return new, force

    sched._decode_segment = segment
    if busy:
        measure = _measure(eng, dev)
    for i, p in enumerate(prompts[:args.requests]):
        sched.submit(batching.Request(rid=i, prompt=p[0].cpu().numpy(),
                                      max_new_tokens=args.new))
    t0 = time.perf_counter()
    done = sched.run(max_wall_s=900)
    _sync(dev)
    total = time.perf_counter() - t0
    st = sched.stats
    decoded = sum(len(r.out) - 1 for r in done)
    emitted = sum(s["emitted"] for s in segs)
    steps = st["steps"]
    slot_steps = sum(s["live"] for s in segs) * args.segment
    out = dict(run="busy" if busy else "clean", requests=len(done),
               new=args.new, segment=args.segment, slots=args.rows,
               wall_s=total, admit_s=st["admit_s"], decode_s=st["decode_s"],
               capture_s=st["capture_s"], captures=st["captures"],
               admit_captures=st["admit_captures"], steps=steps,
               decode_tokens=decoded, tokens_per_s=decoded / st["decode_s"],
               emitted=emitted, dropped=emitted - decoded,
               live_slot_share=slot_steps / max(steps * args.rows, 1),
               readbacks=sum(s["readbacks"] for s in segs),
               readbacks_per_segment=sum(s["readbacks"] for s in segs)
               / max(len(segs), 1),
               first_segment_ms=segs[0]["wall_ms"] if segs else None,
               rest_segment_ms=[s["wall_ms"] for s in segs[1:]],
               segments=segs)
    if busy and segs and segs[0].get("busy_ms") is not None:
        b = sum(s["busy_ms"] for s in segs)
        w = sum(s["wall_ms"] for s in segs)
        out.update(busy_ms=b, segments_wall_ms=w, busy_share=b / w)
    print(f"SERVE {json.dumps(out)}", flush=True)
    sched.state = sched._row = None
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--model", default="7b", choices=["7b", "tiny"])
    ap.add_argument("--prefill", type=int, default=8192)
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--segment", type=int, default=4)
    ap.add_argument("--tag", default="")
    ap.add_argument("--no-serve-busy", action="store_true",
                    help="skip the serving run measured for busy time")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    dev = config.resolve_device(args.device)
    if args.model == "7b":
        tcfg, dcfg = config.LLAMA2_7B_128K, config.LLAMA_68M
        budget, chunk = 4096, 8
    else:
        tcfg, dcfg = config.TINY_TARGET, config.TINY_DRAFT
        budget, chunk = 16, 4
        args.prefill = min(args.prefill, 64)
    if dev.type == "cuda":
        print("device: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    print(f"TAG {json.dumps(dict(tag=args.tag, int8=args.int8))}",
          flush=True)
    reads = Reads()
    tp = llama.init_params(tcfg, device=dev, dtype=torch.bfloat16, seed=0)
    dp = llama.init_params(dcfg, device=dev, dtype=torch.bfloat16, seed=1)
    spec = config.SpecConfig(gamma=GAMMA, budget=budget, chunk_size=chunk)
    # the rows' three calls and both serving runs' headroom
    head = max(4 * args.steps,
               2 * (args.new + 2 * args.segment + 2)) * (GAMMA + 2)
    eng = Engine(tcfg, spec, tp, draft_cfg=dcfg, draft_params=dp,
                 prefill=args.prefill, max_cache_len=args.prefill + head,
                 dtype=torch.bfloat16, device=dev, eos_token_id=-1,
                 kv_quant=args.int8, weight_quant=args.int8,
                 prefill_chunk=512 if args.model == "7b" else 16,
                 draft_prefill_chunk=64 if args.model == "7b" else 8)
    del tp
    rng = np.random.default_rng(6)
    prompts = [torch.as_tensor(rng.integers(0, tcfg.vocab_size,
                                            args.prefill), device=dev)[None]
               for _ in range(max(args.requests, args.rows))]
    bat = rows_split(eng, prompts, reads, dev, args)
    serve_split(eng, bat, prompts, reads, dev, args, busy=False)
    if not args.no_serve_busy:
        serve_split(eng, bat, prompts, reads, dev, args, busy=True)


if __name__ == "__main__":
    main()
