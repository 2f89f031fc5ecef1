#!/usr/bin/env python3
"""The sharded phase of ``chip_smoke.py`` at cut depth, on one card: a
quick check that the mesh path builds, captures and agrees before the
full-depth run.

    python3 probes/torch_mesh_probe.py [--layers 2] [--prefill 8192]

World size 1 over NCCL (the graphed mesh engine with its NCCL
collectives inside the prefill, step and loop graphs, and their if-node
bodies) against the meshless engine and its eager witness; B4 and B2 at a
rank's shard shapes (full width, at ``--shard-prefill``); two gloo ranks
on the card for tp = 2 and sp = 2. Prints one JSON line per part.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--prefill", type=int, default=8192)
    ap.add_argument("--shard-prefill", type=int, default=32768)
    ap.add_argument("--gen", type=int, default=48)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from triforce_tpu_torch import _build, config as tc, cache, decoding
    from triforce_tpu_torch.engine import Engine
    from triforce_tpu_torch.models import llama
    from triforce_tpu_torch.ops import attention as att
    from triforce_tpu_torch.ops import flash_decode as fd
    from triforce_tpu_torch.ops import retrieval as rt
    from triforce_tpu_torch.ops import retrieval_kernel as rk
    from triforce_tpu_torch.parallel import mesh as mesh_mod
    dev = torch.device("cuda")
    print("device:", cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    cs.GEN = args.gen
    mesh = mesh_mod.single_device_mesh(dev)
    ns = type("cfgs", (), dict(
        LLAMA2_7B_128K=tc.LLAMA2_7B_128K.with_(num_layers=args.layers),
        LLAMA_68M=tc.LLAMA_68M, SpecConfig=tc.SpecConfig))
    for quant in (False, True):
        t0 = time.perf_counter()
        tp = llama.init_params(ns.LLAMA2_7B_128K, device=dev, seed=0)
        dp = llama.init_params(ns.LLAMA_68M, device=dev, seed=1)
        spec = tc.SpecConfig(gamma=cs.GAMMA, budget=4096, chunk_size=8)
        eng = Engine(ns.LLAMA2_7B_128K, spec, tp, draft_cfg=ns.LLAMA_68M,
                     draft_params=dp, prefill=args.prefill,
                     max_cache_len=args.prefill + cs.GEN + 4 * (cs.GAMMA + 2),
                     device=dev, kv_quant=quant, weight_quant=quant)
        if quant:
            tp, dp = eng.t_params, eng.d_params
        e2e = cs.end_to_end(ns, decoding, llama, eng, fd, rk, dev,
                            args.prefill, quant)
        del eng
        torch.cuda.empty_cache()
        w1 = cs.sharded_world1(ns, llama, Engine, mesh, fd, rk, dev,
                               args.prefill, quant, tp, dp, e2e["graphs"])
        print(f"PROBE world1 {quant} {time.perf_counter() - t0:.1f} s "
              + json.dumps(w1), flush=True)
        del tp, dp
        torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    t0 = time.perf_counter()
    sh = cs.kernel_shards(fd, att, rk, rt, cache, dev, args.shard_prefill)
    print(f"PROBE kernel_shards {time.perf_counter() - t0:.1f} s "
          + json.dumps({str(k): v for k, v in sh.items()}), flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        two = cs.sharded_two_ranks(tc, llama, Engine, fd, rk, dev, tmp,
                                   prefill=args.prefill, layers=args.layers)
    print(f"PROBE two ranks {time.perf_counter() - t0:.1f} s "
          + json.dumps(two), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
