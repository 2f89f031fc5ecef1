"""The hybrid path (sliding-window layers on a ring, expert MLPs) on a
card, end to end at a small context: Mellum2-12B-A2.5B's widths with
``--layers`` layers (sliding, sliding, sliding, full, repeated), random
weights. A graphed engine and its eager witness run the same prefill and
forced-acceptance TriForce calls from one seed and must leave the same
tokens, counters, expert counts and cache bits; then each decode forward
is timed (``profiling.measure_phase_times``) beside the expert kernel's
and the window kernel's device time in one profiled eager verify.

    python3 probes/torch_moe_window_probe.py [--layers 4] [--prefill 8192]

One JSON line a result on standard output.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from triforce_tpu_torch import profiling  # noqa: E402
from triforce_tpu_torch.config import (LLAMA_68M, MELLUM2_12B_A2_5B,  # noqa
                                       SpecConfig)
from triforce_tpu_torch.engine import Engine  # noqa: E402
from triforce_tpu_torch.models import llama  # noqa: E402


def _digest(st) -> list:
    n = int(st.kv.seq_len)
    out = [n]
    for x in (st.kv.k[..., :n, :], st.kv.v[..., :n, :], st.kv.ring_k,
              st.kv.ring_v, st.rkv.k, st.rkv.v):
        out.append(int(x.view(torch.int16).to(torch.int64).sum()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--prefill", type=int, default=8192)
    ap.add_argument("--tokens", type=int, default=48)
    a = ap.parse_args(argv)
    dev = torch.device("cuda")
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "grouped_mm": hasattr(torch, "_grouped_mm"),
                      "card": torch.cuda.get_device_name(dev)}), flush=True)
    cfg = dataclasses.replace(
        MELLUM2_12B_A2_5B, num_layers=a.layers,
        layer_types=MELLUM2_12B_A2_5B.layer_types[:a.layers])
    dcfg = LLAMA_68M.with_(vocab_size=cfg.vocab_size)
    spec = SpecConfig(gamma=6, budget=4096, chunk_size=8)
    params = llama.init_params(cfg, device=dev, seed=1)
    draft = llama.init_params(dcfg, device=dev, seed=2)
    room = a.prefill + 4 * a.tokens + 64
    ids = torch.randint(3, cfg.vocab_size, (1, a.prefill),
                        generator=torch.Generator(device=dev).manual_seed(3),
                        device=dev)
    engines = {}
    for name, graphs in (("graphed", None), ("eager", False)):
        eng = Engine(cfg, spec, params, draft_cfg=dcfg, draft_params=draft,
                     prefill=a.prefill, max_cache_len=room, graphs=graphs,
                     device=dev)
        t0 = time.perf_counter()
        st = eng.prefill_target(eng.init_state(7), ids)
        st = eng.prefill_draft(st, ids)
        bufs, counters = [], []
        for _ in range(2):
            st, buf, n, c = eng.generate_forced(st, a.tokens, 0.9,
                                                mode="triforce")
            bufs.append(buf[:n].tolist())
            counters.append(c.tolist())
        torch.cuda.synchronize()
        engines[name] = (eng, st)
        print(json.dumps({"engine": name, "s": time.perf_counter() - t0,
                          "counters": counters,
                          "moe_counts": eng.moe_counts.tolist(),
                          "digest": _digest(st), "tokens": bufs[-1][:12]}),
              flush=True)
    (ge, gs), (ee, es) = engines["graphed"], engines["eager"]
    same = dict(digest=_digest(gs) == _digest(es),
                moe_counts=ge.moe_counts.tolist() == ee.moe_counts.tolist())
    print(json.dumps({"graphed_equals_eager": same}), flush=True)
    ms = {k: 1e3 * v for k, v in
          profiling.measure_phase_times(ge, gs, 10).items()}
    print(json.dumps({"phase_ms": ms}), flush=True)
    fork = es.clone()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        ee.generate_forced(fork, 8, 0.9, mode="triforce")
        torch.cuda.synchronize()
    fam = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or 0
        if us:
            k = e.key.split("(")[0].replace("(anonymous namespace)::", "")
            fam[k] = fam.get(k, 0.0) + us / 1e3
    top = sorted(fam.items(), key=lambda x: -x[1])[:14]
    print(json.dumps({"profile_ms": top}), flush=True)
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
