"""The device kernels of one forward of each kind at a benchmark cell's
shapes, counted and timed by family under ``torch.profiler``.

    python3 probes/torch_forward_kernels.py [--workload <cell>] [--seed n]
        [--prompt n] [--out chiprun_out/forward_kernels.json]

It builds the cell's engine from the seed as the harness does, takes its
eager twin (``graphs=False``: the profiler does not serve inside graphs
with if-nodes), prefills ``--prompt`` tokens of the cell's prompt (the
cell's own length by default), warms each forward up once and then runs,
each under the profiler alone: one middle verify (``forward_spec``, gamma
+ 1 tokens over the retrieval cache), one target verify
(``forward_append``, gamma + 2 tokens over the full cache, into slots past
the live length) and one drafter proposal forward
(``draft_forward_spec``). For each it prints one line: the kernels
launched, their device ms, and both by family:

  gemm         cuBLAS's matrix products (the projections, the lm_head)
  flash_decode the attention kernels of ``csrc/flash_decode.cu``
  layer_glue   the kernels of ``csrc/layer_glue.cu`` (add + norm, RoPE,
               silu * up)
  other        every other kernel (elementwise, copies, gathers, masks)

with the ten largest kernels by device time. The last line of standard
output is one JSON object, also written to ``--out``. ``--root
portbench/tests/data --workload tiny.batch1 --device cpu`` rehearses on the
CPU (the profiler then records CPU operators, not device kernels: not
device numbers).
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "portbench"
sys.path[:0] = [str(BENCH), str(ROOT)]

import torch  # noqa: E402

import harness  # noqa: E402

from triforce_tpu_torch.models import llama  # noqa: E402

FAMILIES = (
    ("flash_decode", harness.FLASH_DECODE_KERNELS),
    ("layer_glue", ("add_rms_norm_kernel", "rope_kernel", "silu_mul_kernel")),
    ("gemm", ("nvjet", "gemm", "gemv", "cutlass", "xmma", "Kernel2")),
)


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def profiled(fn, dev):
    """``fn()`` once under the profiler: {kernel name: [count, device
    ms]}."""
    from torch.profiler import ProfilerActivity
    act = ProfilerActivity.CUDA if dev.type == "cuda" \
        else ProfilerActivity.CPU
    harness.sync(dev)
    with torch.profiler.profile(activities=[act]) as prof:
        fn()
        harness.sync(dev)
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if dev.type == "cpu":
            us = e.self_cpu_time_total
        if not us and dev.type == "cuda":
            continue
        name = harness.kernel_name(e.key)
        c, ms = out.get(name, (0, 0.0))
        out[name] = [c + e.count, ms + us / 1e3]
    return out


def summary(ops: dict) -> dict:
    fams = {}
    for name, (c, ms) in ops.items():
        f = fams.setdefault(family(name), [0, 0.0])
        f[0] += c
        f[1] += ms
    top = sorted(ops.items(), key=lambda x: -x[1][1])[:10]
    return {"kernels": sum(c for c, _ in ops.values()),
            "device_ms": sum(ms for _, ms in ops.values()),
            "families": {k: [c, round(ms, 4)]
                         for k, (c, ms) in sorted(fams.items())},
            "top": [[n, c, round(ms, 4)] for n, (c, ms) in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="mistral7b.ctx16k.triforce")
    ap.add_argument("--root", default=str(BENCH))
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--prompt", type=int, default=0,
                    help="tokens to prefill (0: the cell's prompt_len)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (use --device cpu to rehearse)")
    cell = harness.Cell.find(args.workload, Path(args.root))
    m, mix = cell.model, cell.mix
    prompt = args.prompt or mix["prompt_len"]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    weights = harness.make_weights(m, gen, dev)
    draft = harness.make_weights(m["drafter"], gen, dev)
    ids = harness.make_prompt(m["vocab_size"], prompt, gen, dev)[None]
    eng = harness.eager_twin(harness.build_engine(
        cell, weights, draft, prompt, prompt + 64, dev))
    cfg, sp = eng.target_cfg, eng.spec
    st = eng.prefill_draft(eng.prefill_target(eng.init_state(args.seed),
                                              ids), ids)
    g = sp.gamma

    def tokens(t):
        return torch.randint(3, cfg.vocab_size, (1, t), generator=gen,
                             device=dev)

    forwards = {
        "middle verify": lambda: llama.forward_spec(
            cfg, eng.t_params, tokens(g + 1), st.rkv, st.kv.seq_len,
            sp.budget, commit=False),
        # writes slots past the live length, which nothing reads
        "target verify": lambda: llama.forward_append(
            cfg, eng.t_params, tokens(g + 2), st.kv, **eng.fwd),
        "drafter": lambda: llama.draft_forward_spec(
            eng.draft_cfg, eng.d_params, tokens(g + 1), st.dkv, sp,
            commit=False),
    }
    record = {"workload": args.workload, "prompt": prompt, "forwards": {}}
    if dev.type == "cuda":
        record["device"] = torch.cuda.get_device_name(dev)
        record["power_limit_w"] = harness.power_limit_w()
    for name, fn in forwards.items():
        fn()                                   # warm-up: builds, caches
        s = summary(profiled(fn, dev))
        record["forwards"][name] = s
        print(f"{name}: {s['kernels']} kernels, {s['device_ms']:.4f} ms; "
              f"by family {s['families']}", flush=True)
    line = json.dumps(record)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
