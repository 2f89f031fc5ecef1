"""B2 / B2-int8 (``triforce_tpu_torch/csrc/chunk_scores.cu``) under other
key rings: the kernel's source rebuilt with another stage count and stage
size, timed beside the source as it stands, at both models' retrieval
builds (prefill 32768, chunk 8): Llama2-7B (Hkv 32, G 1, D 128) and
TinyLlama-1.1B-128K (Hkv 4, G 8, D 64).

Each variant is built from a copy of the source with ``STAGES``,
``STAGE_KEY_BYTES`` and the score ring's size (``SCORES``, which must hold
two stages of keys and a chunk) replaced, into ``triforce_tpu_torch/_build/``
under a name of its own, with the port's nvcc flags, all variants at once.
Each variant is timed under the wrapper's plan for its own occupancy
(``block_plan``) and under one wave of long runs, and its output is held
bit-equal to the port's wrapper first (a chunk's score does not depend on
the block or the ring). Device ms: 20 calls captured in a CUDA graph, the
median of 10 replays over 20; the variants are run in turn, twice.

Run on a card from the repository root:

    python3 probes/torch_b2_ring_variants.py
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from triforce_tpu_torch import _build, cache  # noqa: E402
from triforce_tpu_torch.ops import retrieval_kernel as rk  # noqa: E402

# name: (stages, stage bytes)
VARIANTS = {"S3x16K": (3, 16384), "S4x16K": (4, 16384),
            "S5x16K": (5, 16384), "S2x32K": (2, 32768)}
# model: (Hkv, G, D)
SHAPES = {"7B": (32, 1, 128), "GQA": (4, 8, 64)}
PREFILL, CHUNK = 32768, 8


def build_variants():
    """{variant: loaded library}, each built from an edited copy of the
    source (nvcc processes started together)."""
    src = (_build.CSRC / rk._SOURCE).read_text()
    out = _build.BUILD_ROOT / "ring_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (stages, nbytes) in VARIANTS.items():
        text = src
        for const, val in (("STAGES", stages), ("STAGE_KEY_BYTES", nbytes),
                           ("SCORES", 1024 if nbytes <= 16384 else 2048)):
            text, n = re.subn(rf"constexpr int {const} = \d+;",
                              f"constexpr int {const} = {val};", text)
            assert n == 1, const
        cu = out / f"{name}.cu"
        cu.write_text(text)
        so = out / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _build._SIGNATURES[rk._SOURCE].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def device_ms(fn, calls=20, reps=10):
    fn()
    torch.cuda.synchronize()
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with torch.cuda.stream(side):
        fn()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(calls):
                fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    ms = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end) / calls)
    return sorted(ms)[reps // 2]


def inputs(dev, hkv, g, d, quant):
    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((hkv, g, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((hkv, PREFILL + 200, d), generator=gen,
                    device=dev).to(torch.bfloat16)
    if not quant:
        return q, k, None, rk.chunk_scores(q, k, chunk=CHUNK, prefill=PREFILL)
    k, ks = cache.quantize_tokens(k)
    return q, k, ks, rk.chunk_scores_int8(q, k, ks, chunk=CHUNK,
                                          prefill=PREFILL)


def entry(lib, q, k, ks, out, hkv, g, d, cpb, bph):
    stream = torch.cuda.current_stream().cuda_stream
    if ks is None:
        return lib.tf_chunk_scores_bf16(
            q.data_ptr(), k.data_ptr(), k.stride(0), k.stride(1),
            out.data_ptr(), hkv, g, d, PREFILL, CHUNK, cpb, bph, stream)
    return lib.tf_chunk_scores_int8(
        q.data_ptr(), 1, k.data_ptr(), k.stride(0), k.stride(1),
        ks.data_ptr(), ks.stride(0), out.data_ptr(), hkv, g, d, PREFILL,
        CHUNK, cpb, bph, stream)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    t0 = time.perf_counter()
    libs = build_variants()
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = PREFILL // CHUNK
    res = {}
    for rep in range(2):
        for model, (hkv, g, d) in SHAPES.items():
            for quant in (False, True):
                q, k, ks, want = inputs(dev, hkv, g, d, quant)
                rb = d * (1 if quant else 2)
                for name, lib in libs.items():
                    per_sm = lib.tf_chunk_scores_ctas_per_sm(d, int(quant))
                    wave = -(-n // max(1, sms * per_sm // hkv))
                    plans = {"plan": rk.block_plan(hkv, n, CHUNK, rb, sms,
                                                   per_sm),
                             "wave": (wave, -(-n // wave))}
                    key = (f"{name} ({per_sm}/SM) "
                           f"{'int8' if quant else 'bf16'} {model}")
                    row = res.setdefault(key, {})
                    for what, (cpb, bph) in plans.items():
                        out = torch.empty_like(want)
                        if entry(lib, q, k, ks, out, hkv, g, d, cpb, bph):
                            raise RuntimeError(f"{key}: launch refused")
                        torch.cuda.synchronize()
                        if not torch.equal(out, want):
                            raise RuntimeError(f"{key} {what}: not the "
                                               "wrapper's bits")
                        ms = device_ms(lambda: entry(lib, q, k, ks, out, hkv,
                                                     g, d, cpb, bph))
                        row.setdefault(f"{what} {cpb}", []).append(ms)
                    print(f"rep {rep} {key}: " + ", ".join(
                        f"{w}: {v[-1]:.4f}" for w, v in row.items()),
                        flush=True)
                del q, k, ks, want
    print("ring variants " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
