"""Build and load the port's CUDA kernels (``csrc/*.cu``), its
conditional graph nodes and the trace's device timer
(``csrc/graph_cond.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, all sources at once (one ``nvcc`` process
each, started together), and loaded with ``ctypes``. Libraries live in
``_build/<hash>/`` next to this file, keyed by a hash of the sources and
flags, so a checkout builds at its first CUDA use and later calls in the
same process (or a later process on the same checkout) reuse the result.

Nothing here runs at import, so the package imports on machines without
``nvcc`` (the CPU tests import every module). A failed build raises with
the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_ROOT = _HERE / "_build"
SOURCES = ("flash_decode.cu", "chunk_scores.cu", "layer_glue.cu",
           "graph_cond.cu", "moe.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of the entry points, by library
_SIGNATURES = {
    "flash_decode.cu": {
        "tf_flash_decode_set_pdl": [_I],
        "tf_flash_decode_parts": [_I, _I],
        "tf_flash_decode_cta_rows": [_I],
        "tf_flash_decode_ctas_per_sm": [_I, _I, _I],
        "tf_flash_decode_bf16": [_P, _L, _L, _P, _L, _L, _P, _L, _L,
                                 _P, _L, _L, _P, _L, _L, _P, _P,
                                 _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _F, _P],
        # as tf_flash_decode_bf16, then the window and the new tokens
        "tf_flash_decode_window_bf16": [_P, _L, _L, _P, _L, _L, _P, _L, _L,
                                        _P, _L, _L, _P, _L, _L, _P, _P,
                                        _P, _P, _P, _P,
                                        _I, _I, _I, _I, _I, _I, _F, _I, _I,
                                        _P],
        "tf_flash_decode_int8": [_P, _L, _L, _P, _L, _L, _P, _L, _L,
                                 _P, _L, _P, _L,
                                 _P, _L, _L, _P, _L, _L, _P, _P,
                                 _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _F, _P],
        # row-batched: B first, a row stride before each head stride, and
        # the mask's row stride
        "tf_flash_decode_batched_bf16": [_I, _P, _L, _L, _L, _P, _L, _L, _L,
                                         _P, _L, _L, _L,
                                         _P, _L, _L, _L, _P, _L, _L, _L,
                                         _L, _P, _P, _P, _P, _P, _P,
                                         _I, _I, _I, _I, _I, _I, _F, _P],
        "tf_flash_decode_batched_int8": [_I, _P, _L, _L, _L, _P, _L, _L, _L,
                                         _P, _L, _L, _L,
                                         _P, _L, _L, _P, _L, _L,
                                         _P, _L, _L, _L, _P, _L, _L, _L,
                                         _L, _P, _P, _P, _P, _P, _P,
                                         _I, _I, _I, _I, _I, _I, _F, _P],
        # cache-only partials: q, k, v (+ scales), k_len, scratch x3, out x3
        "tf_flash_decode_partials_bf16": [_P, _L, _L, _P, _L, _L, _P, _L, _L,
                                          _P, _P, _P, _P, _P, _P, _P,
                                          _I, _I, _I, _I, _I, _F, _P],
        "tf_flash_decode_partials_int8": [_P, _L, _L, _P, _L, _L, _P, _L, _L,
                                          _P, _L, _P, _L,
                                          _P, _P, _P, _P, _P, _P, _P,
                                          _I, _I, _I, _I, _I, _F, _P],
    },
    "chunk_scores.cu": {
        "tf_chunk_scores_ctas_per_sm": [_I, _I],
        # ..., prefill, chunk, then the plan: chunks a block, blocks a head
        "tf_chunk_scores_bf16": [_P, _P, _L, _L, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _P],
        # q, then 1 if q is bf16 (0: fp32)
        "tf_chunk_scores_int8": [_P, _I, _P, _L, _L, _P, _L, _P, _I, _I,
                                 _I, _I, _I, _I, _I, _P],
    },
    "layer_glue.cu": {
        # x, y (or null), w, x + y, h, rows, hidden, 1 / hidden, eps, dtype
        "tf_add_rms_norm": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _I, _P],
        # per tensor x, out, B / H / T strides, heads (the second: heads 0
        # when absent); positions, their row stride, cos, sin, table rows,
        # B, T, D, dtype
        "tf_rope": [_P, _P, _L, _L, _L, _I, _P, _P, _L, _L, _L, _I,
                    _P, _L, _P, _P, _L, _I, _I, _I, _I, _P],
        # gate, up, out, elements, dtype
        "tf_silu_mul": [_P, _P, _P, _L, _I, _P],
    },
    "moe.cu": {
        # h, router, N, hidden, experts, top k, renormalise, ids, weights,
        # counts (or null)
        "tf_moe_route": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
        # h, ids, weights, gate, up, down, act and y scratch, out, N, K,
        # hidden, expert width, experts, counts (or null)
        "tf_moe_experts": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _P, _P],
        # y, weights, out, N, K, hidden
        "tf_moe_combine": [_P, _P, _P, _I, _I, _I, _P],
    },
    "graph_cond.cu": {
        # parent (capturing) stream, the bool predicate, child stream
        "tf_cond_begin": [_P, _P, _P],
        "tf_cond_end": [_P],
        # stream, head (uint64), ring [capacity, 2] int64, capacity, code
        "tf_stamp": [_P, _P, _P, _L, _L],
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}   # ptxas resource report per source


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels cannot be built")
    return found


def _key() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> dict[str, Path]:
    """Compile every source not yet built for this hash, in parallel.
    Returns {source name: library path}."""
    out_dir = BUILD_ROOT / _key()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / (Path(name).stem + ".so") for name in SOURCES}
    todo = [n for n in SOURCES if not libs[n].exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        # write to a temporary name, then rename: a reader never sees a
        # half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / name)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return libs


def lib(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built on first use."""
    if source not in _LIBS:
        path = build()[source]
        handle = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES[source].items():
            f = getattr(handle, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[source] = handle
    return _LIBS[source]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: cudaError_t {err}")
