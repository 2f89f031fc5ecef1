"""The harness's shared machinery: finding a cell's files by name, making
the weights and prompts from the seed, building the port's engine, timing
graph replays, profiling the eager witness and reading the card.

A cell is ``workloads/<cell>.json`` (its configuration, traffic mix,
chips, the limits of its correctness readings and its ``why``); its
configuration is ``configs/<config>.json`` and its traffic mix
``traffic/<mix>.json``, whose ``driver`` names ``traffic/<driver>.py``.
A per-layer metric ``<name>`` is read by ``metrics/<name>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import subprocess
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the harness loaded from its file (names may hold
    dots, so not by import)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict        # workloads/<cell>.json
    model: dict       # configs/<config>.json
    mix: dict         # traffic/<mix>.json

    @classmethod
    def find(cls, name: str, root: Path = HERE) -> "Cell":
        spec = load_json(root / "workloads" / f"{name}.json")
        return cls(name, spec,
                   load_json(root / "configs" / f"{spec['config']}.json"),
                   load_json(root / "traffic" / f"{spec['traffic']}.json"))

    def driver(self, root: Path = HERE):
        return load_module(root / "traffic" / f"{self.mix['driver']}.py")


def port_configs(m: dict):
    """The port's (target, drafter, speculation) configurations from a
    configuration file."""
    from triforce_tpu_torch.config import ModelConfig, RopeConfig, SpecConfig

    def one(c, on_slots):
        sc = c.get("rope_scaling")
        if sc:
            rope = RopeConfig(kind=sc["type"], theta=float(c["rope_theta"]),
                              scaling_factor=float(sc["factor"]),
                              original_max_position_embeddings=int(
                                  sc["original_max_position_embeddings"]))
        else:
            rope = RopeConfig(kind="llama", theta=float(c["rope_theta"]))
        return ModelConfig(
            vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
            intermediate_size=c["intermediate_size"],
            num_layers=c["num_hidden_layers"],
            num_heads=c["num_attention_heads"],
            num_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
            max_position_embeddings=c["max_position_embeddings"],
            rms_norm_eps=c["rms_norm_eps"], rope=rope, rope_on_slots=on_slots)

    s = m["speculation"]
    spec = SpecConfig(gamma=s["gamma"], budget=s["budget"],
                      chunk_size=s["chunk_size"],
                      temperature=s["temperature"], top_p=s["top_p"],
                      draft_start_size=s["draft_start_size"],
                      draft_recent_size=s["draft_recent_size"])
    return one(m, False), one(m["drafter"], True), spec


def make_weights(m: dict, gen: torch.Generator, device,
                 dtype=torch.bfloat16, embed_std: float = 1.0,
                 outlier_rows: int = 4, outlier_factor: float = 16.0
                 ) -> dict:
    """Random weights in the port's layout (``x @ w``, stacked over
    layers), made on ``device`` from ``gen`` in a few calls a leaf.

    The embedding is N(0, embed_std): at unit RMS every block adds a
    small part to a residual stream that keeps the token's signal, so 32
    random layers do not amplify a rounding as a chaotic map does. The
    matrices are N(0, 0.02), the two that write into the residual stream
    (``wo``, ``w_down``) N(0, 0.02 / sqrt(2 * layers)) as GPT-2 scales
    them, and in every matrix ``outlier_rows`` input rows, drawn from
    ``gen``, are ``outlier_factor`` times larger: the outlier features of
    trained models, which set a per-channel int8 scale. Norm gains are
    1 + N(0, 0.1)."""
    h, i, d = m["hidden_size"], m["intermediate_size"], m["head_dim"]
    hq, hkv = m["num_attention_heads"] * d, m["num_key_value_heads"] * d
    n, v = m["num_hidden_layers"], m["vocab_size"]

    def randn(*shape, std):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dtype).mul_(std)

    def mat(*shape, std=0.02):
        w = randn(*shape, std=std)
        if outlier_rows:
            pick = torch.rand(shape[:-1], generator=gen, device=device
                              ).argsort(-1)[..., :outlier_rows]
            boost = torch.ones(shape[:-1], device=device, dtype=dtype)
            w.mul_(boost.scatter_(-1, pick, outlier_factor)[..., None])
        return w

    out_std = 0.02 / (2 * n) ** 0.5

    def gain(*shape):
        return randn(*shape, std=0.1).add_(1.0)

    return {
        "embed": randn(v, h, std=embed_std),
        "layers": {"wq": mat(n, h, hq), "wk": mat(n, h, hkv),
                   "wv": mat(n, h, hkv), "wo": mat(n, hq, h, std=out_std),
                   "w_gate": mat(n, h, i), "w_up": mat(n, h, i),
                   "w_down": mat(n, i, h, std=out_std), "ln_attn": gain(n, h),
                   "ln_mlp": gain(n, h)},
        "final_norm": gain(h),
        "lm_head": mat(h, v),
    }


def make_prompt(vocab: int, n: int, gen: torch.Generator, device):
    """``n`` token ids drawn uniformly from ``[3, vocab)`` (no special
    ids), on ``device``."""
    return torch.randint(3, vocab, (n,), generator=gen, device=device)


def build_engine(cell: Cell, weights: dict, draft: dict, prompt: int,
                 max_cache_len: int, device, control: bool = False):
    """The port's batch-1 engine over the cell's configuration;
    ``control`` is the program's own int8 path (weights and KV)."""
    from triforce_tpu_torch.engine import Engine
    tcfg, dcfg, spec = port_configs(cell.model)
    return Engine(tcfg, spec, weights, draft_cfg=dcfg, draft_params=draft,
                  prefill=prompt, max_cache_len=max_cache_len,
                  kv_quant=control, weight_quant=control, device=device)


def eager_twin(eng):
    """The eager witness of a graphed engine: the same configurations and
    weights (shared), ``graphs=False``."""
    from triforce_tpu_torch.engine import Engine
    return Engine(eng.target_cfg, eng.spec, eng.t_params,
                  draft_cfg=eng.draft_cfg, draft_params=eng.d_params,
                  prefill=eng.prefill, max_cache_len=eng.max_cache_len,
                  eos_token_id=eng.eos_token_id, dtype=eng.dtype,
                  prefill_chunk=eng.prefill_chunk,
                  draft_prefill_chunk=eng.draft_prefill_chunk,
                  kv_quant=eng.kv_quant, device=eng.device, graphs=False)


def cache_planes(cache, idx: tuple, length: int):
    """float32 K and V [Hkv, length, D] of one layer of a cache: ``idx``
    is (layer, 0) in a batch-1 cache, (row, layer) in a row-stacked one;
    int8 codes are dequantized with their scales."""
    out = []
    for name in ("k", "v"):
        x = getattr(cache, name)[idx][:, :length].float()
        sc = getattr(cache, name + "_scale")
        if sc is not None:
            x = x * sc[idx][:, :length, None]
        out.append(x)
    return out


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class ReplayClock:
    """CUDA events just before and after every CUDA-graph replay while
    open, each tagged with the host phase (``phase``) and the host call
    (``call``, counted by the driver) it ran in. The busy seconds are the
    sum of the replays' device times; a gap is the device time from one
    replay's end to the next one's start, named by what the host was
    doing: inside one call, or between two phases or calls. The profiler
    does not serve inside the window: CUPTI crashes on graphs that hold
    conditional nodes."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.marks = []
        self.phase = ""
        self.call = 0
        self._orig = None

    def __enter__(self):
        if self.enabled:
            self._orig = orig = torch.cuda.CUDAGraph.replay
            marks = self.marks

            def timed(graph):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                orig(graph)
                b.record()
                marks.append((a, b, self.phase, self.call))
            torch.cuda.CUDAGraph.replay = timed
        return self

    def __exit__(self, *exc):
        if self._orig is not None:
            torch.cuda.CUDAGraph.replay = self._orig
            self._orig = None

    def busy_s(self) -> float:
        return sum(m[0].elapsed_time(m[1]) for m in self.marks) / 1e3

    def gaps(self, n: int = 10) -> list:
        out = []
        for (_, b, p0, c0), (a, _, p1, c1) in zip(self.marks,
                                                  self.marks[1:]):
            name = f"inside one {p0}" if (p0, c0) == (p1, c1) \
                else f"between {p0} and {p1}"
            out.append((name, b.elapsed_time(a) / 1e3))
        out.sort(key=lambda x: -x[1])
        return [[name, s] for name, s in out[:n]]


def kernel_name(key: str) -> str:
    return key.replace("(anonymous namespace)::", "").split("(")[0]


def profile(fn, device):
    """``fn()`` under ``torch.profiler`` (the card's activity, or the
    CPU's off the card): its result and the device seconds of each
    operation by name."""
    from torch.profiler import ProfilerActivity
    act = ProfilerActivity.CUDA if torch.device(device).type == "cuda" \
        else ProfilerActivity.CPU
    sync(device)
    with torch.profiler.profile(activities=[act]) as prof:
        out = fn()
        sync(device)
    ops = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if us:
            name = kernel_name(e.key)
            ops[name] = ops.get(name, 0.0) + us / 1e6
    return out, ops


FLASH_DECODE_KERNELS = ("fd_decode_kernel", "fd_reduce_kernel",
                        "fd_wide_kernel", "fd_wide_fold_kernel",
                        "fd_wide_merge_kernel")


def flash_decode_s(ops: dict) -> float:
    """Device seconds of the flash-decode kernels (B1 and B3 share
    them) in a profile."""
    return sum(s for k, s in ops.items()
               if any(k.startswith(n) or f" {n}" in k
                      for n in FLASH_DECODE_KERNELS))


def top_ops(ops: dict, n: int = 10) -> list:
    return [[k, s] for k, s in sorted(ops.items(), key=lambda x: -x[1])[:n]]


def power_limit_w():
    """The card's power limit in watts, or None where nvidia-smi cannot
    say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def device_record(device, count: int) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError("no device record off the card")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
            "power_limit_w": power_limit_w()}


class Clock:
    """Host seconds since construction, the device synchronised first."""

    def __init__(self, device):
        self.device = device
        sync(device)
        self.t0 = time.perf_counter()

    def __call__(self) -> float:
        sync(self.device)
        return time.perf_counter() - self.t0
