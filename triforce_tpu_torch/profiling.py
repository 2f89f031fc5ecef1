"""Profiling and tracing — the port of ``triforce_tpu/profiling.py``.

  * ``Timer`` / ``span`` — host-side phase timers that synchronise the
    device of a given tensor at both edges;
  * ``trace`` — ``torch.profiler`` over the CPU and, where there is one,
    the CUDA card, exported as a Chrome trace;
  * ``measure_phase_times`` — each decode phase (target verify, middle
    verify, AR step, retrieval build, drafter step) timed at its real
    shapes: the (draft_time, target_time) table the tree planner reads
    (``tree/planner.py``);
  * ``measure_acceptance_vector`` — per-branch acceptance from the real
    (q, p) rows of retrieval-speculation steps: the planner's ``p`` vector.

On a graphed engine (``Engine.graphs``) ``measure_phase_times`` times
each decode forward as the replay of its captured graph, as the decode
loop runs it; on an eager one it times the eager forward. The retrieval
build stays eager either way (it runs once per prefill and is not
captured).

The caches are updated in place (``cache.py``), so ``measure_phase_times``
runs only forwards that write nothing the state holds live
(``commit=False``, or a build into a scratch retrieval cache) and puts the
full cache's slots that the verify forwards write back as they were: the
caller's state is unchanged, bit for bit.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import numpy as np
import torch

from . import engine as engine_mod
from . import graphs as graphs_mod
from .models import llama
from .ops import sampling


def _sync(t) -> None:
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


class Timer:
    """Accumulating phase timer; ``span(name, sync=tensor)`` synchronises
    that tensor's device at both edges."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str, sync=None):
        _sync(sync)
        t0 = time.perf_counter()
        yield
        _sync(sync)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"total_s": tot, "count": self.counts[name],
                   "mean_ms": 1e3 * tot / max(self.counts[name], 1)}
            for name, tot in sorted(self.totals.items())
        }

    def pretty(self) -> str:
        rows = ["  {:<24} {:>8.2f} ms x{:<5d} {:>9.3f} s".format(
            k, v["mean_ms"], v["count"], v["total_s"])
            for k, v in self.report().items()]
        return "\n".join(rows)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (CPU activity, and CUDA where a
    card is present); yields the profiler, so the caller can read
    ``key_averages()``, and writes ``<log_dir>/trace.json`` (Chrome trace
    format) at the end."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _time_calls(fn, dev: torch.device, iters: int, warm: int = 2) -> float:
    """Seconds per ``fn()``: on a card, CUDA events around ``iters`` calls
    after ``warm`` of them; on the CPU, the host clock."""
    for _ in range(warm):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        return max(e0.elapsed_time(e1) * 1e-3 / iters, 1e-9)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return max((time.perf_counter() - t0) / iters, 1e-9)


@contextlib.contextmanager
def _slots_restored(kv, n: int, offset: int = 0):
    """Put the full cache's slots ``[seq_len, seq_len + n)``, which a
    forward_append of n tokens writes, back as they were afterwards.
    ``offset``: the global slot of ``kv``'s first one (a rank's shard of a
    cache split over ``sp``); the slots of the window it does not hold are
    left to their ranks."""
    s0 = int(kv.seq_len) - offset
    lo, hi = max(s0, 0), min(max(s0 + n, 0), kv.max_len)
    planes = [p for p in (kv.k, kv.v, kv.k_scale, kv.v_scale)
              if p is not None]
    saved = [p[:, :, :, lo:hi].clone() for p in planes]
    try:
        yield
    finally:
        for p, x in zip(planes, saved):
            p[:, :, :, lo:hi] = x


def measure_phase_times(engine, state, iters: int = 20) -> Dict[str, float]:
    """Per-phase seconds for a prefilled engine state. Keys:
    ``target_verify`` (full-cache forward of gamma+2 tokens),
    ``middle_step`` (one retrieval-cache verify of gamma+1 tokens),
    ``ar_step``, ``retrieval_build`` (the 1-token forward that builds the
    retrieval cache, into a scratch copy of it) and, with a drafter,
    ``draft_step``. Each is timed over ``iters`` calls after a warm-up (on
    a graphed engine the warm-up captures, and the timed calls are
    replays); ``state`` is left as it was. Over a mesh every rank calls
    it and times its own forwards, collectives included."""
    cfg, sp = engine.target_cfg, engine.spec
    dev = engine.device
    gamma = sp.gamma
    kv = state.kv
    ids = {t: torch.zeros((1, t), dtype=torch.int64, device=dev)
           for t in (1, gamma + 1, gamma + 2)}
    out: Dict[str, float] = {}

    def phase(name, region, inputs, cache):
        return lambda: engine.graphs.run("phase " + name, region, inputs,
                                         caches=graphs_mod.planes(cache))

    def verify(t):
        return phase(f"verify {t}", lambda x, n: llama.forward_append(
            cfg, engine.t_params, x, engine_mod._kv_at(kv, n),
            **engine.fwd)[:1], (ids[t], kv.seq_len), kv)

    offset = engine.mesh.index("sp") * kv.max_len if engine.shard_seq else 0
    with _slots_restored(kv, gamma + 2, offset):
        out["target_verify"] = _time_calls(verify(gamma + 2), dev, iters)
        out["ar_step"] = _time_calls(verify(1), dev, iters)
        scratch = state.rkv.clone()
        out["retrieval_build"] = _time_calls(
            lambda: engine._build(kv, scratch, ids[1]), dev,
            max(2, iters // 2))
        del scratch
    out["middle_step"] = _time_calls(phase(
        "middle", lambda x, n: llama.forward_spec(
            cfg, engine.t_params, x, state.rkv, n, sp.budget, commit=False,
            act_quant=sp.mid_act_quant, mesh=engine.mesh)[:1],
        (ids[gamma + 1], kv.seq_len), state.rkv), dev, iters)
    if engine.draft_cfg is not None:
        out["draft_step"] = _time_calls(phase(
            "draft", lambda x: llama.draft_forward_spec(
                engine.draft_cfg, engine.d_params, x, state.dkv, sp,
                commit=False)[:1],
            (ids[gamma + 1],), state.dkv), dev, iters)
    return out


def _accept_walk(q, p, cand, rs):
    """The SpecTree accept chain over P real (q, p) rows at once: the
    candidates ``cand`` [P, K] (drawn from q without replacement) are
    rejection-tested in order against p with residual updates. Returns
    [P] the 1-based index of the first accept (0 = none)."""
    rows = torch.arange(q.shape[0], device=q.device)
    accepted = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    for b in range(cand.shape[1]):
        tok = cand[:, b]
        ok = (accepted == 0) & (p[rows, tok]
                                > rs[:, b] * q[rows, tok].clamp_min(1e-37))
        accepted = torch.where(ok, b + 1, accepted)
        upd = (accepted == 0)[:, None]              # rejected: update dists
        resid = (p - q).clamp_min(0)
        p2 = resid / resid.sum(-1, keepdim=True).clamp_min(1e-37)
        q2 = q.clone()
        q2[rows, tok] = 0.0
        q2 = q2 / q2.sum(-1, keepdim=True).clamp_min(1e-37)
        q = torch.where(upd, q2, q)
        p = torch.where(upd, p2, p)
    return accepted


def measure_acceptance_vector(engine, input_ids, max_branch: int = 4,
                              steps: int = 32, seed: int = 0,
                              state=None) -> np.ndarray:
    """Empirical per-branch acceptance vector for the tree planner, from
    the real hierarchy: ``steps`` retrieval-speculation steps, each
    exposing the middle (q) and target (p) rows of its gamma proposal
    positions (``return_probs``). For every real (q, p) pair ``max_branch``
    candidates are drawn from q without replacement (Gumbel top-k) and
    rejection-tested in order against p with residual updates; p[b] is
    the share of positions whose first accept was candidate b. The draws
    come from a ``torch.Generator`` seeded from ``seed``, so the result is
    deterministic. A ``state`` passed in is prefilled and consumed (its
    caches are updated in place)."""
    if state is None:
        state = engine.init_state(seed)
        state = engine.prefill_target(state, input_ids)
    gamma = engine.spec.gamma
    dev = engine.device
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    wins = torch.zeros(max_branch + 1, dtype=torch.float32, device=dev)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(steps):
        state, _stats, (_toks, q_rows, p_rows) = \
            engine_mod._retrieval_spec_step(engine, state,
                                            return_probs=True)
        q = q_rows[:gamma].float()
        p = p_rows[:gamma].float()
        cand = sampling.gumbel_topk_without_replacement(q, max_branch, gen)
        rs = torch.rand((gamma, max_branch), generator=gen, device=dev)
        acc = _accept_walk(q, p, cand, rs)
        valid = (q.sum(-1) > 0).float()
        wins.index_add_(0, acc, valid)
        total += valid.sum()
    wins = wins.double().cpu().numpy()
    wins[0] = 0.0        # bucket 0 = no accept: counts only in the total
    return wins / max(float(total), 1.0)
