"""Decoding drivers — the port of ``triforce_tpu/decoding.py``: the
autoregressive baseline, the TriForce hierarchy and retrieval-only
self-speculation.

Each driver runs on ``engine.device``; ``device`` defaults to the first
CUDA card and must match the engine's, so a call with no device on a
machine without CUDA raises instead of running on the CPU. Timings wait
for the device before reading the clock. With ``verbose`` the tokens are
streamed (``utils.misc.spec_stream``, through ``tokenizer`` when given)
after the timed loop, so no read-back enters the timed window. On a card
the engine captures its decode graphs inside the timed loop (the second
call of each region); ``DecodeResult.capture_s`` holds those seconds and
``wall_s`` (hence ``tokens_per_sec``) leaves them out. ``readbacks``
counts the host read-backs of the generation call: one (the tokens, at
the end) where the engine's loop replays graphs, more on an eager engine,
which reads every loop predicate back. The prefill is
timed apart (``prefill_s``, from the call's start to the first token's
read-back), and the graphs it captures are counted apart too
(``prefill_captures``, ``prefill_capture_s``, not in ``prefill_s``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

import torch

from .config import resolve_device
from .engine import Engine, TriForceState
from .models import llama
from .utils.misc import spec_stream


@dataclasses.dataclass
class DecodeResult:
    tokens: List[int]
    tokens_per_sec: float
    acceptance_rate: float = float("nan")
    avg_tokens_per_step: float = float("nan")
    middle_acceptance_rate: float = float("nan")
    steps: int = 0
    wall_s: float = 0.0
    middle_verifies: int = 0   # retrieval-cache verify forwards run
    captures: int = 0          # CUDA graphs captured during the run
    capture_s: float = 0.0     # their capture seconds (not in wall_s)
    prefill_s: float = 0.0     # prefill wall up to the first token
    prefill_captures: int = 0  # CUDA graphs captured in the prefill
    prefill_capture_s: float = 0.0   # their seconds (not in prefill_s)
    readbacks: int = 0         # host read-backs of the generation call


class _CaptureClock:
    """The capture seconds and count a graph set adds while it is open."""

    def __init__(self, graphs):
        self.graphs = graphs
        self.s0, self.n0 = graphs.capture_s, graphs.captures

    @property
    def seconds(self) -> float:
        return self.graphs.capture_s - self.s0

    @property
    def count(self) -> int:
        return self.graphs.captures - self.n0


class _Prefill:
    """The prefill's clock: started with the device idle, stopped after
    the first token's read-back; the graphs captured meanwhile are counted
    apart and their seconds left out of ``prefill_s``."""

    def __init__(self, engine: Engine):
        _sync(engine.device)
        self.clock = _CaptureClock(engine.graphs)
        self.t0 = time.perf_counter()
        self.fields = {}

    def stop(self) -> None:
        wall = time.perf_counter() - self.t0
        self.fields = dict(prefill_s=wall - self.clock.seconds,
                           prefill_captures=self.clock.count,
                           prefill_capture_s=self.clock.seconds)


def _check_device(engine: Engine, device) -> None:
    dev = resolve_device(device)
    if dev != engine.device:
        raise ValueError(f"driver asked for {dev}, engine is on "
                         f"{engine.device}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def autoregressive(engine: Engine, input_ids: torch.Tensor,
                   max_len: int = 256, seed: int = 0, verbose: bool = False,
                   tokenizer=None, device=None) -> DecodeResult:
    """Plain AR decoding baseline: chunked prefill, then ``max_len`` tokens
    with no host read-back until the end."""
    _check_device(engine, device)
    pre = _Prefill(engine)
    state = engine.init_state(seed)
    kv = engine.prefill_body(state.kv, input_ids[:, :-1])
    logits, kv, _ = llama.forward_append(engine.target_cfg, engine.t_params,
                                         input_ids[:, -1:], kv, **engine.fwd)
    token = engine._sample_next(logits, state.gen)
    first = int(token[0])     # read-back: prefill is done
    pre.stop()
    clock = _CaptureClock(engine.graphs)
    t0 = time.perf_counter()
    kv, token, _, buf = engine.generate_ar(kv, token, state.gen, max_len)
    toks = buf.tolist()       # read-back: generation is done
    wall = time.perf_counter() - t0 - clock.seconds
    out = [first] + toks
    if verbose:
        for t in out:
            spec_stream(t, tokenizer, "cyan")
    return DecodeResult(tokens=out, tokens_per_sec=max_len / wall,
                        steps=max_len, wall_s=wall, captures=clock.count,
                        capture_s=clock.seconds, readbacks=1, **pre.fields)


def _run_spec_loop(engine: Engine, state: TriForceState, mode: str,
                   max_len: int, stop_on_eos: bool, verbose: bool,
                   tokenizer, pre: "_Prefill") -> DecodeResult:
    first = int(state.next_token[0])   # read-back: prefill is done
    pre.stop()
    clock = _CaptureClock(engine.graphs)
    r0 = engine.graphs.readbacks
    t0 = time.perf_counter()
    state, buf, n, counters = engine.generate(state, max_len, mode=mode,
                                              stop_on_eos=stop_on_eos)
    out = buf[:n].tolist()             # the buffer is on the host
    wall = time.perf_counter() - t0 - clock.seconds
    assert out[0] == first
    (steps, accepted, proposed, resampled, bonus, mid_draft, mid_accept,
     mid_verify, _mid_live) = (int(x) for x in counters)
    if verbose:
        for t in out:
            spec_stream(t, tokenizer, "green")
    gen = n - 1   # tokens produced by speculation steps
    return DecodeResult(
        tokens=out, tokens_per_sec=gen / wall,
        acceptance_rate=accepted / max(proposed, 1),
        avg_tokens_per_step=gen / max(steps, 1),
        middle_acceptance_rate=mid_accept / max(mid_draft, 1),
        steps=steps, wall_s=wall, middle_verifies=mid_verify,
        captures=clock.count, capture_s=clock.seconds,
        readbacks=engine.graphs.readbacks - r0, **pre.fields)


def triforce(engine: Engine, input_ids: torch.Tensor, max_len: int = 256,
             seed: int = 0, verbose: bool = False, tokenizer=None,
             stop_on_eos: bool = False, draft_prefill_mode: str = "full",
             device=None) -> DecodeResult:
    """The full three-level hierarchy."""
    _check_device(engine, device)
    pre = _Prefill(engine)
    state = engine.init_state(seed)
    state = engine.prefill_target(state, input_ids)
    state = engine.prefill_draft(state, input_ids, mode=draft_prefill_mode)
    return _run_spec_loop(engine, state, "triforce", max_len, stop_on_eos,
                          verbose, tokenizer, pre)


def retrieval_spec(engine: Engine, input_ids: torch.Tensor,
                   max_len: int = 256, seed: int = 0, verbose: bool = False,
                   tokenizer=None, stop_on_eos: bool = False,
                   device=None) -> DecodeResult:
    """Self-speculation: target weights over the retrieval cache draft,
    the full-cache target verifies (lossless; no drafter level)."""
    _check_device(engine, device)
    pre = _Prefill(engine)
    state = engine.init_state(seed)
    state = engine.prefill_target(state, input_ids)
    return _run_spec_loop(engine, state, "retrieval", max_len, stop_on_eos,
                          verbose, tokenizer, pre)
