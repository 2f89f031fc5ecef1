"""Decoding drivers — the port of ``triforce_tpu/decoding.py``: the
autoregressive baseline, the TriForce hierarchy and retrieval-only
self-speculation.

Each driver runs on ``engine.device``; ``device`` defaults to the first
CUDA card and must match the engine's, so a call with no device on a
machine without CUDA raises instead of running on the CPU. Timings wait
for the device before reading the clock. With ``verbose`` the tokens are
streamed (``utils.misc.spec_stream``, through ``tokenizer`` when given)
after the timed loop, so no read-back enters the timed window.
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
    state = engine.init_state(seed)
    kv = engine.prefill_body(state.kv, input_ids[:, :-1])
    logits, kv, _ = llama.forward_append(engine.target_cfg, engine.t_params,
                                         input_ids[:, -1:], kv)
    token = engine._sample_next(logits, state.gen)
    first = int(token[0])     # read-back: prefill is done
    t0 = time.perf_counter()
    kv, token, _, buf = engine.generate_ar(kv, token, state.gen, max_len)
    toks = buf.tolist()       # read-back: generation is done
    t1 = time.perf_counter()
    out = [first] + toks
    if verbose:
        for t in out:
            spec_stream(t, tokenizer, "cyan")
    return DecodeResult(tokens=out, tokens_per_sec=max_len / (t1 - t0),
                        steps=max_len, wall_s=t1 - t0)


def _run_spec_loop(engine: Engine, state: TriForceState, mode: str,
                   max_len: int, stop_on_eos: bool, verbose: bool,
                   tokenizer) -> DecodeResult:
    first = int(state.next_token[0])   # read-back: prefill is done
    t0 = time.perf_counter()
    state, buf, n, counters = engine.generate(state, max_len, mode=mode,
                                              stop_on_eos=stop_on_eos)
    out = buf[:n].tolist()
    t1 = time.perf_counter()
    assert out[0] == first
    (steps, accepted, proposed, resampled, bonus, mid_draft, mid_accept,
     mid_verify, _mid_live) = (int(x) for x in counters)
    if verbose:
        for t in out:
            spec_stream(t, tokenizer, "green")
    gen = n - 1   # tokens produced by speculation steps
    return DecodeResult(
        tokens=out, tokens_per_sec=gen / (t1 - t0),
        acceptance_rate=accepted / max(proposed, 1),
        avg_tokens_per_step=gen / max(steps, 1),
        middle_acceptance_rate=mid_accept / max(mid_draft, 1),
        steps=steps, wall_s=t1 - t0, middle_verifies=mid_verify)


def triforce(engine: Engine, input_ids: torch.Tensor, max_len: int = 256,
             seed: int = 0, verbose: bool = False, tokenizer=None,
             stop_on_eos: bool = False, draft_prefill_mode: str = "full",
             device=None) -> DecodeResult:
    """The full three-level hierarchy."""
    _check_device(engine, device)
    state = engine.init_state(seed)
    state = engine.prefill_target(state, input_ids)
    state = engine.prefill_draft(state, input_ids, mode=draft_prefill_mode)
    _sync(engine.device)
    return _run_spec_loop(engine, state, "triforce", max_len, stop_on_eos,
                          verbose, tokenizer)


def retrieval_spec(engine: Engine, input_ids: torch.Tensor,
                   max_len: int = 256, seed: int = 0, verbose: bool = False,
                   tokenizer=None, stop_on_eos: bool = False,
                   device=None) -> DecodeResult:
    """Self-speculation: target weights over the retrieval cache draft,
    the full-cache target verifies (lossless; no drafter level)."""
    _check_device(engine, device)
    state = engine.init_state(seed)
    state = engine.prefill_target(state, input_ids)
    _sync(engine.device)
    return _run_spec_loop(engine, state, "retrieval", max_len, stop_on_eos,
                          verbose, tokenizer)
