"""Traffic driver ``batch1_forced``: one long document at batch 1, decoded
by forced-acceptance TriForce in back-to-back calls.

Parameters (the mix's file): ``prompt_len`` (the engine's fixed prompt
length), ``max_cache_len``, ``call_tokens`` (tokens a
``generate_forced`` call asks for) and ``warmup_calls``.

Set-up makes the weights, the drafter and the prompt from the seed,
builds the engine, and captures every graph the run replays: two prefill
chunks, the last slice (the ragged remainder and the retrieval build)
twice, two drafter chunks. Then ``ttft_s``: the prompt handed to
``Engine.prefill_target`` and ``prefill_draft`` until the first token is
read back, every graph replayed. Then ``warmup_calls`` generation calls,
the first of which captures the loop graph. The window runs whole calls
until ``seconds`` have passed; ``decode_ms_per_token`` is its wall over
the tokens the calls emitted. Before each call the cache's room is
checked, and a call that would not fit stops the run.

The traced run (``trace``) times every replay of the window with CUDA
events, then reads ``profiling.measure_phase_times`` at the window's
context and profiles a few steps of the eager witness (which continue
the same sequence). Then the program's caches are held against the
reference (``reference/check.py``).
"""

from __future__ import annotations

import dataclasses
import time

import torch

import harness
from reference import check


def _fresh(st, seed: int):
    """The state with its caches emptied (the same buffers, so the
    captured graphs replay) and its generator seeded with ``seed``."""
    from triforce_tpu_torch.engine import TriForceState
    zero = torch.zeros_like
    return TriForceState(
        kv=dataclasses.replace(st.kv, seq_len=zero(st.kv.seq_len)),
        rkv=st.rkv,
        dkv=dataclasses.replace(st.dkv, seq_len=zero(st.dkv.seq_len)),
        next_token=zero(st.next_token), gen=st.gen.manual_seed(seed))


class _Seq:
    """The token sequence the full cache must hold: the prompt, then of
    each call every token but the last (the pending next token, which
    the next call emits first)."""

    def __init__(self, prompt: torch.Tensor):
        self.parts = [prompt.cpu()]
        self.pending = None
        self.breaks = 0

    def add(self, buf: torch.Tensor, n: int) -> int:
        if self.pending is not None and int(buf[0]) != self.pending:
            self.breaks += 1
        self.parts.append(buf[:n - 1].clone())
        self.pending = int(buf[n - 1])
        return n - 1

    def ids(self, device) -> torch.Tensor:
        return torch.cat(self.parts).to(device)


class _Prog:
    """What the judge reads of a finished batch-1 run."""

    def __init__(self, st, length, prompt, spec, build):
        self.st, self.length, self.prompt = st, length, prompt
        self.budget, self.chunk = spec.budget, spec.chunk_size
        self.build_groups = spec.budget // spec.chunk_size
        self._build = build

    def kv(self, li):
        return harness.cache_planes(self.st.kv, (li, 0), self.length)

    def rkv(self, li):
        return harness.cache_planes(self.st.rkv, (li, 0), self.budget)

    def build(self, li):
        dev = self.st.kv.k.device
        k, v, ks, vs = (None if x is None else x[li].to(dev)
                        for x in self._build)
        if ks is not None:
            return k.float() * ks[..., None], v.float() * vs[..., None]
        return k.float(), v.float()


def run(ctx) -> dict:
    cell, dev, seed = ctx.cell, ctx.device, ctx.seed
    m, mix = cell.model, cell.mix
    prompt, room = mix["prompt_len"], mix["max_cache_len"]
    n_call = mix["call_tokens"]
    alpha = m["speculation"]["force_accept"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    weights = harness.make_weights(m, gen, dev)
    draft = harness.make_weights(m["drafter"], gen, dev)
    ids = harness.make_prompt(m["vocab_size"], prompt, gen, dev)[None]
    eng = harness.build_engine(cell, weights, draft, prompt, room, dev,
                               control=ctx.control)
    sp = eng.spec
    c = eng.prefill_chunk

    # capture every prefill graph: chunks, last slice (remainder + build)
    st = eng.init_state(seed)
    st, _, _ = eng.prefill_target_partial(st, ids, 0, 2)
    last = ((prompt - 1) // c) * c
    for _ in range(2):
        st, _, _ = eng.prefill_target_partial(st, ids, last, 1)
    st = eng.prefill_draft(st, ids[:, :2 * eng.draft_prefill_chunk])
    st = _fresh(st, seed)

    clock = harness.Clock(dev)
    st = eng.prefill_target(st, ids)
    st = eng.prefill_draft(st, ids)
    int(st.next_token[0])                           # the first token
    ttft = clock()
    rk = st.rkv
    build = tuple(None if x is None else x[:, 0, :, :sp.budget].to(
                      "cpu", copy=True)
                  for x in (rk.k, rk.v, rk.k_scale, rk.v_scale))

    seq = _Seq(ids[0])
    length = prompt

    def call(engine, n):
        nonlocal st, length
        if length + n + 2 * (sp.gamma + 2) > room:
            raise RuntimeError(f"the cache has room for {room} tokens; "
                               f"{length} are cached and a call may add "
                               f"{n + 2 * (sp.gamma + 2)}")
        st, buf, k, counters = engine.generate_forced(st, n, alpha,
                                                      mode="triforce")
        length += seq.add(buf, k)
        return k - 1, counters

    for _ in range(mix["warmup_calls"]):
        call(eng, n_call)
    setup_s = ctx.since_start()

    replays = harness.ReplayClock(ctx.trace and dev.type == "cuda")
    replays.phase = "generate_forced call"
    tokens, calls, short = 0, 0, 0
    sums = torch.zeros(9, dtype=torch.int64)
    len0 = length
    with replays:
        harness.sync(dev)
        t0 = time.perf_counter()
        while True:
            replays.call += 1
            k, counters = call(eng, n_call)
            tokens += k
            calls += 1
            short += k < n_call
            sums += torch.as_tensor(counters)
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    # a step ends in one resample or one bonus token: the steps
    _, _, _, resampled, bonus, mid_draft, _, mid_verify, mid_live = \
        sums.tolist()
    steps = resampled + bonus
    rec = {"model": m, "ttft_s": ttft, "prefill_chunk": c,
           "prompt": prompt,
           "decode": dict(wall_s=wall, tokens=tokens, steps=steps,
                          mid_verify=mid_verify, mid_live=mid_live,
                          mid_draft=mid_draft, len0=len0, len1=length,
                          gamma=sp.gamma, budget=sp.budget,
                          draft_window=sp.draft_start_size
                          + sp.draft_recent_size)}
    out = {"attempted": calls, "failed": short,
           "samples": {"tokens": tokens, "steps": steps},
           "e2e": {"decode_ms_per_token": 1e3 * wall / tokens,
                   "ttft_s": ttft, "setup_s": setup_s},
           "memory_peak_bytes": peak, "records": rec}

    if ctx.trace:
        from triforce_tpu_torch import profiling
        out["busy_s"], out["window_s"] = replays.busy_s(), wall
        rec.update(busy_s=out["busy_s"], window_s=wall)
        rec["phase_ms"] = {k: 1e3 * v for k, v in
                           profiling.measure_phase_times(eng, st, 10).items()}
        twin, fork = harness.eager_twin(eng), st.clone()
        res, ops = harness.profile(lambda: twin.generate_forced(
            fork, mix["profile_tokens"], alpha, mode="triforce"), dev)
        counters = res[3]
        rec["b1"] = dict(device_s=harness.flash_decode_s(ops),
                         steps=int(counters[3] + counters[4]),
                         mid_live=int(counters[8]),
                         len0=length, len1=int(res[0].kv.seq_len),
                         gamma=sp.gamma, budget=sp.budget)
        out["breakdown"] = {"device_ops": harness.top_ops(ops),
                            "idle_gaps": replays.gaps()}
        del twin, fork, res

    # the judge: the program's caches against the reference
    eng.release_graphs()
    del eng
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    prog = _Prog(st, int(st.kv.seq_len), prompt, sp, build)
    readings = check.judge(m, weights, seq.ids(dev), prog)
    readings["chain_breaks"] = float(seq.breaks)
    out["correct"], out["checks"] = check.verdict(readings,
                                                  cell.spec["limits"])
    out["readings"] = readings
    return out
