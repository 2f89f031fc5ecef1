"""Traffic driver ``backlog``: long prompts served through the port's
``SpecScheduler`` from a closed-loop backlog.

Parameters (the mix's file): ``prompt_len`` (the engine's fixed prompt
length), ``slots``, ``segment`` (batched steps a decode segment),
``admit_chunks`` (prefill chunks an admission slice), ``output_min`` /
``output_max`` / ``output_set`` (the evenly spaced output lengths, in one
fixed order: ``output_lengths``), ``queue_depth`` (requests kept
waiting) and ``judged_rows``.

The scheduler is driven one cycle (an admission slice and a decode
segment) a call: ``run`` with a wall limit shorter than a cycle. Each
cycle's deliveries are stamped with the host clock when ``run`` returns.
Warm-up runs until as many requests have retired as there are slots, so
the window starts with staggered slots and every graph captured. (Not
until every slot has retired one: the scheduler fills the lowest free
slot, and with admission paced at one request a few cycles the highest
slots may wait for minutes.) The window runs
whole cycles until ``seconds`` have passed:

  serve_tokens_per_s  output tokens delivered in the window (the
                      admission's first token included, tokens trimmed
                      past a request's length not), over its wall;
  token_gap_p95_ms    the 95th percentile of the gaps between consecutive
                      deliveries to a live request that end in the window.

After it, ``judged_rows`` of the live rows, drawn from the seed, have
their caches held against the reference (no live row reads as a
failure: nothing was shown correct); every request finished in the
window must have its full length (or end at EOS), and no request live
through the whole window may go without a token (``stalled``).
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

import harness
from reference import check

WARMUP_LIMIT_S = 240.0


def output_lengths(mix: dict, n: int) -> list:
    """The output lengths of the first ``n`` requests: ``output_set``
    evenly spaced lengths over ``[output_min, output_max]``, taken in a
    fixed order that spreads them (stride 7 through the set) and repeated.
    The seed changes the tokens, the weights and the acceptance coins,
    never the sizes, so every seed does the same work."""
    k, lo, hi = mix["output_set"], mix["output_min"], mix["output_max"]
    base = [round(lo + (hi - lo) * i / (k - 1)) for i in range(k)]
    return [base[(7 * i) % k] for i in range(n)]


class _Traffic:
    """The backlog: requests made from the seed as the queue needs them,
    and every request's deliveries."""

    def __init__(self, sched, mix, vocab, seed):
        from triforce_tpu_torch.batching import Request
        self.Request = Request
        self.sched, self.mix, self.vocab = sched, mix, vocab
        self.rng = np.random.default_rng(seed)
        self.seed = seed
        self.lengths = output_lengths(mix, 4096)
        self.made = 0
        self.prompts = {}          # rid -> prompt ids (live requests)
        self.seen = {}             # rid -> (len(out), last delivery time)
        self.recording = False
        self.tokens = 0
        self.gaps = []
        self.finished = []
        self.delivered_in_window = set()

    def top_up(self):
        while len(self.sched.queue) < self.mix["queue_depth"]:
            rid = self.seed * 100000 + self.made
            prompt = self.rng.integers(3, self.vocab, self.mix["prompt_len"])
            self.prompts[rid] = prompt
            self.sched.submit(self.Request(
                rid=rid, prompt=prompt,
                max_new_tokens=self.lengths[self.made]))
            self.made += 1

    def cycle(self):
        """One scheduler cycle; returns the requests it finished."""
        self.top_up()
        done = self.sched.run(max_wall_s=1e-3)
        t = time.perf_counter()
        live = [r for r in self.sched.slot_req if r is not None]
        for r in live + done:
            n = len(r.out)
            prev = self.seen.get(r.rid)
            new = n - (prev[0] if prev else 0)
            if self.recording:
                self.tokens += new
                if new:
                    self.delivered_in_window.add(r.rid)
                if prev is not None and new:
                    self.gaps.append(t - prev[1])
            if new or prev is None:
                self.seen[r.rid] = (n, t)
        for r in done:
            self.seen.pop(r.rid, None)
            self.prompts.pop(r.rid, None)
            if self.recording:
                self.finished.append(r)
        return done


class _Row:
    """What the judge reads of one row of the pool."""

    def __init__(self, state, slot, length, prompt, spec):
        self.state, self.slot, self.length = state, slot, length
        self.prompt, self.budget = prompt, spec.budget
        self.chunk = spec.chunk_size
        n_gen = min(length - prompt, spec.budget)
        self.build_groups = (spec.budget - n_gen) // spec.chunk_size

    def kv(self, li):
        return harness.cache_planes(self.state.kv, (self.slot, li),
                                    self.length)

    def rkv(self, li):
        return harness.cache_planes(self.state.rkv, (self.slot, li),
                                    self.budget)

    build = rkv


def _labelled(fn, replays, phase):
    def wrapped(*a, **k):
        replays.phase = phase
        replays.call += 1
        return fn(*a, **k)
    return wrapped


def run(ctx) -> dict:
    from triforce_tpu_torch.batched_spec import (BatchedSpecEngine,
                                                 SpecScheduler)
    cell, dev, seed = ctx.cell, ctx.device, ctx.seed
    m, mix = cell.model, cell.mix
    prompt = mix["prompt_len"]
    alpha = m["speculation"]["force_accept"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    weights = harness.make_weights(m, gen, dev)
    draft = harness.make_weights(m["drafter"], gen, dev)
    gamma = m["speculation"]["gamma"]
    room = prompt + SpecScheduler.required_headroom(
        mix["output_max"], mix["segment"], gamma)
    eng = harness.build_engine(cell, weights, draft, prompt, room, dev,
                               control=ctx.control)
    sp = eng.spec
    sched = SpecScheduler(eng, "triforce", slots=mix["slots"],
                          segment=mix["segment"], seed=seed,
                          force_accept=alpha,
                          admit_chunks=mix["admit_chunks"])
    traffic = _Traffic(sched, mix, m["vocab_size"], seed)
    replays = harness.ReplayClock(ctx.trace and dev.type == "cuda")
    if replays.enabled:
        sched._admit = _labelled(sched._admit, replays, "admission")
        sched._decode_segment = _labelled(sched._decode_segment, replays,
                                          "decode segment")

    retired, t_w = 0, time.perf_counter()
    while retired < mix["slots"]:
        retired += len(traffic.cycle())
        if time.perf_counter() - t_w > WARMUP_LIMIT_S:
            raise RuntimeError(f"warm-up: {retired} requests of "
                               f"{mix['slots']} retired")
    setup_s = ctx.since_start()

    sums = dict.fromkeys(("admit_s", "decode_s", "steps",
                          "target_forwards", "prefill_tokens"), 0)
    cycles = []
    live_at_start = {r.rid for r in sched.slot_req if r is not None}
    traffic.recording = True
    with replays:
        harness.sync(dev)
        t0 = time.perf_counter()
        while True:
            lens = [prompt + len(r.out) - 1 for r in sched.slot_req
                    if r is not None]
            traffic.cycle()
            st = sched.stats
            for k in sums:
                sums[k] += st[k]
            cycles.append([st["target_forwards"], lens])
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        wall = time.perf_counter() - t0
    traffic.recording = False
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None

    live = {r.rid: (s, r) for s, r in enumerate(sched.slot_req)
            if r is not None}
    stalled = sum(1 for rid in live_at_start & set(live)
                  if rid not in traffic.delivered_in_window)
    short = sum(1 for r in traffic.finished
                if len(r.out) != r.max_new_tokens
                and r.out[-1] not in eng.eos_token_id)
    gaps = sorted(traffic.gaps)
    p95 = statistics.quantiles(gaps, n=20)[18] if len(gaps) >= 20 \
        else float("nan")
    rec = {"model": m, "prompt": prompt, "prefill_chunk": eng.prefill_chunk,
           "serve": dict(wall_s=wall, cycles=cycles, gamma=sp.gamma,
                         budget=sp.budget, gaps=len(gaps), **sums)}
    out = {"attempted": len(traffic.finished) + len(live), "failed": short,
           "samples": {"token_gaps": len(gaps), "tokens": traffic.tokens,
                       "finished": len(traffic.finished)},
           "e2e": {"serve_tokens_per_s": traffic.tokens / wall,
                   "token_gap_p95_ms": 1e3 * p95, "setup_s": setup_s},
           "memory_peak_bytes": peak, "records": rec}

    if ctx.trace:
        out["busy_s"], out["window_s"] = replays.busy_s(), wall
        rec.update(busy_s=out["busy_s"], window_s=wall)
        pool = sched.state.clone()
        bat = BatchedSpecEngine(harness.eager_twin(eng), mode="triforce",
                                force_accept=alpha)
        res, ops = harness.profile(lambda: bat.decode(pool, 1), dev)
        lens = [int(x) for x in pool.kv.seq_len.tolist()]
        rec["b3"] = dict(device_s=harness.flash_decode_s(ops),
                         target_forwards=bat.target_forwards,
                         lens=[x for x in lens if x > 0],
                         mid_live=[int(x) for x in res[3][:, 3]],
                         gamma=sp.gamma, budget=sp.budget)
        out["breakdown"] = {"device_ops": harness.top_ops(ops),
                            "idle_gaps": replays.gaps()}
        del pool, bat, res

    # the judge: sampled live rows against the reference
    order = np.random.default_rng(seed).permutation(sorted(live))
    eng.release_graphs()
    readings = dict(kv_len_gap=0.0, kv_err=0.0, rkv_err=0.0, build_gap=0.0)
    state = sched.state
    for rid in order[:mix["judged_rows"]]:
        slot, req = live[int(rid)]
        ids = torch.as_tensor(np.concatenate(
            [traffic.prompts[int(rid)], np.asarray(req.out[:-1])]),
            dtype=torch.int64, device=dev)
        length = int(state.kv.seq_len[slot])
        r = check.judge(m, weights, ids,
                        _Row(state, slot, length, prompt, sp))
        for k, v in r.items():
            readings[k] = max(readings[k], v) if v == v else v
    if not live:                        # nothing shown correct
        readings.update(kv_err=check.BAD, rkv_err=check.BAD)
    readings["stalled"] = float(stalled)
    out["correct"], out["checks"] = check.verdict(readings,
                                                  cell.spec["limits"])
    out["readings"] = readings
    return out
