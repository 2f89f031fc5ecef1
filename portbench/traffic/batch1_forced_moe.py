"""Traffic driver ``batch1_forced_moe``: ``batch1_forced``'s traffic (one
long document at batch 1, decoded by forced-acceptance TriForce in
back-to-back calls) for a model whose layers differ in kind: sliding-window
layers on a ring beside full ones, and expert MLPs
(``configs/mellum2-12b-a2.5b.json``).

Parameters are ``batch1_forced``'s (the mix's file), and
``prefill_chunk`` (512 if absent; a ring holds the window and one chunk).
The run is that
driver's, step for step (its set-up captures, ``ttft_s``, the warm-up
calls, the window of whole calls, the traced run's replay clock,
``measure_phase_times`` and the eager witness's profile), with what the
model needs of its own: the configurations, weights and engine are made
here from the file (``harness``'s dense helpers do not know these
layers), and the window's expert counts are read from the engine's
device counters (``Engine.moe_counts``: experts read, pairs routed, layer
calls, by forward kind) before and after it. The traced run adds
``rec["moe"]["witness"]``: the experts the eager witness's profiled
forwards read and the union of its expert kernel's intervals on the card.

Correctness (``reference/check_moe.py``): after the window, three
forwards run at the close at the cache's length, each through the
engine's graphs three times (eager, captured, replayed; the replay must
equal the eager run), each expert layer's input, output and choice
recorded in the eager run: one target verify of gamma + 2 tokens (the
pending token, then the prompt's first tokens), one middle verify of
gamma + 1 tokens (over the retrieval cache and the rings) and one prefill
chunk (the prompt's first ``prefill_chunk`` tokens; the grouped GEMM's
path on the card). None moves the cache's length, and each writes the
full cache and the rings only past it, where a ring slot holds a position
the window no longer sees. The verify's logits, the three's expert
layers and the caches go to the judge, beside ``chain_breaks``.
``--control int8`` runs the program on every matrix (attention, router,
experts, head) rounded to per-channel int8 and back here, in the driver:
the reference keeps the weights as made.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import torch

import harness
from reference import check, check_moe

_b1 = harness.load_module(harness.HERE / "traffic" / "batch1_forced.py")
EXPERT_KERNELS = ("moe_gate_up_kernel", "moe_down_kernel",
                  "moe_combine_kernel")


def port_configs(m: dict):
    """The port's (target, drafter, speculation) configurations."""
    from triforce_tpu_torch.config import (HybridConfig, ModelConfig,
                                           RopeConfig, SpecConfig)
    from triforce_tpu_torch.models import rope
    full = m["rope_parameters"]["full_attention"]
    local = m["rope_parameters"]["sliding_attention"]
    if full["rope_type"] != "yarn" or local["rope_type"] != "default":
        raise ValueError(f"rope_parameters {m['rope_parameters']}")
    yarn = RopeConfig(kind="yarn", theta=float(full["rope_theta"]),
                      scaling_factor=float(full["factor"]),
                      original_max_position_embeddings=int(
                          full["original_max_position_embeddings"]),
                      beta_fast=float(full["beta_fast"]),
                      beta_slow=float(full["beta_slow"]))
    # the port scales by YaRN's 0.1 ln s + 1 times attn_factor
    yarn = dataclasses.replace(yarn, attn_factor=float(
        full["attention_factor"]) / rope.mscale_for(yarn))
    target = HybridConfig(
        vocab_size=m["vocab_size"], hidden_size=m["hidden_size"],
        intermediate_size=m["intermediate_size"],
        num_layers=m["num_hidden_layers"],
        num_heads=m["num_attention_heads"],
        num_kv_heads=m["num_key_value_heads"], head_dim=m["head_dim"],
        max_position_embeddings=m["max_position_embeddings"],
        rms_norm_eps=m["rms_norm_eps"], rope=yarn,
        tie_word_embeddings=m["tie_word_embeddings"],
        layer_types=tuple(m["layer_types"]),
        sliding_window=m["sliding_window"],
        rope_local=RopeConfig(kind="llama", theta=float(local["rope_theta"])),
        num_experts=m["num_experts"],
        num_experts_per_tok=m["num_experts_per_tok"],
        moe_intermediate_size=m["moe_intermediate_size"],
        norm_topk_prob=m["norm_topk_prob"],
        mlp_layer_types=tuple(m["mlp_layer_types"]))
    d = m["drafter"]
    draft = ModelConfig(
        vocab_size=d["vocab_size"], hidden_size=d["hidden_size"],
        intermediate_size=d["intermediate_size"],
        num_layers=d["num_hidden_layers"],
        num_heads=d["num_attention_heads"],
        num_kv_heads=d["num_key_value_heads"], head_dim=d["head_dim"],
        max_position_embeddings=d["max_position_embeddings"],
        rms_norm_eps=d["rms_norm_eps"],
        rope=RopeConfig(kind="llama", theta=float(d["rope_theta"])),
        rope_on_slots=True)
    s = m["speculation"]
    spec = SpecConfig(gamma=s["gamma"], budget=s["budget"],
                      chunk_size=s["chunk_size"],
                      temperature=s["temperature"], top_p=s["top_p"],
                      draft_start_size=s["draft_start_size"],
                      draft_recent_size=s["draft_recent_size"])
    return target, draft, spec


def make_weights(m: dict, gen: torch.Generator, device,
                 dtype=torch.bfloat16, outlier_rows: int = 4,
                 outlier_factor: float = 16.0) -> dict:
    """Random weights in the program's layout, made as
    ``harness.make_weights`` makes a dense model's: embedding N(0, 1),
    matrices N(0, 0.02), the two that write into the residual stream
    (``wo`` and each expert's ``w_down_e``) N(0, 0.02 / sqrt(2 * layers)),
    in every matrix ``outlier_rows`` input rows ``outlier_factor`` times
    larger, norm gains 1 + N(0, 0.1). Expert matrices are a row per output
    ([layers, experts, out, in]), so their input rows are columns."""
    h, d = m["hidden_size"], m["head_dim"]
    n, v = m["num_hidden_layers"], m["vocab_size"]
    e, i = m["num_experts"], m["moe_intermediate_size"]
    hq, hkv = m["num_attention_heads"] * d, m["num_key_value_heads"] * d
    out_std = 0.02 / (2 * n) ** 0.5

    def randn(*shape, std):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dtype).mul_(std)

    def mat(*shape, std=0.02, rows_last=False):
        w = randn(*shape, std=std)
        lead, k = shape[:-2], shape[-1] if rows_last else shape[-2]
        pick = torch.rand(lead + (k,), generator=gen, device=device
                          ).argsort(-1)[..., :outlier_rows]
        boost = torch.ones(lead + (k,), device=device, dtype=dtype
                           ).scatter_(-1, pick, outlier_factor)
        w.mul_(boost[..., None, :] if rows_last else boost[..., None])
        return w

    def gain(*shape):
        return randn(*shape, std=0.1).add_(1.0)

    return {
        "embed": randn(v, h, std=1.0),
        "layers": {"wq": mat(n, h, hq), "wk": mat(n, h, hkv),
                   "wv": mat(n, h, hkv), "wo": mat(n, hq, h, std=out_std),
                   "ln_attn": gain(n, h), "ln_mlp": gain(n, h),
                   "w_router": mat(n, e, h, rows_last=True),
                   "w_gate_e": mat(n, e, i, h, rows_last=True),
                   "w_up_e": mat(n, e, i, h, rows_last=True),
                   "w_down_e": mat(n, e, h, i, std=out_std, rows_last=True)},
        "final_norm": gain(h),
        "lm_head": mat(h, v),
    }


# each matrix's axis of inputs (a scale per output channel): ``x @ w`` for
# attention and the head, a row per output for the router and the experts
CONTROL_INPUT_AXIS = {"wq": -2, "wk": -2, "wv": -2, "wo": -2,
                      "w_router": -1, "w_gate_e": -1, "w_up_e": -1,
                      "w_down_e": -1}


def _int8_round(w: torch.Tensor, axis: int) -> torch.Tensor:
    x = w.float()
    s = (x.abs().amax(axis, keepdim=True) / 127.0).clamp_min(1e-8)
    return (torch.round(x / s).clamp(-127, 127) * s).to(w.dtype)


def int8_round_trip(weights: dict) -> dict:
    """The control's weights: every matrix rounded to symmetric int8 codes
    per output channel (scale max |channel| / 127) and back, a layer at a
    time; the embedding and the norms as made."""
    layers = dict(weights["layers"])
    for name, axis in CONTROL_INPUT_AXIS.items():
        w = layers[name].clone()
        for li in range(w.shape[0]):
            w[li] = _int8_round(w[li], axis)
        layers[name] = w
    return dict(weights, layers=layers,
                lm_head=_int8_round(weights["lm_head"], -2))


def union_s(spans) -> float:
    """Seconds covered by the union of (start, end) microsecond spans."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e6


def profile_spans(fn, names, device):
    """``fn()`` under ``torch.profiler`` (the card's activity, or the
    CPU's off the card): its result, the (start, end) microseconds of
    every kernel on the card whose name holds one of ``names``, and the
    device seconds of each operation by name (as ``harness.profile``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    act = ProfilerActivity.CUDA if torch.device(device).type == "cuda" \
        else ProfilerActivity.CPU
    harness.sync(device)
    with torch.profiler.profile(activities=[act]) as prof:
        out = fn()
        harness.sync(device)
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and any(n in e.name for n in names)]
    ops = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or 0
        if us:
            name = harness.kernel_name(e.key)
            ops[name] = ops.get(name, 0.0) + us / 1e6
    return out, spans, ops


class _Prog(_b1._Prog):
    """``batch1_forced._Prog`` over the full layers' planes, with the
    sliding layers' rings and the closing verify's logits."""

    def __init__(self, st, length, prompt, spec, build, window, logits,
                 logit_tokens):
        super().__init__(st, length, prompt, spec, build)
        self.window, self.logits = window, logits
        self.logit_tokens = logit_tokens

    def ring(self, si):
        kv = self.st.kv
        pos = torch.arange(max(0, self.length - self.window), self.length,
                           device=kv.ring_k.device)
        slots = torch.remainder(pos, kv.ring_slots)
        return (kv.ring_k[si, 0][:, slots].float(),
                kv.ring_v[si, 0][:, slots].float())


@contextlib.contextmanager
def _recording_experts():
    """Record each expert layer's (h [T, H], output [T, H], experts
    chosen [T, k]) run eagerly while open."""
    from triforce_tpu_torch.ops import moe
    real, seen = moe.moe_mlp, []

    def recording(h, lp, top_k, norm=True):
        out = real(h, lp, top_k, norm)
        x = h.reshape(-1, h.shape[-1])
        idx, _ = moe.route(x, lp["w_router"], top_k, norm)
        seen.append((x.clone(), out.reshape(x.shape).clone(), idx))
        return out
    moe.moe_mlp = recording
    try:
        yield seen
    finally:
        moe.moe_mlp = real


def _recorded(fn, what: str):
    """``fn()`` (a graphed forward's logits) three times: eager with each
    expert layer recorded (``_recording_experts``), captured, replayed.
    Returns (the logits, the records); raises where the replay's logits
    differ from the eager run's."""
    with _recording_experts() as seen:
        first = fn()
    for _ in range(2):
        again = fn()
    if not torch.equal(first, again):
        raise RuntimeError(f"the closing {what}'s replay differs from its "
                           f"eager run")
    return again, seen


def _closing_forwards(eng, st, ids) -> tuple:
    """The three forwards the judge reads at the close (module docstring):
    (the target verify's logits [T, V] float32 and its tokens [T], each
    forward kind's expert layers)."""
    from triforce_tpu_torch import graphs as graphs_mod
    from triforce_tpu_torch.engine import (append_graphed, dense_weights,
                                           param_planes)
    from triforce_tpu_torch.models import llama
    sp, cfg, c = eng.spec, eng.target_cfg, eng.prefill_chunk
    kv, rkv = st.kv, st.rkv
    room = kv.max_len
    if int(kv.seq_len) + max(c, sp.gamma + 2) > room:
        raise RuntimeError(f"no room for the closing forwards: "
                           f"{int(kv.seq_len)} of {room} cached")
    toks = torch.cat([st.next_token[:1], ids[0, :sp.gamma + 1]])[None]
    logits, verify = _recorded(lambda: append_graphed(
        eng.graphs, cfg, eng.t_params, kv, toks)[0], "target verify")

    def middle(mids, kv_len):
        return (llama.forward_spec(cfg, eng.t_params, mids, rkv, kv_len,
                                   sp.budget, commit=False,
                                   act_quant=sp.mid_act_quant, ring=kv)[0],)
    _, mid = _recorded(lambda: eng.graphs.run(
        "middle_check", middle, (toks[:, :-1], kv.seq_len),
        caches=graphs_mod.planes(kv, rkv) + param_planes(eng.t_params))[0],
        "middle verify")
    _, chunk = _recorded(lambda: append_graphed(
        eng.graphs, cfg, dense_weights(eng, eng.t_params), kv,
        ids[:, :c])[0], "prefill chunk")
    return (logits[0].float().clone(), toks[0],
            {"verify": verify, "middle": mid, "prefill": chunk})


def _counts(eng) -> dict:
    from triforce_tpu_torch.engine import MOE_KINDS
    return dict(zip(MOE_KINDS, eng.moe_counts.tolist()))


def run(ctx) -> dict:
    from triforce_tpu_torch.engine import Engine
    cell, dev, seed = ctx.cell, ctx.device, ctx.seed
    m, mix = cell.model, cell.mix
    prompt, room = mix["prompt_len"], mix["max_cache_len"]
    n_call = mix["call_tokens"]
    alpha = m["speculation"]["force_accept"]
    tcfg, dcfg, spec = port_configs(m)
    gen = torch.Generator(device=dev).manual_seed(seed)
    weights = make_weights(m, gen, dev)
    draft = harness.make_weights(m["drafter"], gen, dev)
    ids = harness.make_prompt(m["vocab_size"], prompt, gen, dev)[None]
    eng = Engine(tcfg, spec, int8_round_trip(weights) if ctx.control
                 else weights, draft_cfg=dcfg, draft_params=draft,
                 prefill=prompt, max_cache_len=room, device=dev,
                 prefill_chunk=mix.get("prefill_chunk", 512))
    sp = eng.spec
    c = eng.prefill_chunk

    # capture every prefill graph: chunks, last slice (remainder + build)
    st = eng.init_state(seed)
    st, _, _ = eng.prefill_target_partial(st, ids, 0, 2)
    last = ((prompt - 1) // c) * c
    for _ in range(2):
        st, _, _ = eng.prefill_target_partial(st, ids, last, 1)
    st = eng.prefill_draft(st, ids[:, :2 * eng.draft_prefill_chunk])
    st = _b1._fresh(st, seed)

    clock = harness.Clock(dev)
    st = eng.prefill_target(st, ids)
    st = eng.prefill_draft(st, ids)
    int(st.next_token[0])                           # the first token
    ttft = clock()
    rk = st.rkv
    build = tuple(None if x is None else x[:, 0, :, :sp.budget].to(
                      "cpu", copy=True)
                  for x in (rk.k, rk.v, rk.k_scale, rk.v_scale))

    seq = _b1._Seq(ids[0])
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
    before = _counts(eng)
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
    after = _counts(eng)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    _, _, _, resampled, bonus, mid_draft, _, mid_verify, mid_live = \
        sums.tolist()
    steps = resampled + bonus
    window = {kind: [a - b for a, b in zip(after[kind], before[kind])]
              for kind in after}
    print("moe window: experts read a layer call " + ", ".join(
        f"{kind} {r / c:.2f} ({c} calls)" for kind, (r, _, c)
        in window.items() if c), file=sys.stderr)
    rec = {"model": m, "ttft_s": ttft, "prefill_chunk": c,
           "prompt": prompt,
           "decode": dict(wall_s=wall, tokens=tokens, steps=steps,
                          mid_verify=mid_verify, mid_live=mid_live,
                          mid_draft=mid_draft, len0=len0, len1=length,
                          gamma=sp.gamma, budget=sp.budget,
                          draft_window=sp.draft_start_size
                          + sp.draft_recent_size),
           "moe": {"window": window}}
    out = {"attempted": calls, "failed": short,
           "samples": {"tokens": tokens, "steps": steps,
                       "experts_read": window["target"][0]
                       + window["middle"][0]},
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
        res, spans, ops = profile_spans(lambda: twin.generate_forced(
            fork, mix["profile_tokens"], alpha, mode="triforce"),
            EXPERT_KERNELS, dev)
        seen = _counts(twin)
        rec["moe"]["witness"] = dict(
            experts_read=seen["target"][0] + seen["middle"][0],
            layer_calls=seen["target"][2] + seen["middle"][2],
            device_s=union_s(spans), kernels=len(spans))
        out["breakdown"] = {"device_ops": harness.top_ops(ops),
                            "idle_gaps": replays.gaps()}
        del twin, fork, res

    # the closing forwards (module docstring), then the judge
    logits, toks, moe_io = _closing_forwards(eng, st, ids)
    eng.release_graphs()
    del eng
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    prog = _Prog(st, int(st.kv.seq_len), prompt, sp, build,
                 m["sliding_window"], logits, toks)
    prog.moe_io = moe_io
    readings = check_moe.judge(m, weights, seq.ids(dev), prog)
    readings["chain_breaks"] = float(seq.breaks)
    out["correct"], out["checks"] = check.verdict(readings,
                                                  cell.spec["limits"])
    out["readings"] = readings
    return out
