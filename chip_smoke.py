#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py                 # full run (one H100)
    python3 chip_smoke.py --skip-e2e      # build + kernel phase only

Phases, in order (any failure exits non-zero before the last line):
  1. device line: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every kernel of ``triforce_tpu_torch/csrc``;
  3. kernels: each kernel at the main path's shapes against its plain
     PyTorch version (stated tolerance), with its time, its bound, the
     plain version's time and a library yardstick's time;
  4. reference: the full-width model at cut depth on a short prompt, the
     card's bf16 path (through the kernels) against an fp32 CPU run of the
     same weights;
  5. end to end: Llama2-7B-128K + Llama-68M at full width with random bf16
     weights: AR, retrieval-spec, TriForce and forced-acceptance TriForce
     through the decoding drivers, each with its kernel launch counts set
     to 0 before and checked against the count the path implies after;
  6. the ``kernels`` JSON line, then the ``ok`` JSON line.

Exits non-zero (and prints no result) without a CUDA card or outside the
repository.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # dense bf16 tensor cores
H100_FP32_FLOPS = 67e12         # fp32 outside the tensor cores
GEN = 128                       # generated tokens per end-to-end mode
GAMMA = 6


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def _time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median of ``reps`` launches timed one by one with CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def _bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------

def kernel_b1(fd, dev, gt, tn, k_len, s, hkv=32, d=128, seed=0):
    """B1 at one shape: kernel vs plain, times and bound."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    q, kn, vn = rn(hkv, gt, d), rn(hkv, tn, d), rn(hkv, tn, d)
    # one layer of a stacked [L, 1, Hkv, S, D] cache, as the model passes it
    k_st = rn(2, 1, hkv, s, d)
    v_st = rn(2, 1, hkv, s, d)
    k_st[1, 0, :, k_len:] = 50.0     # stale tail: must never be read
    v_st[1, 0, :, k_len:] = 50.0
    k, v = k_st[1, 0], v_st[1, 0]
    rows = torch.arange(gt, device=dev)[:, None] % tn
    mask = (torch.arange(tn, device=dev)[None, :] <= rows).contiguous()
    klen_t = torch.tensor(k_len, dtype=torch.int32, device=dev)

    # The kernel rounds p to bf16 against split-local maxima, the plain
    # version against the row maximum, so each p.v term differs by up to
    # 2^-9 relative and the output error shrinks as 1/sqrt(keys). Sound
    # readings at every shape gave err * sqrt(k_len + Tn) = 0.012-0.018
    # (my chip run, PR 1); the tolerance is ~3x that.
    tol = 0.05 / (k_len + tn) ** 0.5

    def check(kn, what):
        out = fd.flash_decode_append(q, k, v, kn, vn, klen_t, mask)
        ref = fd.flash_decode_append_plain(q, k, v, kn, vn, klen_t, mask)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            _fail(f"B1 gt={gt} k_len={k_len} {what}: non-finite output")
        return (out - ref).abs().max().item(), ref

    err, _ = check(kn, "random")
    if not err <= tol:
        _fail(f"B1 gt={gt} k_len={k_len}: kernel disagrees with plain")
    err_new = None
    if gt <= 16:
        # With random keys the new tokens hold ~Tn/k_len of the softmax
        # weight, too little for a lost fold or a wrong mask to show. Here
        # new key j = 1.5 (q_j + q_{j-1}): row r's allowed token j = r and
        # its masked token j = r + 1 both outscore the whole cache.
        qf = q.float()
        kn_dom = qf.clone()
        kn_dom[:, 1:] += qf[:, :-1]
        kn_dom = (1.5 * kn_dom[:, :tn]).to(bf)
        err_new, ref = check(kn_dom, "dominant new block")
        # the case has the power to catch each fault (no masked token at 1)
        faults = [("no fold", torch.zeros_like(mask))]
        if gt > 1:
            faults.append(("mask ignored", torch.ones_like(mask)))
        for what, m in faults:
            alt = fd.flash_decode_append_plain(q, k, v, kn_dom, vn, klen_t, m)
            gap = (alt - ref).abs().max().item()
            if not gap > 100 * tol:
                _fail(f"B1 gt={gt}: '{what}' moves the output only "
                      f"{gap:.3e}")
        if not err_new <= tol:
            _fail(f"B1 gt={gt} k_len={k_len}: kernel disagrees with plain "
                  f"when the new block dominates")
        err = max(err, err_new)
    ms = _time_ms(lambda: fd.flash_decode_append(q, k, v, kn, vn, klen_t,
                                                 mask))
    plain_ms = _time_ms(lambda: fd.flash_decode_append_plain(
        q, k, v, kn, vn, klen_t, mask), reps=5, warm=1)
    # yardstick: SDPA over [live cache prefix ++ new block] (prepared once)
    k_all = torch.cat([k[:, :k_len], kn], 1)[None]
    v_all = torch.cat([v[:, :k_len], vn], 1)[None]
    am = torch.cat([torch.ones(gt, k_len, dtype=torch.bool, device=dev),
                    mask], 1)
    lib_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q[None], k_all, v_all, attn_mask=am))
    nbytes = 2 * (q.numel() + 2 * hkv * k_len * d + 2 * kn.numel()) \
        + mask.numel() + 4 * hkv * gt * d
    flops = 4.0 * hkv * gt * (k_len + tn) * d
    bound_ms, bound_by = _bound(nbytes, flops, H100_BF16_FLOPS)
    row = dict(gt=gt, tn=tn, k_len=k_len, s=s, max_abs_err=err, tol=tol,
               err_dominant_new=err_new, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)
    print(f"B1 gt={gt} tn={tn} k_len={k_len}: err {err:.3e} (tol "
          f"{tol:.3e}; dominant new block {err_new}) kernel {ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}), sdpa {lib_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms", flush=True)
    return row


def kernel_b2(rk, rt, dev, prefill, chunk, budget, s, hkv=32, d=128, g=1):
    """B2 at the build shape: kernel vs plain scores and selected chunks."""
    gen = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    q = torch.randn((hkv, g, d), generator=gen, device=dev).to(bf)
    k = torch.randn((hkv, s, d), generator=gen, device=dev).to(bf)
    k[:, prefill:] = 50.0           # past the live prefill: never read
    out = rk.chunk_scores(q, k, chunk=chunk, prefill=prefill)
    ref = rk.chunk_scores_plain(q, k, chunk=chunk, prefill=prefill)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    # fp32 sums of identical bf16 products in another order: ~1e-7 of the
    # scale; the reading was 1.5e-7 of it (my chip run, PR 1)
    tol = 1e-5 * ref.abs().max().item()
    sel_k = rt.select_chunks(out[None], budget // chunk)[0]
    sel_p = rt.select_chunks(ref[None], budget // chunk)[0]
    n_diff = 0
    for h in range(hkv):
        a = set(sel_k[h].tolist())
        b = set(sel_p[h].tolist())
        for c in a ^ b:
            # a differing pick must be a near-tie at the top-k boundary
            kth = ref[h, 1:].topk(budget // chunk - 1).values[-1]
            if abs(ref[h, c].item() - kth.item()) > 2 * tol:
                _fail(f"B2 head {h}: chunk {c} selected differently and is "
                      f"not a near-tie")
            n_diff += 1
    ms = _time_ms(lambda: rk.chunk_scores(q, k, chunk=chunk,
                                          prefill=prefill))
    plain_ms = _time_ms(lambda: rk.chunk_scores_plain(
        q, k, chunk=chunk, prefill=prefill), reps=5, warm=1)
    kp = k[:, :prefill]
    lib_ms = _time_ms(lambda: torch.einsum("hgd,hsd->hgs", q, kp).float()
                      .mean(1).reshape(hkv, -1, chunk).mean(-1))
    nbytes = 2 * (q.numel() + hkv * prefill * d) + 4 * out.numel()
    flops = 2.0 * hkv * g * prefill * d
    bound_ms, bound_by = _bound(nbytes, flops, H100_FP32_FLOPS)
    print(f"B2 prefill={prefill} chunk={chunk}: err {err:.3e} (tol "
          f"{tol:.3e}), {n_diff} near-tie selection differences; kernel "
          f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), einsum+mean "
          f"{lib_ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    if not err <= tol:
        _fail("B2: kernel disagrees with plain")
    return dict(prefill=prefill, chunk=chunk, max_abs_err=err, tol=tol,
                select_near_ties=n_diff, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)


# ---------------------------------------------------------------------------
# Reference phase: the card's bf16 kernel path vs an fp32 CPU run
# ---------------------------------------------------------------------------

def reference_check(tc, llama, cache_mod, rt, dev, layers=2, prompt=512):
    cfg = tc.LLAMA2_7B_128K.with_(num_layers=layers)
    spec = tc.SpecConfig(budget=128, chunk_size=8)
    sets = spec.budget // spec.chunk_size
    p_gpu = llama.init_params(cfg, device=dev, dtype=torch.bfloat16, seed=7)
    p_cpu = {"embed": p_gpu["embed"].float().cpu(),
             "final_norm": p_gpu["final_norm"].float().cpu(),
             "lm_head": p_gpu["lm_head"].float().cpu(),
             "layers": {k: v.float().cpu()
                        for k, v in p_gpu["layers"].items()}}
    ids = torch.randint(0, cfg.vocab_size, (1, prompt),
                        generator=torch.Generator().manual_seed(3))
    # record the chunk scores each build computes, layer by layer
    recorded = []
    chunk_scores = rt.chunk_scores

    def recording(*args, **kwargs):
        sc = chunk_scores(*args, **kwargs)
        recorded.append(sc[0].float().cpu())
        return sc

    outs = {}
    rt.chunk_scores = recording
    try:
        for name, params, device, dtype in (
                ("gpu", p_gpu, dev, torch.bfloat16),
                ("cpu", p_cpu, torch.device("cpu"), torch.float32)):
            recorded.clear()
            kv = cache_mod.init_kv(cfg, prompt + 16, dtype=dtype,
                                   device=device)
            rkv = cache_mod.init_retrieval(cfg, spec, dtype=dtype,
                                           device=device)
            x = ids.to(device)
            _, kv, _ = llama.forward_append(cfg, params, x[:, :-1], kv,
                                            need_logits=False)
            logits, kv, rkv = llama.forward_append(
                cfg, params, x[:, -1:], kv, build_rkv=rkv, prefill=prompt,
                chunk_size=spec.chunk_size, budget=spec.budget)
            scores = torch.stack(recorded)                  # [L, Hkv, C]
            sel = rt.select_chunks(scores, sets)            # [L, Hkv, sets]
            # the build wrote exactly the chunks its own scores select
            for li in range(layers):
                want = rt.gather_chunks(kv.k[li], sel[li][None].to(device),
                                        spec.chunk_size)
                if not torch.equal(rkv.k[li, :, :, :spec.budget], want):
                    _fail(f"reference [{name}]: layer {li}'s retrieval "
                          f"cache is not the gather of its selected chunks")
            # a 3-token verify-shaped forward on top
            more, kv, _ = llama.forward_append(cfg, params, x[:, 5:8], kv)
            outs[name] = (torch.cat([logits, more], 1).float().cpu(),
                          scores, sel)
    finally:
        rt.chunk_scores = chunk_scores
    (lg, sg, selg), (lc, sc, selc) = outs["gpu"], outs["cpu"]
    cos = torch.nn.functional.cosine_similarity(lg.flatten(), lc.flatten(),
                                                dim=0).item()
    top1 = (lg.argmax(-1) == lc.argmax(-1)).float().mean().item()
    sc_cos = torch.nn.functional.cosine_similarity(sg.flatten(),
                                                   sc.flatten(), dim=0).item()
    # bf16 activations move the scores, so the two runs may pick different
    # chunks. A pick can flip only between chunks whose fp32 scores lie
    # within 2e of the k-th best, where e bounds |bf16 - fp32| for the head.
    n_diff = 0
    for li in range(layers):
        for h in range(cfg.num_kv_heads):
            e = (sg[li, h] - sc[li, h]).abs().max().item()
            kth = sc[li, h, 1:].topk(sets - 1).values[-1].item()
            for c in set(selg[li, h].tolist()) ^ set(selc[li, h].tolist()):
                if abs(sc[li, h, c].item() - kth) > 2 * e:
                    _fail(f"reference: layer {li} head {h} chunk {c} "
                          f"selected differently and is not a near-tie")
                n_diff += 1
    agree = 1 - n_diff / (2 * selg.numel())
    print(f"reference: {layers}-layer full-width model, {prompt}-token "
          f"prompt: bf16 card vs fp32 CPU logits cosine {cos:.6f}, top-1 "
          f"agreement {top1:.3f}; chunk scores cosine {sc_cos:.6f}, "
          f"selected chunks agree {agree:.4f} ({n_diff} near-tie "
          f"differences); each retrieval cache is the gather of its own "
          f"selection", flush=True)
    # bf16 weights and activations vs fp32 agree to well under 1%
    if not (cos > 0.999 and top1 >= 0.9 and sc_cos > 0.999):
        _fail("card forward disagrees with the fp32 CPU reference")
    return dict(logits_cosine=cos, top1_agreement=top1,
                chunk_scores_cosine=sc_cos, selection_agreement=agree,
                selection_near_ties=n_diff)


# ---------------------------------------------------------------------------
# End-to-end phase
# ---------------------------------------------------------------------------

def _reset(fd, rk):
    fd.flash_decode_append.launches = 0
    rk.chunk_scores.launches = 0


def _check_counts(fd, rk, what, want_b1, want_b2):
    got = (fd.flash_decode_append.launches, rk.chunk_scores.launches)
    print(f"  launches [{what}]: flash_decode {got[0]} (path implies "
          f"{want_b1}), chunk_scores {got[1]} (path implies {want_b2})",
          flush=True)
    if got != (want_b1, want_b2):
        _fail(f"{what}: kernel launch counts {got} != {(want_b1, want_b2)}")
    if not all(got) and what in ("retrieval", "triforce"):
        _fail(f"{what}: a kernel of the path was never launched")
    return got


def end_to_end(tc, llama, decoding, Engine, fd, rk, dev, prefill):
    tcfg, dcfg = tc.LLAMA2_7B_128K, tc.LLAMA_68M
    spec = tc.SpecConfig(gamma=GAMMA, budget=4096, chunk_size=8)
    L = tcfg.num_layers
    t0 = time.perf_counter()
    tp = llama.init_params(tcfg, device=dev, dtype=torch.bfloat16, seed=0)
    dp = llama.init_params(dcfg, device=dev, dtype=torch.bfloat16, seed=1)
    torch.cuda.synchronize()
    print(f"weights: {time.perf_counter() - t0:.1f} s to make random "
          f"weights on the card", flush=True)
    slack = 4 * (spec.gamma + 2)
    eng = Engine(tcfg, spec, tp, draft_cfg=dcfg, draft_params=dp,
                 prefill=prefill, max_cache_len=prefill + GEN + slack,
                 dtype=torch.bfloat16, device=dev)
    ids = torch.randint(0, tcfg.vocab_size, (1, prefill),
                        generator=torch.Generator().manual_seed(5)).to(dev)
    # target forwards of one prefill: full chunks + remainder + last token
    body = prefill - 1
    pre_fwd = body // eng.prefill_chunk + (1 if body % eng.prefill_chunk
                                           else 0) + 1
    res = {"launches": {}}

    def check_tokens(name, toks):
        if not all(0 <= t < tcfg.vocab_size for t in toks):
            _fail(f"{name}: token out of range")

    # --- AR
    _reset(fd, rk)
    t0 = time.perf_counter()
    r = decoding.autoregressive(eng, ids, max_len=GEN, seed=0,
                                device=dev)
    total = time.perf_counter() - t0
    check_tokens("ar", r.tokens)
    if len(r.tokens) != GEN + 1:
        _fail("ar: wrong token count")
    res["launches"]["ar"] = _check_counts(fd, rk, "ar",
                                          L * (pre_fwd + GEN), 0)
    res["ar"] = dict(ms_per_token=1e3 / r.tokens_per_sec,
                     prefill_s=total - r.wall_s, tokens=len(r.tokens))
    print(f"AR: prefill {total - r.wall_s:.2f} s, "
          f"{1e3 / r.tokens_per_sec:.3f} ms/token", flush=True)
    torch.cuda.empty_cache()

    # --- retrieval-spec and TriForce through the drivers
    for mode, fn in (("retrieval", decoding.retrieval_spec),
                     ("triforce", decoding.triforce)):
        _reset(fd, rk)
        t0 = time.perf_counter()
        r = fn(eng, ids, max_len=GEN, seed=1, device=dev)
        total = time.perf_counter() - t0
        check_tokens(mode, r.tokens)
        if len(r.tokens) < GEN + 1:
            _fail(f"{mode}: generated too few tokens")
        # every step: its middle verifies + one full-cache verify
        res["launches"][mode] = _check_counts(
            fd, rk, mode, L * (pre_fwd + r.middle_verifies + r.steps), L)
        res[mode] = dict(ms_per_token=1e3 / r.tokens_per_sec,
                         prefill_s=total - r.wall_s, steps=r.steps,
                         acceptance_rate=r.acceptance_rate,
                         avg_tokens_per_step=r.avg_tokens_per_step,
                         middle_verifies=r.middle_verifies)
        print(f"{mode}: prefill {total - r.wall_s:.2f} s, "
              f"{1e3 / r.tokens_per_sec:.3f} ms/token, {r.steps} steps, "
              f"acceptance {r.acceptance_rate:.3f}, "
              f"{r.avg_tokens_per_step:.2f} tokens/step", flush=True)
        torch.cuda.empty_cache()

    # --- TriForce at forced acceptance 0.9 (every forward still runs)
    state = eng.init_state(2)
    torch.cuda.synchronize()
    _reset(fd, rk)
    t0 = time.perf_counter()
    state = eng.prefill_target(state, ids)
    torch.cuda.synchronize()
    t_pt = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = eng.prefill_draft(state, ids)
    torch.cuda.synchronize()
    t_pd = time.perf_counter() - t0
    res["launches"]["prefill_target"] = _check_counts(
        fd, rk, "prefill_target", L * pre_fwd, L)
    _reset(fd, rk)
    t0 = time.perf_counter()
    state, buf, n, counters = eng.generate_forced(state, GEN, 0.9,
                                                  mode="triforce")
    toks = buf[:n].tolist()
    dt = time.perf_counter() - t0
    check_tokens("forced", toks)
    steps, accepted, proposed = (int(x) for x in counters[:3])
    mid_verify = int(counters[7])
    res["launches"]["forced"] = _check_counts(
        fd, rk, "forced", L * (steps + mid_verify), 0)
    want_len = prefill + (n - 1)      # every emitted token but the last
    if int(state.kv.seq_len) != want_len:
        _fail(f"forced: kv.seq_len {int(state.kv.seq_len)} != {want_len}")
    res["forced"] = dict(alpha=0.9, ms_per_token=dt * 1e3 / (n - 1),
                         prefill_target_s=t_pt, prefill_draft_s=t_pd,
                         counters=[int(x) for x in counters],
                         tokens=n - 1)
    print(f"forced triforce a=0.9: prefill_target {t_pt:.2f} s, "
          f"prefill_draft {t_pd:.2f} s, {dt * 1e3 / (n - 1):.3f} ms/token, "
          f"counters [steps, accepted, proposed, resampled, bonus, "
          f"mid_draft, mid_accept, mid_verify, mid_live] = "
          f"{[int(x) for x in counters]}", flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--prefill", type=int, default=32768)
    ap.add_argument("--skip-e2e", action="store_true",
                    help="stop after the kernel and reference phases")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from triforce_tpu_torch import _build, config as tc, cache
        from triforce_tpu_torch import decoding
        from triforce_tpu_torch.engine import Engine
        from triforce_tpu_torch.models import llama
        from triforce_tpu_torch.ops import flash_decode as fd
        from triforce_tpu_torch.ops import retrieval as rt
        from triforce_tpu_torch.ops import retrieval_kernel as rk
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in _build.BUILD_LOG.items():
        regs = [ln.split("Used ")[1].split(",")[0]
                for ln in log.splitlines() if "registers" in ln]
        spills = sum(" 0 bytes spill stores" not in ln
                     for ln in log.splitlines() if "spill stores" in ln)
        print(f"  ptxas [{name}]: {len(regs)} kernels, registers "
              f"{sorted(set(regs))}, {spills} with spills", flush=True)

    prefill = args.prefill
    s_kv = prefill + GEN + 4 * (GAMMA + 2)
    b1 = [kernel_b1(fd, dev, 1, 1, prefill, s_kv),
          kernel_b1(fd, dev, GAMMA + 2, GAMMA + 2, prefill, s_kv),
          kernel_b1(fd, dev, GAMMA + 1, GAMMA + 1, 4096, 4096 + GAMMA + 1),
          kernel_b1(fd, dev, 512, 512, min(16384, prefill), s_kv)]
    b2 = kernel_b2(rk, rt, dev, prefill, 8, 4096, s_kv)
    ref = reference_check(tc, llama, cache, rt, dev)

    e2e = None
    main_path = (None, None)      # launches in the decoding.triforce run
    by_phase = None
    if not args.skip_e2e:
        e2e = end_to_end(tc, llama, decoding, Engine, fd, rk, dev, prefill)
        by_phase = e2e["launches"]
        main_path = by_phase["triforce"]
        print("end to end: " + json.dumps(e2e), flush=True)

    main_b1 = b1[0]   # AR decode shape: the path's most frequent launch
    kernels = [
        dict(name="flash_decode_append", route="cuda",
             source="triforce_tpu_torch/csrc/flash_decode.cu",
             replaces="triforce_tpu/ops/flash_decode.py:332",
             launches=main_path[0],
             launches_by_phase=by_phase and {k: v[0] for k, v in
                                             by_phase.items()},
             max_abs_err=max(r["max_abs_err"] for r in b1),
             ms=main_b1["ms"], plain_ms=main_b1["plain_ms"],
             bound_ms=main_b1["bound_ms"], bound_by=main_b1["bound_by"],
             library_ms=main_b1["library_ms"], shapes=b1),
        dict(name="chunk_scores", route="cuda",
             source="triforce_tpu_torch/csrc/chunk_scores.cu",
             replaces="triforce_tpu/ops/retrieval_kernel.py:101",
             launches=main_path[1],
             launches_by_phase=by_phase and {k: v[1] for k, v in
                                             by_phase.items()},
             max_abs_err=b2["max_abs_err"], ms=b2["ms"],
             plain_ms=b2["plain_ms"], bound_ms=b2["bound_ms"],
             bound_by=b2["bound_by"], library_ms=b2["library_ms"],
             shapes=[b2]),
    ]
    print(json.dumps({"reference": ref}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
