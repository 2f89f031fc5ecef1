#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py                 # full run (one H100)
    python3 chip_smoke.py --skip-e2e      # build + kernel phase only

Phases, in order (any failure exits non-zero before the last line):
  1. device line: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every kernel of ``triforce_tpu_torch/csrc``;
  3. kernels: each kernel (B1, B2 and the row-batched B3 in bf16; B1-int8,
     B2-int8 and B3-int8 over an int8 cache) at the main path's shapes
     against its plain PyTorch version (stated tolerance), with its time,
     its bound, the plain version's time and a library yardstick's time;
     B3 also against B1 row by row (bit equality) and, in device time,
     with dead rows;
  4. reference: the full-width model at cut depth on a short prompt, the
     card's path (through the kernels) against an fp32 CPU run of the same
     weights: bf16 weights and cache, then int8 weights and cache;
  5. end to end: Llama2-7B-128K + Llama-68M at full width with random
     weights: AR, retrieval-spec, TriForce and forced-acceptance TriForce
     through the decoding drivers, first in bf16, then with int8 weights
     and KV (``kv_quant``, ``weight_quant``); each run sets every kernel
     launch count to 0 before and checks it against the count the path
     implies after (the other precision's kernels at 0);
  6. rows: on a 2-layer full-width model, a batched row emits what its
     batch-1 run with the same seed emits;
  7. batched end to end, in each precision after its batch-1 runs: 4 rows
     speculate together (``BatchedSpecEngine``), then 6 requests are
     served through 4 slots by ``SpecScheduler`` (chunked admission
     between decode segments) and by the AR ``Scheduler``; launch counts
     are checked as in 5;
  8. the ``kernels`` JSON line, then the ``ok`` JSON line.

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
H100_INT8_OPS = 1979e12         # dense int8 tensor cores
H100_FP32_FLOPS = 67e12         # fp32 outside the tensor cores
GEN = 128                       # generated tokens per end-to-end mode
GAMMA = 6
ROWS = 4                        # rows (slots) of the batched phases
SERVE_PREFILL = 8192            # prompt tokens of a served request
SERVE_REQUESTS, SERVE_NEW, SERVE_SEGMENT = 6, 32, 4
# int8 kernel tolerances against their plain versions; see kernel_b1 and
# kernel_b2 (B1-int8: over sqrt(k_len + Tn); B2-int8: of the score scale)
INT8_B1_TOL = 0.005
INT8_B2_TOL = 1e-6
# gates of the int8 reference phase over every logit row (PERF.md section 2)
INT8_REF_COSINE = 0.995
INT8_REF_TOP1 = 0.8
INT8_REF_MAX_REL = 0.08         # tests/test_kv_quant.py's own limit
INT8_REF_SCORES_COSINE = 0.99


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


def _device_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device time of one ``fn()``: ``calls`` of them captured into a CUDA
    graph (a measuring device only; the port captures none), the graph
    replayed ``reps`` times, the median replay over ``calls``. Unlike
    ``_time_ms`` it holds no host time, which on a busy host outweighs a
    kernel of ~0.1 ms."""
    fn()
    torch.cuda.synchronize()
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with torch.cuda.stream(side):
        fn()            # the stream's first use happens outside the capture
        with torch.cuda.graph(graph, stream=side):
            for _ in range(calls):
                fn()
    torch.cuda.synchronize()
    return _time_ms(graph.replay, reps=reps) / calls


def _bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------

def kernel_b1(fd, cache_mod, dev, gt, tn, k_len, s, quant=False, hkv=32,
              d=128, seed=0):
    """B1 (or, with ``quant``, B1-int8 over the int8 codes and scales of
    the same cache) at one shape: kernel vs plain, times and bound."""
    name = "B1-int8" if quant else "B1"
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
    rows = torch.arange(gt, device=dev)[:, None] % tn
    mask = (torch.arange(tn, device=dev)[None, :] <= rows).contiguous()
    klen_t = torch.tensor(k_len, dtype=torch.int32, device=dev)
    if quant:
        # the int8 cache the model would commit: codes + per-token scales
        (k8, ks), (v8, vs) = (cache_mod.quantize_tokens(x)
                              for x in (k_st, v_st))
        k, v, ks, vs = k8[1, 0], v8[1, 0], ks[1, 0], vs[1, 0]
        del k_st, v_st

        def kernel(kn):
            return fd.flash_decode_append_int8(q, k, v, kn, vn, klen_t,
                                               mask, ks, vs)

        def plain(kn, m):
            return fd.flash_decode_append_int8_plain(
                q, k, v, kn, vn, klen_t, m, ks, vs, group=fd.KERNEL_GROUP)
    else:
        k, v = k_st[1, 0], v_st[1, 0]

        def kernel(kn):
            return fd.flash_decode_append(q, k, v, kn, vn, klen_t, mask)

        def plain(kn, m):
            return fd.flash_decode_append_plain(q, k, v, kn, vn, klen_t, m)

    # bf16: the kernel rounds p to bf16 against split-local maxima, the
    # plain version against the row maximum, so each p.v term differs by up
    # to 2^-9 relative and the output error shrinks as 1/sqrt(keys). Sound
    # readings at every shape gave err * sqrt(k_len + Tn) = 0.012-0.018
    # (my chip run, PR 1); the tolerance is ~3x that.
    # int8: both sides make the same integer codes of q, k, v and p (the
    # same IEEE divisions and exp), so only fp32 summation order differs,
    # plus a rare bf16 rounding flip of the new block's p. Readings were
    # err * sqrt(k_len + Tn) = 3e-5 .. 1.1e-3 on an H100 (PERF.md); the
    # tolerance is ~4.5x the largest and 10x tighter than bf16's.
    tol = (INT8_B1_TOL if quant else 0.05) / (k_len + tn) ** 0.5

    def check(kn, what):
        out = kernel(kn)
        ref = plain(kn, mask)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            _fail(f"{name} gt={gt} k_len={k_len} {what}: non-finite output")
        return (out - ref).abs().max().item(), ref

    err, _ = check(kn, "random")
    if not err <= tol:
        _fail(f"{name} gt={gt} k_len={k_len}: kernel disagrees with plain "
              f"(err {err:.3e}, tol {tol:.3e})")
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
            alt = plain(kn_dom, m)
            gap = (alt - ref).abs().max().item()
            if not gap > 100 * tol:
                _fail(f"{name} gt={gt}: '{what}' moves the output only "
                      f"{gap:.3e}")
        if not err_new <= tol:
            _fail(f"{name} gt={gt} k_len={k_len}: kernel disagrees with "
                  f"plain when the new block dominates (err {err_new:.3e}, "
                  f"tol {tol:.3e})")
        err = max(err, err_new)
    ms = _time_ms(lambda: kernel(kn))
    plain_ms = _time_ms(lambda: plain(kn, mask), reps=5, warm=1)
    # yardstick: SDPA over [live cache prefix ++ new block] (prepared once;
    # an int8 prefix is dequantized to bf16 first, untimed)
    kp, vp = k[:, :k_len], v[:, :k_len]
    if quant:
        kp = cache_mod.dequantize(kp, ks[:, :k_len], bf)
        vp = cache_mod.dequantize(vp, vs[:, :k_len], bf)
    k_all = torch.cat([kp, kn], 1)[None]
    v_all = torch.cat([vp, vn], 1)[None]
    am = torch.cat([torch.ones(gt, k_len, dtype=torch.bool, device=dev),
                    mask], 1)
    lib_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q[None], k_all, v_all, attn_mask=am))
    # each input read once, the output written once: an int8 prefix is
    # 1 byte a value plus a 4-byte scale a token for K and for V
    cache_bytes = hkv * k_len * (2 * d + 8) if quant \
        else 2 * 2 * hkv * k_len * d
    nbytes = 2 * (q.numel() + 2 * kn.numel()) + cache_bytes \
        + mask.numel() + 4 * hkv * gt * d
    flops = 4.0 * hkv * gt * (k_len + tn) * d
    bound_ms, bound_by = _bound(nbytes, flops,
                                H100_INT8_OPS if quant else H100_BF16_FLOPS)
    row = dict(gt=gt, tn=tn, k_len=k_len, s=s, max_abs_err=err, tol=tol,
               err_dominant_new=err_new, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)
    print(f"{name} gt={gt} tn={tn} k_len={k_len}: err {err:.3e} (tol "
          f"{tol:.3e}; dominant new block {err_new}) kernel {ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}), sdpa {lib_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms", flush=True)
    return row


def kernel_b2(rk, rt, cache_mod, dev, prefill, chunk, budget, s,
              quant=False, hkv=32, d=128, g=1):
    """B2 (or, with ``quant``, B2-int8 over the int8 codes and scales of
    the same keys) at the build shape: kernel vs plain scores and selected
    chunks."""
    name = "B2-int8" if quant else "B2"
    gen = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    q = torch.randn((hkv, g, d), generator=gen, device=dev).to(bf)
    k = torch.randn((hkv, s, d), generator=gen, device=dev).to(bf)
    k[:, prefill:] = 50.0           # past the live prefill: never read
    if quant:
        k, ks = cache_mod.quantize_tokens(k)

        def kernel():
            return rk.chunk_scores_int8(q, k, ks, chunk=chunk,
                                        prefill=prefill)

        def plain():
            return rk.chunk_scores_int8_plain(q, k, ks, chunk=chunk,
                                              prefill=prefill)
        kp = cache_mod.dequantize(k[:, :prefill], ks[:, :prefill], bf)
    else:
        def kernel():
            return rk.chunk_scores(q, k, chunk=chunk, prefill=prefill)

        def plain():
            return rk.chunk_scores_plain(q, k, chunk=chunk, prefill=prefill)
        kp = k[:, :prefill]
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    # bf16: fp32 sums of identical bf16 products in another order, ~1e-7 of
    # the scale; the reading was 1.5e-7 of it on an H100 (PERF.md). int8:
    # exact integer dots, only the scale products and the means round; the
    # reading was 1.5e-7 of the scale too.
    tol = (INT8_B2_TOL if quant else 1e-5) * ref.abs().max().item()
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
                _fail(f"{name} head {h}: chunk {c} selected differently "
                      f"and is not a near-tie")
            n_diff += 1
    ms = _time_ms(kernel)
    plain_ms = _time_ms(plain, reps=5, warm=1)
    # yardstick: einsum + means over the (dequantized, untimed) keys
    lib_ms = _time_ms(lambda: torch.einsum("hgd,hsd->hgs", q, kp).float()
                      .mean(1).reshape(hkv, -1, chunk).mean(-1))
    key_bytes = hkv * prefill * (d + 4) if quant else 2 * hkv * prefill * d
    nbytes = 2 * q.numel() + key_bytes + 4 * out.numel()
    flops = 2.0 * hkv * g * prefill * d
    bound_ms, bound_by = _bound(nbytes, flops,
                                H100_INT8_OPS if quant else H100_FP32_FLOPS)
    print(f"{name} prefill={prefill} chunk={chunk}: err {err:.3e} (tol "
          f"{tol:.3e}), {n_diff} near-tie selection differences; kernel "
          f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), einsum+mean "
          f"{lib_ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    if not err <= tol:
        _fail(f"{name}: kernel disagrees with plain")
    return dict(prefill=prefill, chunk=chunk, max_abs_err=err, tol=tol,
                select_near_ties=n_diff, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)


def kernel_b3(fd, cache_mod, dev, gt, tn, k_full, s, quant=False, hkv=32,
              d=128, seed=0):
    """B3 (or, with ``quant``, B3-int8) at one shape, ROWS rows: the kernel
    against its plain version at ragged lengths (one row dead, one row
    whose new block outweighs its cache), against B1 row by row, and timed
    with every row live and with one row live."""
    name = "B3-int8" if quant else "B3"
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    q = rn(ROWS, hkv, gt, d)
    kn, vn = rn(ROWS, hkv, tn, d), rn(ROWS, hkv, tn, d)
    # layer 1 of a row-stacked [B, L, Hkv, S, D] pool, as the model passes it
    k_st, v_st = rn(ROWS, 2, hkv, s, d), rn(ROWS, 2, hkv, s, d)
    ragged = [k_full, 0, max(tn // 2, 1), (k_full * 5) // 8 + 3]
    for b, n in enumerate(ragged):
        k_st[b, 1, :, n:] = 50.0     # stale tail: must never be read
        v_st[b, 1, :, n:] = 50.0
    mask = fd.causal_mask(tn, tn, gt // tn, dev)       # one for all rows
    if quant:
        (k8, ks), (v8, vs) = (cache_mod.quantize_tokens(x)
                              for x in (k_st, v_st))
        k, v, ks, vs = k8[:, 1], v8[:, 1], ks[:, 1], vs[:, 1]
        del k_st, v_st

        def kernel(kl, rows=slice(None)):
            return fd.flash_decode_append_batched_int8(
                q[rows], k[rows], v[rows], kn[rows], vn[rows], kl, mask,
                ks[rows], vs[rows])

        def plain(kl):
            return fd.flash_decode_append_batched_int8_plain(
                q, k, v, kn, vn, kl, mask, ks, vs, group=fd.KERNEL_GROUP)

        def single(b, kl):
            return fd.flash_decode_append_int8(q[b], k[b], v[b], kn[b],
                                               vn[b], kl[b], mask, ks[b],
                                               vs[b])
    else:
        k, v = k_st[:, 1], v_st[:, 1]

        def kernel(kl, rows=slice(None)):
            return fd.flash_decode_append_batched(
                q[rows], k[rows], v[rows], kn[rows], vn[rows], kl, mask)

        def plain(kl):
            return fd.flash_decode_append_batched_plain(q, k, v, kn, vn, kl,
                                                        mask)

        def single(b, kl):
            return fd.flash_decode_append(q[b], k[b], v[b], kn[b], vn[b],
                                          kl[b], mask)

    def lens(xs):
        return torch.tensor(xs, dtype=torch.int32, device=dev)

    # --- ragged rows against the plain version, per row at B1's tolerance
    # (bf16 0.05, int8 0.005, over sqrt(k_len + Tn); see kernel_b1)
    kl = lens(ragged)
    out, ref = kernel(kl), plain(kl)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        _fail(f"{name} gt={gt}: non-finite output")
    errs, tols = [], []
    for b, n in enumerate(ragged):
        errs.append((out[b] - ref[b]).abs().max().item())
        tols.append((INT8_B1_TOL if quant else 0.05) / (n + tn) ** 0.5)
        if not errs[b] <= tols[b]:
            _fail(f"{name} gt={gt} row {b} k_len={n}: kernel disagrees with "
                  f"plain (err {errs[b]:.3e}, tol {tols[b]:.3e})")
    # the dead row is the attention over its new block alone: poisoning
    # its whole cache moves nothing, and dropping the fold would
    alone = kernel(lens([0]), rows=slice(1, 2))
    if not torch.equal(alone[0], out[1]):
        _fail(f"{name} gt={gt}: the dead row depends on its companions")
    # --- the same device code as B1: every row equals B1 on that row, bit
    # for bit, alone (B = 1) and among its companions
    for b in range(ROWS):
        one = single(b, kl)
        if not torch.equal(kernel(kl[b:b + 1], rows=slice(b, b + 1))[0], one):
            _fail(f"{name} gt={gt}: B = 1 differs from B1 (row {b})")
        if not torch.equal(out[b], one):
            _fail(f"{name} gt={gt}: row {b} of the batch differs from B1")
    # --- device times: every row live, one live row with three dead (the
    # gate saves the dead rows' cache traffic), every row dead, ragged
    live4, live1 = lens([k_full] * ROWS), lens([k_full, 0, 0, 0])
    dead4 = lens([0] * ROWS)
    ms = _device_ms(lambda: kernel(live4))
    ms_gated = _device_ms(lambda: kernel(live1))
    ms_dead = _device_ms(lambda: kernel(dead4))
    ms_ragged = _device_ms(lambda: kernel(kl))
    if not ms_dead < ms_gated < ms:
        _fail(f"{name} gt={gt}: dead rows are not free ({ms:.4f} ms with "
              f"{ROWS} live rows, {ms_gated:.4f} with one, {ms_dead:.4f} "
              f"with none)")
    plain_ms = _time_ms(lambda: plain(live4), reps=3, warm=1)
    # yardstick: SDPA per row over [live prefix ++ new block], summed
    lib = []
    for b in range(ROWS):
        kp, vp = k[b, :, :k_full], v[b, :, :k_full]
        if quant:
            kp = cache_mod.dequantize(kp, ks[b, :, :k_full], bf)
            vp = cache_mod.dequantize(vp, vs[b, :, :k_full], bf)
        k_all = torch.cat([kp, kn[b]], 1)[None]
        v_all = torch.cat([vp, vn[b]], 1)[None]
        am = torch.cat([torch.ones(gt, k_full, dtype=torch.bool, device=dev),
                        mask], 1)
        lib.append(_time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q[b][None], k_all, v_all, attn_mask=am)))
        del k_all, v_all
    lib_ms = sum(lib)

    def bound(row_lens):
        keys = sum(row_lens)
        cache_bytes = hkv * keys * (2 * d + 8) if quant \
            else 2 * 2 * hkv * keys * d
        nbytes = 2 * (q.numel() + 2 * kn.numel()) + cache_bytes \
            + mask.numel() + 4 * ROWS + 4 * q.numel()
        flops = 4.0 * hkv * gt * (keys + ROWS * tn) * d
        return _bound(nbytes, flops,
                      H100_INT8_OPS if quant else H100_BF16_FLOPS)

    bound_ms, bound_by = bound([k_full] * ROWS)
    row = dict(rows=ROWS, gt=gt, tn=tn, k_len=k_full, s=s, ragged=ragged,
               max_abs_err=max(errs), err_by_row=errs, tol_by_row=tols,
               equals_b1_bitwise=True, ms=ms, ms_one_live_three_dead=ms_gated,
               ms_all_dead=ms_dead, ms_ragged=ms_ragged, bound_ms=bound_ms,
               bound_by=bound_by,
               bound_ms_one_live=bound([k_full])[0],
               bound_ms_ragged=bound(ragged)[0], plain_ms=plain_ms,
               library_ms=lib_ms)
    print(f"{name} rows={ROWS} gt={gt} tn={tn} k_len={k_full}: ragged "
          f"{ragged} errs {[f'{e:.2e}' for e in errs]} (tols "
          f"{[f'{t:.2e}' for t in tols]}), every row == B1 bitwise; kernel "
          f"{ms:.4f} ms with 4 live rows (bound {bound_ms:.4f} ms, "
          f"{bound_by}), {ms_gated:.4f} ms with 1 live + 3 dead (bound "
          f"{row['bound_ms_one_live']:.4f}), {ms_dead:.4f} ms all dead, "
          f"{ms_ragged:.4f} ms ragged (device times, CUDA-graph replay); "
          f"sdpa per row summed {lib_ms:.4f} ms, plain {plain_ms:.4f} ms",
          flush=True)
    return row


def unported_bounds() -> dict:
    """The least time for B4, the TPU kernel still to port, at the shape
    the JAX package runs it, int8 KV (its bench's default): each cache
    byte (1 a value + 4 a token for its scale) read once over the HBM
    rate; its operations bound it far lower."""
    def kv_ms(rows, hkv, keys, d=128):
        return rows * hkv * keys * (2 * d + 8) / H100_BYTES_PER_S * 1e3
    return {
        # flash_decode_partials: Llama2-7B (32 heads) AR decode with its
        # 124928-token context split over 4 cards, one card's share
        "B4 partials, 32 heads x 31232 keys (1 of 4 cards)": kv_ms(1, 32,
                                                                  31232),
    }


# ---------------------------------------------------------------------------
# Reference phase: the card's kernel path vs an fp32 CPU run
# ---------------------------------------------------------------------------

def reference_check(tc, llama, cache_mod, rt, dev, quant=False, layers=2,
                    prompt=512):
    """bf16: the card's bf16 weights, activations and cache against fp32
    on the CPU. ``quant``: int8 weights and an int8 cache on both sides
    (the card's activations bf16, through B1-int8 and B2-int8; the CPU's
    fp32, through the dequantizing partials path and chunk_scores_xla)."""
    name = "int8" if quant else "bf16"
    cfg = tc.LLAMA2_7B_128K.with_(num_layers=layers)
    spec = tc.SpecConfig(budget=128, chunk_size=8)
    sets = spec.budget // spec.chunk_size
    p_gpu = llama.init_params(cfg, device=dev, dtype=torch.bfloat16, seed=7)
    if quant:
        p_gpu = llama.quantize_weights(p_gpu)

    def to_cpu(x):   # int8 codes stay int8; everything else fp32
        return x.cpu() if x.dtype == torch.int8 else x.float().cpu()

    p_cpu = {k: ({n: to_cpu(w) for n, w in v.items()} if k == "layers"
                 else to_cpu(v)) for k, v in p_gpu.items()}
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
    planes = ("k", "v", "k_scale", "v_scale") if quant else ("k", "v")
    rt.chunk_scores = recording
    try:
        for side, params, device, dtype in (
                ("gpu", p_gpu, dev, torch.bfloat16),
                ("cpu", p_cpu, torch.device("cpu"), torch.float32)):
            recorded.clear()
            kv = cache_mod.init_kv(cfg, prompt + 16, dtype=dtype,
                                   device=device, quant=quant)
            rkv = cache_mod.init_retrieval(cfg, spec, dtype=dtype,
                                           device=device, quant=quant)
            x = ids.to(device)
            first, kv, _ = llama.forward_append(cfg, params, x[:, :-1], kv)
            logits, kv, rkv = llama.forward_append(
                cfg, params, x[:, -1:], kv, build_rkv=rkv, prefill=prompt,
                chunk_size=spec.chunk_size, budget=spec.budget)
            scores = torch.stack(recorded)                  # [L, Hkv, C]
            sel = rt.select_chunks(scores, sets)            # [L, Hkv, sets]
            # the build wrote exactly the chunks its own scores select:
            # codes and scales alike for an int8 cache
            for li in range(layers):
                idx = sel[li][None].to(device)
                for plane in planes:
                    want = rt.gather_chunks(getattr(kv, plane)[li], idx,
                                            spec.chunk_size)
                    got = getattr(rkv, plane)[li, :, :, :spec.budget]
                    if not torch.equal(got, want):
                        _fail(f"reference {name} [{side}]: layer {li}'s "
                              f"retrieval {plane} is not the gather of its "
                              f"selected chunks")
            # a 3-token verify-shaped forward on top
            more, kv, _ = llama.forward_append(cfg, params, x[:, 5:8], kv)
            outs[side] = (torch.cat([first, logits, more], 1)[0].double()
                          .cpu(), scores, sel)
    finally:
        rt.chunk_scores = chunk_scores
    (lg, sg, selg), (lc, sc, selc) = outs["gpu"], outs["cpu"]

    def cosine(a, b):
        return torch.nn.functional.cosine_similarity(
            a.flatten().double(), b.flatten().double(), dim=0).item()

    # "last": the build token's and the 3-token verify's rows; "all": every
    # row of the prompt too (random-weight logits are nearly flat, so top-1
    # over 4 rows is a coarse statistic)
    stats = {}
    for rows, a, b in (("last", lg[-4:], lc[-4:]), ("all", lg, lc)):
        stats[rows] = dict(
            logits_cosine=cosine(a, b),
            top1_agreement=(a.argmax(-1) == b.argmax(-1)).double().mean()
            .item(),
            max_rel_logit_err=((a - b).abs().max() / b.abs().max()).item())
    cos, top1 = (stats["last"][k] for k in ("logits_cosine",
                                            "top1_agreement"))
    sc_cos = cosine(sg, sc)
    # the two runs' scores differ, so they may pick different chunks. A
    # pick can flip only between chunks whose CPU scores lie within 2e of
    # the k-th best, where e bounds |card - CPU| for the head.
    n_diff = 0
    for li in range(layers):
        for h in range(cfg.num_kv_heads):
            e = (sg[li, h] - sc[li, h]).abs().max().item()
            kth = sc[li, h, 1:].topk(sets - 1).values[-1].item()
            for c in set(selg[li, h].tolist()) ^ set(selc[li, h].tolist()):
                if abs(sc[li, h, c].item() - kth) > 2 * e:
                    _fail(f"reference {name}: layer {li} head {h} chunk {c} "
                          f"selected differently and is not a near-tie")
                n_diff += 1
    agree = 1 - n_diff / (2 * selg.numel())
    print(f"reference {name}: {layers}-layer full-width model, {prompt}-token "
          f"prompt, card vs fp32 CPU: logits (cosine, top-1 agreement, max "
          f"|dlogit| / max |logit|) over the last 4 rows "
          f"{tuple(round(v, 6) for v in stats['last'].values())}, over all "
          f"{lg.shape[0]} rows {tuple(round(v, 6) for v in stats['all'].values())}; "
          f"chunk scores cosine {sc_cos:.6f}, selected chunks agree "
          f"{agree:.4f} ({n_diff} near-tie differences); each retrieval "
          f"cache is the gather of its own selection", flush=True)
    if quant:
        a = stats["all"]
        ok = (a["logits_cosine"] > INT8_REF_COSINE
              and a["top1_agreement"] >= INT8_REF_TOP1
              and a["max_rel_logit_err"] < INT8_REF_MAX_REL
              and sc_cos > INT8_REF_SCORES_COSINE)
    else:
        # bf16 weights and activations vs fp32 agree to well under 1%
        ok = cos > 0.999 and top1 >= 0.9 and sc_cos > 0.999
    if not ok:
        _fail(f"card {name} forward disagrees with the fp32 CPU reference")
    return dict(logits=stats, chunk_scores_cosine=sc_cos,
                selection_agreement=agree, selection_near_ties=n_diff)


# ---------------------------------------------------------------------------
# End-to-end phase
# ---------------------------------------------------------------------------

# kernel wrappers by short name; each counts its own launches
COUNTERS = ("b1", "b1_int8", "b2", "b2_int8", "b3", "b3_int8")


def _wrappers(fd, rk):
    return dict(b1=fd.flash_decode_append, b1_int8=fd.flash_decode_append_int8,
                b2=rk.chunk_scores, b2_int8=rk.chunk_scores_int8,
                b3=fd.flash_decode_append_batched,
                b3_int8=fd.flash_decode_append_batched_int8)


def _reset(fd, rk):
    for fn in _wrappers(fd, rk).values():
        fn.launches = 0


def _check_counts(fd, rk, what, quant, want_b1, want_b2, want_b3=0):
    """The path's kernels (the int8 ones when ``quant``) must have launched
    exactly as often as the path implies, the others never."""
    want = dict.fromkeys(COUNTERS, 0)
    want["b1_int8" if quant else "b1"] = want_b1
    want["b2_int8" if quant else "b2"] = want_b2
    want["b3_int8" if quant else "b3"] = want_b3
    got = {k: fn.launches for k, fn in _wrappers(fd, rk).items()}
    print(f"  launches [{what}]: {got} (path implies {want})", flush=True)
    if got != want:
        _fail(f"{what}: kernel launch counts {got} != {want}")
    return got


def end_to_end(tc, decoding, eng, fd, rk, dev, prefill, quant):
    """All four batch-1 modes at full width on ``eng``; ``quant``: it holds
    int8 weights and int8 KV."""
    tag = "int8 " if quant else ""
    tcfg = eng.target_cfg
    L = tcfg.num_layers
    ids = torch.randint(0, tcfg.vocab_size, (1, prefill),
                        generator=torch.Generator().manual_seed(5)).to(dev)
    # target forwards of one prefill: full chunks + remainder + last token
    body = prefill - 1
    pre_fwd = body // eng.prefill_chunk + (1 if body % eng.prefill_chunk
                                           else 0) + 1
    res = {"launches": {}}

    def check_tokens(name, toks):
        if not all(0 <= t < tcfg.vocab_size for t in toks):
            _fail(f"{tag}{name}: token out of range")

    def counts(what, want_b1, want_b2):
        res["launches"][what] = _check_counts(fd, rk, tag + what, quant,
                                              want_b1, want_b2)
        if what in ("retrieval", "triforce") and not (want_b1 and want_b2):
            _fail(f"{tag}{what}: a kernel of the path was never launched")

    # --- AR
    _reset(fd, rk)
    t0 = time.perf_counter()
    r = decoding.autoregressive(eng, ids, max_len=GEN, seed=0,
                                device=dev)
    total = time.perf_counter() - t0
    check_tokens("ar", r.tokens)
    if len(r.tokens) != GEN + 1:
        _fail(f"{tag}ar: wrong token count")
    counts("ar", L * (pre_fwd + GEN), 0)
    res["ar"] = dict(ms_per_token=1e3 / r.tokens_per_sec,
                     prefill_s=total - r.wall_s, tokens=len(r.tokens))
    print(f"{tag}AR: prefill {total - r.wall_s:.2f} s, "
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
            _fail(f"{tag}{mode}: generated too few tokens")
        # every step: its middle verifies + one full-cache verify
        counts(mode, L * (pre_fwd + r.middle_verifies + r.steps), L)
        res[mode] = dict(ms_per_token=1e3 / r.tokens_per_sec,
                         prefill_s=total - r.wall_s, steps=r.steps,
                         acceptance_rate=r.acceptance_rate,
                         avg_tokens_per_step=r.avg_tokens_per_step,
                         middle_verifies=r.middle_verifies)
        print(f"{tag}{mode}: prefill {total - r.wall_s:.2f} s, "
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
    counts("prefill_target", L * pre_fwd, L)
    _reset(fd, rk)
    t0 = time.perf_counter()
    state, buf, n, counters = eng.generate_forced(state, GEN, 0.9,
                                                  mode="triforce")
    toks = buf[:n].tolist()
    dt = time.perf_counter() - t0
    check_tokens("forced", toks)
    steps, accepted, proposed = (int(x) for x in counters[:3])
    mid_verify = int(counters[7])
    counts("forced", L * (steps + mid_verify), 0)
    want_len = prefill + (n - 1)      # every emitted token but the last
    if int(state.kv.seq_len) != want_len:
        _fail(f"{tag}forced: kv.seq_len {int(state.kv.seq_len)} != "
              f"{want_len}")
    res["forced"] = dict(alpha=0.9, ms_per_token=dt * 1e3 / (n - 1),
                         prefill_target_s=t_pt, prefill_draft_s=t_pd,
                         counters=[int(x) for x in counters],
                         tokens=n - 1)
    print(f"{tag}forced triforce a=0.9: prefill_target {t_pt:.2f} s, "
          f"prefill_draft {t_pd:.2f} s, {dt * 1e3 / (n - 1):.3f} ms/token, "
          f"counters [steps, accepted, proposed, resampled, bonus, "
          f"mid_draft, mid_accept, mid_verify, mid_live] = "
          f"{[int(x) for x in counters]}", flush=True)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return res


def rows_equal_batch1(tc, llama, Engine, bs, dev, quant, layers=2,
                      prefill=1024, steps=3):
    """On the card, a batched row emits what its batch-1 run with the same
    seed emits: a ``layers``-layer full-width target + Llama-68M, 2 rows,
    ``steps`` TriForce steps. Each row's attention is bit-identical in the
    two runs (B3 splits a row as B1 does); the matmuls see 2 rows instead
    of 1, so this holds as long as the library's GEMM sums each output the
    same way at both heights."""
    tag = "int8" if quant else "bf16"
    tcfg, dcfg = tc.LLAMA2_7B_128K.with_(num_layers=layers), tc.LLAMA_68M
    spec = tc.SpecConfig(gamma=GAMMA, budget=256, chunk_size=8)
    eng = Engine(tcfg, spec,
                 llama.init_params(tcfg, device=dev, dtype=torch.bfloat16,
                                   seed=7),
                 draft_cfg=dcfg,
                 draft_params=llama.init_params(dcfg, device=dev,
                                                dtype=torch.bfloat16, seed=8),
                 prefill=prefill, max_cache_len=prefill + 64,
                 dtype=torch.bfloat16, device=dev, kv_quant=quant,
                 weight_quant=quant)
    gen = torch.Generator().manual_seed(9)
    prompts = [torch.randint(0, tcfg.vocab_size, (1, prefill),
                             generator=gen).to(dev) for _ in range(2)]
    seeds = [31, 32]
    want = []
    for ids, seed in zip(prompts, seeds):
        st = eng.prefill_draft(eng.prefill_target(eng.init_state(seed), ids),
                               ids)
        rec = []
        for _ in range(steps):
            st, stats = eng._step_fn("triforce", None)(st)
            rec.append((stats.tokens.tolist(), stats.n_emitted))
        want.append(rec)
    bat = bs.BatchedSpecEngine(eng, mode="triforce")
    state = bat.prefill_rows(prompts, seeds)
    for i in range(steps):
        state, stats = bat.step(state)
        for r in range(2):
            got = (stats.tokens[r].tolist(), int(stats.n_emitted[r]))
            if got != want[r][i]:
                _fail(f"rows [{tag}]: row {r} step {i} emitted {got}, its "
                      f"batch-1 run {want[r][i]}")
    emitted = [[n for _, n in rec] for rec in want]
    print(f"rows [{tag}]: {layers}-layer full-width model, 2 rows x {steps} "
          f"TriForce steps: every batched row emitted its batch-1 run's "
          f"tokens (n_emitted per step {emitted})", flush=True)
    return dict(steps=steps, n_emitted=emitted)


def batched_end_to_end(tc, llama, Engine, bs, batching, fd, rk, dev, tp, dp,
                       quant):
    """Batched speculation and serving at full width, ROWS slots, prompts
    of SERVE_PREFILL tokens. ``tp``/``dp`` are the weights as the batch-1
    engine runs them: with ``quant`` already int8 codes and scales, over
    int8 KV. No token id is an EOS here (random weights would emit one now
    and then), so every request runs to its length."""
    tag = "int8 " if quant else ""
    tcfg, dcfg = tc.LLAMA2_7B_128K, tc.LLAMA_68M
    spec = tc.SpecConfig(gamma=GAMMA, budget=4096, chunk_size=8)
    L, P = tcfg.num_layers, SERVE_PREFILL
    headroom = bs.SpecScheduler.required_headroom(SERVE_NEW, SERVE_SEGMENT,
                                                  GAMMA)
    eng = Engine(tcfg, spec, tp, draft_cfg=dcfg, draft_params=dp, prefill=P,
                 max_cache_len=P + headroom, dtype=torch.bfloat16, device=dev,
                 kv_quant=quant, eos_token_id=-1)
    body = P - 1
    pre_fwd = body // eng.prefill_chunk + bool(body % eng.prefill_chunk) + 1
    gen = torch.Generator().manual_seed(6)
    prompts = [torch.randint(0, tcfg.vocab_size, (1, P), generator=gen)
               for _ in range(SERVE_REQUESTS)]
    res = {"launches": {}}
    torch.cuda.reset_peak_memory_stats()

    def counts(what, b1, b2, b3):
        res["launches"][what] = _check_counts(fd, rk, tag + what, quant, b1,
                                              b2, b3)
        if not b3:
            _fail(f"{tag}{what}: the row-batched kernel was never launched")

    def check_requests(what, done):
        if len(done) != SERVE_REQUESTS:
            _fail(f"{tag}{what}: {len(done)} of {SERVE_REQUESTS} requests "
                  f"completed")
        for r in done:
            if not r.done or len(r.out) != SERVE_NEW or not all(
                    0 <= t < tcfg.vocab_size for t in r.out):
                _fail(f"{tag}{what}: request {r.rid} ended with "
                      f"{len(r.out)} tokens")

    def serve_line(what, sched, done):
        st = sched.stats
        decoded = sum(len(r.out) - 1 for r in done)   # all but the prefill's
        out = dict(admit_s=st["admit_s"], decode_s=st["decode_s"],
                   steps=st["steps"], target_forwards=st["target_forwards"],
                   decode_tokens=decoded,
                   tokens_per_s=decoded / st["decode_s"])
        print(f"{tag}{what}: {SERVE_REQUESTS} requests x {SERVE_NEW} tokens "
              f"through {ROWS} slots: {out['tokens_per_s']:.1f} tokens/s "
              f"over decode segments, admit {st['admit_s']:.2f} s, decode "
              f"{st['decode_s']:.2f} s, {st['steps']} steps, "
              f"{st['target_forwards']} batched target forwards", flush=True)
        return out

    # --- (a) ROWS rows speculate together, TriForce at forced acceptance
    bat = bs.BatchedSpecEngine(eng, mode="triforce", force_accept=0.9)
    _reset(fd, rk)
    t0 = time.perf_counter()
    state = bat.prefill_rows([p.to(dev) for p in prompts[:ROWS]],
                             list(range(ROWS)))
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    counts_pre = _check_counts(fd, rk, tag + "batched prefill_rows", quant,
                               L * pre_fwd * ROWS, L * ROWS)
    res["launches"]["prefill_rows"] = counts_pre
    _reset(fd, rk)
    steps = 8
    t0 = time.perf_counter()
    state, toks, ns, counters, _eos = bat.decode(state, steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts("batched triforce", 0, 0, L * bat.target_forwards)
    if toks.shape != (ROWS, steps, GAMMA + 2) or not (ns >= 1).all():
        _fail(f"{tag}batched triforce: wrong outputs")
    for r in range(ROWS):
        for i in range(steps):
            if not all(0 <= t < tcfg.vocab_size
                       for t in toks[r, i, :ns[r, i]]):
                _fail(f"{tag}batched triforce: token out of range")
    # every emitted token but the last of each row is committed
    want_len = P + ns.sum(1)
    if state.kv.seq_len.tolist() != want_len.tolist():
        _fail(f"{tag}batched triforce: kv.seq_len "
              f"{state.kv.seq_len.tolist()} != {want_len.tolist()}")
    emitted = int(ns.sum())
    res["batched_triforce"] = dict(
        alpha=0.9, rows=ROWS, steps=steps, prefill_rows_s=t_prefill,
        decode_s=dt, tokens=emitted, tokens_per_s=emitted / dt,
        accepted=int(counters[:, 0].sum()), proposed=int(counters[:, 1].sum()),
        target_forwards=bat.target_forwards)
    print(f"{tag}batched triforce a=0.9: {ROWS} rows, prefill_rows "
          f"{t_prefill:.2f} s, {steps} steps in {dt:.2f} s = "
          f"{emitted / dt:.1f} tokens/s ({emitted} tokens, accepted "
          f"{res['batched_triforce']['accepted']} of "
          f"{res['batched_triforce']['proposed']}), "
          f"{bat.target_forwards} batched target forwards", flush=True)
    del state

    # --- (b) speculative serving: chunked admission between segments
    sched = bs.SpecScheduler(eng, mode="triforce", slots=ROWS,
                             segment=SERVE_SEGMENT, bat=bat, admit_chunks=4)
    for i, p in enumerate(prompts):
        sched.submit(batching.Request(rid=i, prompt=p[0].numpy(),
                                      max_new_tokens=SERVE_NEW))
    _reset(fd, rk)
    before = bat.target_forwards
    done = sched.run(max_wall_s=600)
    check_requests("spec serving", done)
    counts("spec serving", L * pre_fwd * SERVE_REQUESTS, L * SERVE_REQUESTS,
           L * (bat.target_forwards - before))
    if sched.state.kv.seq_len.tolist() != [0] * ROWS:
        _fail(f"{tag}spec serving: a drained slot is not gated")
    res["spec_serving"] = serve_line("spec serving (triforce a=0.9)", sched,
                                     done)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del sched, bat
    torch.cuda.empty_cache()

    # --- (c) AR serving over a bf16 pool (the AR scheduler's pool is never
    # int8; with ``quant`` it runs the int8 weights over bf16 KV)
    chunk = 512
    ar = batching.Scheduler(tcfg, spec, eng.t_params, batch=ROWS,
                            max_len=P + SERVE_NEW + 16, prefill_chunk=chunk,
                            dtype=torch.bfloat16, segment=16, device=dev,
                            eos_token_id=-1)
    for i, p in enumerate(prompts):
        ar.submit(batching.Request(rid=i, prompt=p[0].numpy(),
                                   max_new_tokens=SERVE_NEW))
    _reset(fd, rk)
    done = ar.run(max_wall_s=600)
    check_requests("AR serving", done)
    res["launches"]["ar_serving"] = _check_counts(
        fd, rk, tag + "AR serving (bf16 KV)", False,
        L * -(-P // chunk) * SERVE_REQUESTS, 0, L * ar.stats["steps"])
    res["ar_serving"] = serve_line("AR serving", ar, done)
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
        from triforce_tpu_torch import batched_spec, batching, decoding
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
    shapes = [(1, 1, prefill, s_kv),                     # AR decode
              (GAMMA + 2, GAMMA + 2, prefill, s_kv),     # full-cache verify
              (GAMMA + 1, GAMMA + 1, 4096, 4096 + GAMMA + 1),  # middle
              (512, 512, min(16384, prefill), s_kv)]     # prefill tile
    b1 = {quant: [kernel_b1(fd, cache, dev, *sh, quant=quant)
                  for sh in shapes] for quant in (False, True)}
    b2 = {quant: kernel_b2(rk, rt, cache, dev, prefill, 8, 4096, s_kv,
                           quant=quant) for quant in (False, True)}
    # B3 at the batched phases' shapes: ROWS rows of a SERVE_PREFILL-token
    # context in a pool sized as the serving phase sizes it
    s_pool = SERVE_PREFILL + batched_spec.SpecScheduler.required_headroom(
        SERVE_NEW, SERVE_SEGMENT, GAMMA)
    shapes3 = [(1, 1, SERVE_PREFILL, s_pool),                  # batched AR
               (GAMMA + 2, GAMMA + 2, SERVE_PREFILL, s_pool),  # outer verify
               (GAMMA + 1, GAMMA + 1, 4096, 4096 + GAMMA + 1)]  # middle
    b3 = {quant: [kernel_b3(fd, cache, dev, *sh, quant=quant)
                  for sh in shapes3] for quant in (False, True)}
    torch.cuda.empty_cache()
    ref = {name: reference_check(tc, llama, cache, rt, dev, quant=quant)
           for name, quant in (("bf16", False), ("int8", True))}

    # launches of each kernel in its own path's decoding.triforce run
    main_path = dict.fromkeys(COUNTERS)
    by_phase = {}
    if not args.skip_e2e:
        rows_eq = {name: rows_equal_batch1(tc, llama, Engine, batched_spec,
                                           dev, quant)
                   for name, quant in (("bf16", False), ("int8", True))}
        print(json.dumps({"rows_equal_batch1": rows_eq}), flush=True)
        torch.cuda.empty_cache()
        e2e, bat_e2e = {}, {}
        tcfg, dcfg = tc.LLAMA2_7B_128K, tc.LLAMA_68M
        spec = tc.SpecConfig(gamma=GAMMA, budget=4096, chunk_size=8)
        for name, quant in (("bf16", False), ("int8", True)):
            t0 = time.perf_counter()
            tp = llama.init_params(tcfg, device=dev, dtype=torch.bfloat16,
                                   seed=0)
            dp = llama.init_params(dcfg, device=dev, dtype=torch.bfloat16,
                                   seed=1)
            eng = Engine(tcfg, spec, tp, draft_cfg=dcfg, draft_params=dp,
                         prefill=prefill,
                         max_cache_len=prefill + GEN + 4 * (GAMMA + 2),
                         dtype=torch.bfloat16, device=dev, kv_quant=quant,
                         weight_quant=quant)
            if quant:    # the batched phase runs the same int8 weights
                tp, dp = eng.t_params, eng.d_params
            torch.cuda.synchronize()
            print(f"{'int8 ' if quant else ''}weights: "
                  f"{time.perf_counter() - t0:.1f} s to make random weights "
                  f"on the card{' and quantize them' if quant else ''}",
                  flush=True)
            e2e[name] = end_to_end(tc, decoding, eng, fd, rk, dev, prefill,
                                   quant)
            del eng
            torch.cuda.empty_cache()
            # the batch-1 TriForce run counts B1 and B2, the batched phases
            # (rows speculating, then both schedulers) B3
            b12 = ("b1_int8", "b2_int8") if quant else ("b1", "b2")
            for k in b12:
                main_path[k] = e2e[name]["launches"]["triforce"][k]
            print(f"end to end [{name}]: " + json.dumps(e2e[name]),
                  flush=True)
            bat_e2e[name] = batched_end_to_end(
                tc, llama, Engine, batched_spec, batching, fd, rk, dev, tp,
                dp, quant)
            del tp, dp
            torch.cuda.empty_cache()
            k3 = "b3_int8" if quant else "b3"
            lb = bat_e2e[name]["launches"]
            main_path[k3] = lb["batched triforce"][k3] \
                + lb["spec serving"][k3]
            for k in b12 + (k3,):
                by_phase[k] = {ph: v[k] for ph, v in
                               {**e2e[name]["launches"], **lb}.items()}
            print(f"batched end to end [{name}]: " + json.dumps(bat_e2e[name]),
                  flush=True)
        by_phase["b3"]["ar_serving_int8_weights"] = \
            bat_e2e["int8"]["launches"]["ar_serving"]["b3"]

    def b1_entry(name, source_fn, quant, replaces):
        main = b1[quant][0]   # AR decode shape: the path's most frequent
        key = "b1_int8" if quant else "b1"
        return dict(name=name, route="cuda",
                    source="triforce_tpu_torch/csrc/flash_decode.cu",
                    entry_point=source_fn, replaces=replaces,
                    launches=main_path[key],
                    launches_by_phase=by_phase.get(key),
                    max_abs_err=max(r["max_abs_err"] for r in b1[quant]),
                    ms=main["ms"], plain_ms=main["plain_ms"],
                    bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                    library_ms=main["library_ms"], shapes=b1[quant])

    def b2_entry(name, source_fn, quant, replaces):
        r = b2[quant]
        key = "b2_int8" if quant else "b2"
        return dict(name=name, route="cuda",
                    source="triforce_tpu_torch/csrc/chunk_scores.cu",
                    entry_point=source_fn, replaces=replaces,
                    launches=main_path[key],
                    launches_by_phase=by_phase.get(key),
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"],
                    shapes=[r])

    def b3_entry(name, source_fn, quant):
        main = b3[quant][1]   # the outer verify: one per speculation step
        key = "b3_int8" if quant else "b3"
        return dict(name=name, route="cuda",
                    source="triforce_tpu_torch/csrc/flash_decode.cu",
                    entry_point=source_fn,
                    replaces="triforce_tpu/ops/flash_decode.py:516"
                    + (" (quant branch)" if quant else ""),
                    launches=main_path[key],
                    launches_by_phase=by_phase.get(key),
                    max_abs_err=max(r["max_abs_err"] for r in b3[quant]),
                    ms=main["ms"], plain_ms=main["plain_ms"],
                    bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                    library_ms=main["library_ms"], shapes=b3[quant])

    kernels = [
        b1_entry("flash_decode_append", "tf_flash_decode_bf16", False,
                 "triforce_tpu/ops/flash_decode.py:332"),
        b1_entry("flash_decode_append_int8", "tf_flash_decode_int8", True,
                 "triforce_tpu/ops/flash_decode.py:332 (quant branch: "
                 ":41-92, :436-448)"),
        b2_entry("chunk_scores", "tf_chunk_scores_bf16", False,
                 "triforce_tpu/ops/retrieval_kernel.py:101"),
        b2_entry("chunk_scores_int8", "tf_chunk_scores_int8", True,
                 "triforce_tpu/ops/retrieval_kernel.py:101 (quant branch: "
                 ":52-57, :133-145)"),
        b3_entry("flash_decode_append_batched",
                 "tf_flash_decode_batched_bf16", False),
        b3_entry("flash_decode_append_batched_int8",
                 "tf_flash_decode_batched_int8", True),
    ]
    print(json.dumps({"reference": ref}), flush=True)
    print(json.dumps({"bound_ms_of_kernels_to_port": unported_bounds()}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
