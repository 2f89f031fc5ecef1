#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py                 # full run (one H100)
    python3 chip_smoke.py --skip-e2e      # build + kernel phase only
    python3 chip_smoke.py --ab TAG        # time the kernels (B1-B4)
    python3 chip_smoke.py --study         # the kernel study alone
    python3 chip_smoke.py --gqa           # the GQA gates and the CLI alone
    python3 chip_smoke.py --mesh          # the rest of the mesh alone
    python3 chip_smoke.py --moe-window    # the hybrid path's gates alone

Phases, in order (any failure exits non-zero before the last line):
  1. device line: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every kernel of ``triforce_tpu_torch/csrc``;
  3. kernels: each kernel (B1, B2, the row-batched B3 and the cache-only
     partials B4 in bf16; their int8 variants over an int8 cache) at its
     paths' shapes against its plain PyTorch version (stated tolerance),
     with its device time (CUDA-graph replay), its bound, the plain
     version's time and a library yardstick's time; B1 also at the tree
     verify's shapes under an ancestor mask, at the decode path's edges
     (ragged and sub-tile k_len, GT 16 and 17, a GQA row at D = 64) and at
     a GQA prefill tile (GT 4096 at D = 64), with a new block that
     outweighs the cache at every shape with Tn = GT or GT <= 16 (a lost
     fold or an ignored mask shown to fail); B3 also against B1 row by row (bit equality) and with
     dead rows; B4 also merged with a new block against B1, and with an
     empty prefix; every kernel again at the shapes the GQA model of
     phase 10 gives it (TinyLlama-1.1B-128K: 4 KV heads x 64, G = 8; B1
     at its target, middle and tree verifies, B2 at its build, B3 at its
     served rows, B4 at its grow levels and root); then both paths'
     study: per-kernel device times from the profiler at the decode and
     the wide shapes, B1's time against nsplit, registers and CTAs per SM
     of every kernel, B2's time against its launch plan at both models'
     builds and served prefills (lines "b2 plan sweep", each plan
     bit-equal to the wrapper's output); B1 replayed from a graph with
     its dependent phase as a programmatic dependent and as an ordinary
     launch (lines "pdl"); the layer glue (``ops/layer_glue.py``: residual
     add + RMSNorm, RoPE on q and k, silu * up) against its plain versions
     at the main path's shapes (the verifies' 7 and 8 tokens, the rows
     step's 8 x 7, a 512-token chunk, the drafter's width and window):
     RoPE and silu * up bit-equal, the norm's normalised value within one
     ulp, each with its device time, the plain chain's, a library
     yardstick's and its bound (lines "glue ...");
  4. reference: the full-width model at cut depth on a short prompt, the
     card's path (through the kernels) against an fp32 CPU run of the same
     weights: bf16 weights and cache (top-1 may differ only at a near
     tie, and the card's run with the plain attention beside it shows
     the flip does not come from the kernels), then int8 weights and
     cache; at Llama2-7B-128K's widths, then at TinyLlama-1.1B-128K's;
  5. tree gate: on a 2-layer full-width model, the tree verify's logits
     along the deepest root-to-leaf chain equal the sequential forward of
     that chain (cosine > 0.999, top-1 equal up to near ties), and a tree
     step leaves ``kv.seq_len = seq0 + n_nodes`` with
     the compacted slots bit-equal to the verify's KV of the accepted nodes;
  6. rows: on a 2-layer full-width model, a batched row emits what its
     batch-1 run with the same seed emits;
  7. end to end: Llama2-7B-128K + Llama-68M at full width with random
     weights: AR, retrieval-spec, TriForce and forced-acceptance TriForce
     through the decoding drivers, first in bf16, then with int8 weights
     and KV (``kv_quant``, ``weight_quant``); each run sets every kernel
     launch count to 0 before and checks it against the count the path
     implies after (the other precision's kernels at 0; the layer glue's
     counts, which every forward moves, are recorded and must not stay
     0). Every decode mode
     of phases 7-10 runs from CUDA graphs (the engines' default on a card)
     and has a graph gate (lines "graphs [...]"): an eager witness
     (``graphs=False``) of the same seed and prompt runs its first 16
     tokens (4 for the tree, 2 steps for the rows; the whole request set
     for the schedulers), and the graphed run must match it in tokens,
     step counters, ``kv.seq_len`` and launch counts; the timed run's
     captures must equal the gate's shorter run's (a fixed number per
     state). The batch-1, tree and batched generations run on the device
     (one loop graph with if-nodes): every graphed generation call must
     read back once, and each of their gates prints the eager witness's
     read-backs and the device's busy share over the gate's graphed call
     (CUDA events around each graph replay, over the wall less captures).
     The prefills run graphed too (the target's chunk widths, the
     retrieval build, the drafter's chunks): every graph gate's two runs
     hold their prefills' caches (kv to its length, the retrieval cache,
     the drafter window), lengths and first token bit-equal by exact word
     digests (lines "prefill graphs [...]": prefill seconds graphed and
     eager, captures and their seconds, pool bytes, replays by region and
     width, the converted int8 weights' bytes); each decoding call's
     prefill is timed apart from its captures;
  8. tree end to end, in each precision after its batch-1 runs: Sequoia
     tree speculation (``TreeEngine``, a 128-node tree) through
     ``tree_decode``, then at forced acceptance, then with 4 hybrid
     (``ssl``) layers; launch counts are checked as in 7;
  9. batched end to end, in each precision after its tree runs: 4 rows
     speculate together (``BatchedSpecEngine``), then 6 requests are
     served through 4 slots by ``SpecScheduler`` (chunked admission
     between decode segments) and by the AR ``Scheduler``; launch counts
     are checked as in 7; every admitted row is held bit-equal to the
     eager witness's (lines "prefill graphs [... admission]": admit
     seconds graphed and eager, captures, replays; ``SpecScheduler``
     reuses one admission row, so its build replays from the second
     request). The batched steps run on the device too (one loop graph
     a pool, ``BatchedSpecEngine.decode``): their gates also hold eos,
     the target forwards, the dkv lengths and every row's generator
     state; every graphed ``decode`` call and serving segment must read
     back once, the spec-serving pool must capture its loop once, at its
     first segment, and lines "graphs [... segments]" give each
     scheduler's read-backs, its first segment against the rest and the
     device's busy share over the segments, beside the witness's; the
     timed batched run makes two ``decode`` calls (the first captures)
     and reports both;
 10. cli: TinyLlama-1.1B-128K at full width and depth + Llama-68M, random
     weights written as HF checkpoints (the target in two indexed shards)
     and loaded back bit-equal (streaming, and through the native
     checkpoint); every mode of ``triforce_tpu_torch.cli.main`` (ar,
     retrieval, triforce, tree, serve; then ar, triforce, tree with int8
     weights and KV), launch counts checked as in 7; the CLI's AR tokens
     equal ``decoding.autoregressive``'s on the same weights; ``python3 -m
     triforce_tpu_torch.cli --mode ar`` as a process; the card's
     ``measure_phase_times`` table and a profiler trace of two TriForce
     steps of the eager witness (its ten largest device operations; the
     profiler cannot trace the graphed step's if-nodes on this card), the
     phase table graphed
     and eager, and one retrieval build replayed and one eager, each
     under the profiler (lines "cli build trace [...]": B2's device time
     and share beside the build's wall);
 11. sharded (``parallel/``, the batch-1 engine over a mesh): B4 and
     B4-int8 at a rank's shard shapes (the verify, GT 8 over 16 heads; a
     prefill chunk, GT 512, and TinyLlama's G 8 x 512 = 4096 at D 64; an
     empty shard) and B2 over P / 2, in the kernel phase, at the shard of
     every prompt run over a mesh: ``--prefill`` / 2, E2E_PREFILL / 2 =
     8192 keys and, for the verify and the chunk, the two-rank runs'
     SHARD_PREFILL / 2 = 2048 (line "kernel shards: N s"); B4-int8 merged
     with its new block is held to the same merge of its plain partials
     and B1-int8 to its plain version on the same inputs (the merge
     rounds the new block's p against the block's own maximum, B1's fold
     against the row's, so merge(plain B4-int8) is not plain B1-int8 to
     the int8 tolerance: ROADMAP C item 2), a lost or doubled new block
     shown to fail; B1 and B1-int8 at the world-1 prefill's 17th chunk
     (GT 512, Tn 512 over 8192 keys); after each
     precision's end-to-end run, world size 1 over NCCL on this card
     (``Engine(mesh=single_device_mesh(), shard_seq=True)``, graphed, the
     collectives captured in the prefill, step and loop graphs and their
     if-node bodies): its logits on a fixed verify-width input held to the
     meshless engine's by the near-tie rule; from one prefill, 8 tokens
     each of TriForce, forced TriForce and AR held bit for bit against
     the mesh engine's eager witness (one read-back a generation), B4 and
     B2 the only kernels launched (exact counts), ms/token and prefill
     seconds printed beside the meshless gates'; then two gloo ranks on
     the card (child processes of this script, ``--shard-rank``), tp = 2
     and sp = 2 at full width and 8 of the 32 layers, prefill 4096, 8
     TriForce tokens eagerly (cut from 8192 and 32 tokens for the time
     limit, and from 32 layers in PR 15): the same tokens on both ranks,
     logits held as above, per-rank peak memory;
 12. the rest of the mesh (PR 15): B4 at its new shapes in the kernel
     phase (the tree verify over a mesh, GT 128 over ``--prefill`` keys
     and TinyLlama's GT 1024 at D 64; a grow level over 16 heads; a row's
     verify over a 4096-key shard; the composed run's rank, GT 64 over a
     2048-key shard at D 64) and B3 over 16 heads (7B at tp 2, 8192
     keys); after each precision's tree run, ``TreeEngine`` over a world-1
     NCCL mesh (``shard_seq=True``, graphed, the 128-node tree, prompt
     4096: cut from 32768 for the time limit): the grow's root and first
     level and the tree verify on fixed inputs held to the meshless
     tree's logits by the near-tie rule and a cosine floor,
     ``tree_decode``'s and a forced generation held bit for bit against
     the mesh engine's eager witness (one read-back a generation), B4 and
     B2 the only kernels (exact counts), forced ms/step beside the
     meshless tree's at the same prompt; then two gloo ranks on the card
     (``--mesh-rank`` children), 7B bf16 at full width: dp 2
     (``BatchedSpecEngine`` over a dp mesh beside a meshless graphed
     engine, 4 rows at 8192 forced 0.9, two calls of 4 steps; then
     ``SpecScheduler``, 4 slots over dp 2, 4 requests of 16 tokens), each
     rank's rows and requests bit-equal to a meshless run of the same
     rows at the same local batch, and tp 2 (``TreeEngine`` over a tp
     mesh, prefill 4096, two forced steps, eagerly), the same tokens on
     both ranks, per-rank peak memory; then eight gloo ranks on the card,
     TinyLlama-1.1B-128K at full width and depth over dp 2 x tp 2 x sp 2,
     batched retrieval on 4 rows at prefill 4096, 3 steps, eagerly: the
     same tokens on every rank, each dp index's rows bit-equal to its
     (tp, sp) group's run alone, the meshless run's tokens beside them;
 13. hybrid (a model with sliding-window and expert layers), after the
     batched phases: the kernel gate (``kernel_moe_window``, in phase 3:
     the router, the expert kernel, the grouped GEMM and B1's window
     kernel at Mellum2-12B-A2.5B's widths against their plain versions),
     then that model at 4 of its 28 layers end to end
     (``hybrid_end_to_end``): a graphed engine and its eager witness run
     an 8192-token prefill, forced TriForce, forced retrieval speculation
     and AR from one seed, each phase's launch counters zeroed just
     before it; tokens, step counters, expert counts, launch counts and
     cache digests must match after every phase, and each phase must
     launch its kernels (lines "hybrid [...]");
 14. the ``kernels`` JSON line (the hybrid kernels' entries with launches
     from phase 13's TriForce call), then the ``ok`` JSON line.

Cuts for the 1200-second limit (each constant's comment says what it was):
GEN 128 -> 64 -> 32 tokens a batch-1 mode; GATE_TOKENS 32 -> 16 (the
eager witness's share); TREE_GEN 32 -> 16; SERVE_NEW 32 -> 16 (a served
request); the 7B end-to-end, sharded world-1 and tree phases' prompt
32768 -> 16384 (E2E_PREFILL; the kernel phase keeps ``--prefill``'s
shapes and adds E2E_PREFILL's and SHARD_PREFILL's shard shapes); the cli
phase's prompt 32768 -> 16384 and its generations 64 ->
32 (batch-1) and 32 -> 16 (tree, serve); the two-rank tp / sp runs 8192
-> 4096 prompt tokens, 32 -> 8 generated, 32 -> 8 layers; the world-1
tree 32768 -> 4096 prompt tokens. The phases on several ranks run early,
while this process holds little of the card.

Exits non-zero (and prints no result) without a CUDA card or outside the
repository.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # dense bf16 tensor cores
H100_INT8_OPS = 1979e12         # dense int8 tensor cores
H100_FP32_FLOPS = 67e12         # fp32 outside the tensor cores
GEN = 32                        # generated tokens per end-to-end mode
                                # (128 until PR 13, 64 until PR 15: cut
                                # for the time limit when the sharded
                                # phase, then the rest of the mesh, came)
GAMMA = 6
TREE_SIZE, TREE_DEPTH = 128, 12  # planned tree: 128 nodes, 11 levels, W 22
TREE_GEN, TREE_FORCED_GEN = 16, 64  # tree_decode's tokens: 32 until PR 15
#                                     (cut for the time limit)
ROWS = 4                        # rows (slots) of the batched phases
SERVE_PREFILL = 8192            # prompt tokens of a served request
SERVE_REQUESTS, SERVE_NEW, SERVE_SEGMENT = 6, 16, 4  # SERVE_NEW: 32 until
#                                                      PR 15 (time limit)
# int8 kernel tolerances against their plain versions; see kernel_b1 and
# kernel_b2 (B1-int8: over sqrt(k_len + Tn); B2-int8: of the score scale)
INT8_B1_TOL = 0.005
INT8_B2_TOL = 1e-6
# gates of the int8 reference phase over every logit row (PERF.md section 2)
INT8_REF_COSINE = 0.995
INT8_REF_TOP1 = 0.8
INT8_REF_MAX_REL = 0.08         # tests/test_kv_quant.py's own limit
INT8_REF_SCORES_COSINE = 0.99


_T0 = time.perf_counter()


def _stamp(what: str) -> None:
    """The script's elapsed seconds at a phase's start (the time limit
    is the whole script's)."""
    print(f"[{time.perf_counter() - _T0:.0f} s] {what}", flush=True)


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
    graph (a measuring device, apart from the engines' own graphs), the graph
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

def _b1_inputs(cache_mod, dev, gt, tn, k_len, s, quant=False, hkv=32, d=128,
               seed=0, tree_mask=None):
    """B1's inputs at one shape, from ``seed``: q, the new block, a causal
    (or the given ancestor) mask, ``k_len`` on the card and one layer of a
    stacked cache whose slots past ``k_len`` hold 50.0 (never read); with
    ``quant`` the int8 codes and scales of that layer."""
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
    if tree_mask is None:
        rows = torch.arange(gt, device=dev)[:, None] % tn
        mask = (torch.arange(tn, device=dev)[None, :] <= rows).contiguous()
    else:
        mask = torch.as_tensor(tree_mask, device=dev).contiguous()
    x = dict(q=q, kn=kn, vn=vn, mask=mask, ks=None, vs=None,
             klen=torch.tensor(k_len, dtype=torch.int32, device=dev))
    if quant:
        # the int8 cache the model would commit: codes + per-token scales
        (k8, ks), (v8, vs) = (cache_mod.quantize_tokens(t)
                              for t in (k_st, v_st))
        x.update(k=k8[1, 0], v=v8[1, 0], ks=ks[1, 0], vs=vs[1, 0])
    else:
        x.update(k=k_st[1, 0], v=v_st[1, 0])
    return x


def _b1_entry(fd, x, nsplit):
    """One B1 launch through the library's C entry point with a chosen
    ``nsplit`` (the wrapper takes its own), scratch sized by
    ``tf_flash_decode_parts``; for the split sweep only."""
    lib = fd._build.lib(fd._SOURCE)
    q, k, v, kn, vn = (x[n] for n in ("q", "k", "v", "kn", "vn"))
    hkv, gt, d = q.shape
    s, tn = k.shape[1], kn.shape[1]
    parts = lib.tf_flash_decode_parts(gt, nsplit)
    f32 = dict(dtype=torch.float32, device=q.device)
    m_part = torch.empty((hkv, gt, parts), **f32)
    l_part = torch.empty((hkv, gt, parts), **f32)
    acc_part = torch.empty((hkv, gt, parts, d), **f32)
    out = torch.empty((hkv, gt, d), **f32)
    if x["ks"] is None:
        fn, scales = lib.tf_flash_decode_bf16, ()
    else:
        fn = lib.tf_flash_decode_int8
        scales = (x["ks"].data_ptr(), x["ks"].stride(0),
                  x["vs"].data_ptr(), x["vs"].stride(0))
    err = fn(q.data_ptr(), q.stride(0), q.stride(1),
             k.data_ptr(), k.stride(0), k.stride(1),
             v.data_ptr(), v.stride(0), v.stride(1), *scales,
             kn.data_ptr(), kn.stride(0), kn.stride(1),
             vn.data_ptr(), vn.stride(0), vn.stride(1),
             x["mask"].data_ptr(), x["klen"].data_ptr(),
             m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
             out.data_ptr(), hkv, gt, tn, s, d, nsplit, fd._scale(d),
             torch.cuda.current_stream().cuda_stream)
    fd._build.check(err, f"B1 at nsplit {nsplit}")
    return out


def _int8_fold_witness(fd, q, k, v, kn, vn, klen, mask, ks, vs, out, ref):
    """B1-int8 against a second witness: the plain version's cache part
    (its integer codes, in fp32) with the new block folded in fp64, p
    rounded to bf16 from its fp64 value. Gives the kernel's and the plain
    version's distance from it, and the plain version's with its new scores
    from the library's tensor-core GEMM (bf16 in, fp32 accumulators) in
    place of fp32 sums; and where the kernel and the plain version differ
    most: the query row, its allowed new tokens, the cache's and the new
    block's maximum score and the new block's share of the softmax."""
    m, l, acc, q8, qs = fd._int8_cache_partials(q, k, v, klen, ks, vs,
                                                 fd.KERNEL_GROUP)
    qn = (q8 * qs).to(torch.bfloat16)
    bias = torch.where(mask, 0.0, -1e30)

    def fold(sn, dt):
        sn = sn.to(dt) + bias.to(dt)
        m_new = torch.maximum(m.to(dt), sn.amax(-1, keepdim=True))
        alpha = torch.exp(m.to(dt) - m_new)
        pn = torch.exp(sn - m_new)
        l_new = pn.sum(-1, keepdim=True)
        a = acc.to(dt) * alpha + torch.einsum(
            "hgn,hnd->hgd", pn.to(torch.bfloat16).to(dt), vn.to(dt))
        return (a / (l.to(dt) * alpha + l_new)).float(), sn, \
            (l_new / (l.to(dt) * alpha + l_new)).float()

    exact, sn, share = fold(torch.einsum("hgd,hnd->hgn", qn.double(),
                                         kn.double()), torch.float64)
    res = dict(kernel=(out - exact).abs().max().item(),
               plain=(ref - exact).abs().max().item())
    try:
        tc, _, _ = fold(torch.bmm(qn, kn.transpose(1, 2).contiguous(),
                                  out_dtype=torch.float32), torch.float32)
        res["plain_tensor_core_scores"] = (tc - exact).abs().max().item()
        res["plain_tensor_core_scores_vs_kernel"] = \
            (tc - out).abs().max().item()
    except (RuntimeError, TypeError) as e:   # no fp32-out bf16 GEMM
        res["plain_tensor_core_scores"] = repr(e)[:80]
    i = (out - ref).abs().flatten().argmax().item()
    h, r = i // (q.shape[1] * q.shape[2]), (i // q.shape[2]) % q.shape[1]
    res["worst"] = dict(head=h, row=r, allowed=int(mask[r].sum()),
                        m_cache=m[h, r, 0].item(),
                        m_new=sn[h, r].max().item(),
                        new_share=share[h, r, 0].item())
    return res


def kernel_b1(fd, cache_mod, dev, gt, tn, k_len, s, quant=False, hkv=32,
              d=128, seed=0, tree_mask=None):
    """B1 (or, with ``quant``, B1-int8 over the int8 codes and scales of
    the same cache) at one shape: kernel vs plain, times and bound.
    ``tree_mask``: a [GT, Tn] ancestor mask (the tree verify) in place of
    the causal one."""
    name = "B1-int8" if quant else "B1"
    bf = torch.bfloat16
    x = _b1_inputs(cache_mod, dev, gt, tn, k_len, s, quant, hkv, d, seed,
                   tree_mask)
    q, kn, vn, k, v, ks, vs, mask, klen_t = (
        x[n] for n in ("q", "kn", "vn", "k", "v", "ks", "vs", "mask",
                       "klen"))
    if quant:
        def kernel(kn):
            return fd.flash_decode_append_int8(q, k, v, kn, vn, klen_t,
                                               mask, ks, vs)

        def plain(kn, m):
            return fd.flash_decode_append_int8_plain(
                q, k, v, kn, vn, klen_t, m, ks, vs, group=fd.KERNEL_GROUP)
    else:
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
        return (out - ref).abs().max().item(), ref, out

    err, _, _ = check(kn, "random")
    if not err <= tol:
        _fail(f"{name} gt={gt} k_len={k_len}: kernel disagrees with plain "
              f"(err {err:.3e}, tol {tol:.3e})")
    err_new = None
    if gt <= 16 or tn == gt:
        # With random keys the new tokens hold ~Tn/k_len of the softmax
        # weight, too little for a lost fold or a wrong mask to show. Here
        # new key j = 1.5 (q_j + q_{j-1}): row r's allowed token j = r and
        # its masked token j = r + 1 (causal, or not an ancestor of node r)
        # both outscore the whole cache. Not at a GQA tile (Tn < GT > 16):
        # its other groups' rows see many heavy new tokens, whose bf16 p
        # roundings differ from the plain version's past the int8 budget
        # for any order of the fp32 score sums (PERF.md).
        qf = q.float()
        kn_dom = qf.clone()
        kn_dom[:, 1:] += qf[:, :-1]
        kn_dom = (1.5 * kn_dom[:, :tn]).to(bf)
        err_new, ref, out = check(kn_dom, "dominant new block")
        if quant:
            # the plain version's fp32 new scores round some p to the
            # other side of a bf16 step than exact scores do, so the kernel
            # is held to the fp64 fold as well (PERF.md)
            witness = _int8_fold_witness(fd, q, k, v, kn_dom, vn, klen_t,
                                         mask, ks, vs, out, ref)
            print(f"{name} gt={gt} k_len={k_len} dominant new block, "
                  f"distance from the fp64 fold: {json.dumps(witness)}",
                  flush=True)
            if not witness["kernel"] <= tol:
                _fail(f"{name} gt={gt} k_len={k_len}: kernel disagrees with "
                      f"the fp64 fold when the new block dominates (err "
                      f"{witness['kernel']:.3e}, tol {tol:.3e})")
        del out
        # the case has the power to catch each fault (no masked token at 1)
        faults = [("no fold", torch.zeros_like(mask))]
        if not mask.all():   # a mask that hides nothing cannot be ignored
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
    ms = _device_ms(lambda: kernel(kn))
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
    lib_ms = _device_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
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
    row = dict(gt=gt, tn=tn, k_len=k_len, s=s,
               tree_mask=tree_mask is not None, max_abs_err=err, tol=tol,
               err_dominant_new=err_new, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)
    print(f"{name} gt={gt} tn={tn} k_len={k_len}"
          f"{' (ancestor mask)' if tree_mask is not None else ''}: err "
          f"{err:.3e} (tol "
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
    ms = _device_ms(kernel)
    plain_ms = _time_ms(plain, reps=5, warm=1)
    # yardstick: einsum + means over the (dequantized, untimed) keys
    lib_ms = _device_ms(lambda: torch.einsum("hgd,hsd->hgs", q, kp).float()
                        .mean(1).reshape(hkv, -1, chunk).mean(-1))
    key_bytes = hkv * prefill * (d + 4) if quant else 2 * hkv * prefill * d
    nbytes = 2 * q.numel() + key_bytes + 4 * out.numel()
    flops = 2.0 * hkv * g * prefill * d
    bound_ms, bound_by = _bound(nbytes, flops,
                                H100_INT8_OPS if quant else H100_BF16_FLOPS)
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


def kernel_b4(fd, att, cache_mod, dev, gt, k_len, s, quant=False, hkv=32,
              d=128, seed=0, tn=None):
    """B4 (or, with ``quant``, B4-int8), the cache-only partials, at one
    shape: (m, l, acc) against the plain version, the merge with a new
    block of ``tn`` tokens (the grow's self block: GT, or a level's W
    tokens under a GQA model's G groups of rows) against B1 on the same
    inputs (int8: against the same merge of the plain partials, with
    B1-int8 held to its plain version beside it), device time and
    bound."""
    name = "B4-int8" if quant else "B4"
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    tn = gt if tn is None else tn    # the grow's self block
    q, kn, vn = rn(hkv, gt, d), rn(hkv, tn, d), rn(hkv, tn, d)
    # one layer of a stacked [L, 1, Hkv, S, D] cache, as the model passes it
    k_st, v_st = rn(2, 1, hkv, s, d), rn(2, 1, hkv, s, d)
    k_st[1, 0, :, k_len:] = 50.0     # stale tail: must never be read
    v_st[1, 0, :, k_len:] = 50.0
    klen_t = torch.tensor(k_len, dtype=torch.int32, device=dev)
    mask = torch.rand((gt, tn), generator=g, device=dev) < 0.6
    mask[:, 0] = True
    if quant:
        (k8, ks), (v8, vs) = (cache_mod.quantize_tokens(x)
                              for x in (k_st, v_st))
        k, v, ks, vs = k8[1, 0], v8[1, 0], ks[1, 0], vs[1, 0]
        del k_st, v_st

        def kernel():
            return fd.flash_decode_partials_int8(q, k, v, klen_t, ks, vs)

        def plain():
            return fd.flash_decode_partials_int8_plain(
                q, k, v, klen_t, ks, vs, group=fd.KERNEL_GROUP)

        def b1():
            return fd.flash_decode_append_int8(q, k, v, kn, vn, klen_t, mask,
                                               ks, vs)
    else:
        k, v = k_st[1, 0], v_st[1, 0]

        def kernel():
            return fd.flash_decode_partials(q, k, v, klen_t)

        def plain():
            return fd.flash_decode_partials_plain(q, k, v, klen_t)

        def b1():
            return fd.flash_decode_append(q, k, v, kn, vn, klen_t, mask)

    (m, l, acc), (mr, lr, accr) = kernel(), plain()
    torch.cuda.synchronize()
    if not all(torch.isfinite(x).all() for x in (m, l, acc)):
        _fail(f"{name} gt={gt} k_len={k_len}: non-finite partials")
    # B1's tolerance on the normalised acc / l (see kernel_b1), m equal to
    # 1e-5 and l to 1e-4 relative (fp32 sums in another order); acc itself
    # to the same tolerance times l
    tol = (INT8_B1_TOL if quant else 0.05) / max(k_len, 1) ** 0.5
    if k_len == 0:
        # the state the TPU kernel starts from, never -inf
        if not ((m == -1e30).all() and (l == 0).all() and (acc == 0).all()
                and (mr == -1e30).all() and (lr == 0).all()):
            _fail(f"{name} gt={gt}: an empty prefix is not (-1e30, 0, 0)")
        err = err_m = err_l = 0.0
    else:
        err_m = (m - mr).abs().max().item()
        err_l = ((l - lr).abs() / lr).max().item()
        err = (acc / l[..., None] - accr / lr[..., None]).abs().max().item()
        err_acc = ((acc - accr).abs() / lr[..., None]).max().item()
        if not (err_m <= 1e-5 and err_l <= 1e-4 and err <= tol
                and err_acc <= tol):
            _fail(f"{name} gt={gt} k_len={k_len}: kernel disagrees with "
                  f"plain (m {err_m:.3e}, l rel {err_l:.3e}, acc / l "
                  f"{err:.3e}, acc {err_acc:.3e} of l; tol {tol:.3e})")
        # the check has the power to catch a normalisation applied in the
        # kernel: acc / l in acc's place is far outside the tolerance
        gap = ((accr / lr[..., None] - accr).abs() / lr[..., None]).max() \
            .item()
        if not gap > 10 * tol:
            _fail(f"{name} gt={gt} k_len={k_len}: a normalised acc moves "
                  f"the check only {gap:.3e}")
    # finalize(merge(B4, new block)), as a mesh's attention takes it. B1-int8
    # shows its new block bf16(q8 * qs): give the merge's new block that q
    def as_part(p):
        return (p[0].reshape(1, hkv, 1, gt), p[1].reshape(1, hkv, 1, gt),
                p[2].reshape(1, hkv, 1, gt, d))

    if quant:
        qf = (q.float() * fd._scale(d)).to(bf).float()
        q8, qs = fd._quantize_rows(qf)
        qg = (q8 * qs).to(bf).reshape(1, hkv, 1, gt, d)
        pn = att._update(qg, *att._init_partials(q[None], hkv), kn[None],
                         vn[None], mask)
    else:
        pn = att.new_block_partials(q[None], kn[None], vn[None], mask)

    def merge(p, *blocks):
        for b in blocks:
            p = att.merge_partials(p, b)
        return att.finalize(p, torch.float32)[0]

    merged = merge(as_part((m, l, acc)), pn)
    whole = b1()
    torch.cuda.synchronize()
    if not torch.isfinite(merged).all():
        _fail(f"{name} gt={gt} k_len={k_len}: the merge is not finite")
    err_b1 = (merged - whole).abs().max().item()
    tol_b1 = (INT8_B1_TOL if quant else 0.05) / (k_len + tn) ** 0.5
    extra = {}
    if quant:
        # The merge rounds the new block's p to bf16 against the block's own
        # maximum, B1-int8's fold against the row's final one: each p.v term
        # moves by up to 2^-7 of itself, ~1/(k_len + Tn) of an output, so
        # merge(plain B4-int8) vs plain B1-int8 (no kernel in it) reached
        # INT8_B1_TOL / sqrt(k_len + Tn) at GT 512 over 8192 keys (1.03x;
        # ROADMAP C item 2). Each kernel is held to its plain version
        # instead: B4 through the merge to the same merge of its plain
        # partials, B1-int8 to its plain version on these inputs.
        merged_plain = merge(as_part((mr, lr, accr)), pn)
        err_merge = (merged - merged_plain).abs().max().item()
        if not err_merge <= tol_b1:
            _fail(f"{name} gt={gt} k_len={k_len}: merge(B4, new block) "
                  f"differs from merge(plain, new block) by {err_merge:.3e} "
                  f"(tol {tol_b1:.3e})")
        # the check has the power to catch a lost or a doubled new block
        # (doubling it moves nothing where it is all there is)
        faults = {"lost new block": merge(as_part((mr, lr, accr)))}
        if k_len:
            faults["doubled new block"] = merge(as_part((mr, lr, accr)), pn,
                                                pn)
        for what, alt in faults.items():
            gap = (alt - merged_plain).abs().max().item()
            if not gap > 10 * tol_b1:
                _fail(f"{name} gt={gt} k_len={k_len}: a {what} moves the "
                      f"merge only {gap:.3e}")
        whole_plain = fd.flash_decode_append_int8_plain(
            q, k, v, kn, vn, klen_t, mask, ks, vs, group=fd.KERNEL_GROUP)
        err_b1_plain = (whole - whole_plain).abs().max().item()
        if not err_b1_plain <= tol_b1:
            _fail(f"B1-int8 gt={gt} tn={tn} k_len={k_len}: kernel disagrees "
                  f"with plain (err {err_b1_plain:.3e}, tol {tol_b1:.3e})")
        extra = dict(err_merge_vs_plain_merge=err_merge,
                     err_b1_int8_vs_plain=err_b1_plain,
                     err_plain_merge_vs_plain_b1=(
                         merged_plain - whole_plain).abs().max().item())
        del merged_plain, whole_plain
    elif not err_b1 <= tol_b1:
        _fail(f"{name} gt={gt} k_len={k_len}: merge(B4, new block) differs "
              f"from B1 by {err_b1:.3e} (tol {tol_b1:.3e})")
    ms = _device_ms(kernel)
    plain_ms = _time_ms(plain, reps=5, warm=1)
    lib_ms = None
    if k_len:
        # yardstick: SDPA over the live prefix (dequantized first, untimed)
        kp, vp = k[:, :k_len], v[:, :k_len]
        if quant:
            kp = cache_mod.dequantize(kp, ks[:, :k_len], bf)
            vp = cache_mod.dequantize(vp, vs[:, :k_len], bf)
        kp, vp = kp[None].contiguous(), vp[None].contiguous()
        lib_ms = _device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q[None], kp, vp))
    cache_bytes = hkv * k_len * (2 * d + 8) if quant \
        else 2 * 2 * hkv * k_len * d
    nbytes = 2 * q.numel() + cache_bytes + 4 + 4 * hkv * gt * (d + 2)
    flops = 4.0 * hkv * gt * k_len * d
    bound_ms, bound_by = _bound(nbytes, flops,
                                H100_INT8_OPS if quant else H100_BF16_FLOPS)
    if quant:
        merge_note = (
            f"merge vs merge(plain) {extra['err_merge_vs_plain_merge']:.3e}, "
            f"B1-int8 vs plain {extra['err_b1_int8_vs_plain']:.3e} (tol "
            f"{tol_b1:.3e}); not gated: merge vs B1-int8 {err_b1:.3e}, "
            f"merge(plain) vs plain B1-int8 "
            f"{extra['err_plain_merge_vs_plain_b1']:.3e}")
    else:
        merge_note = f"merge vs B1 {err_b1:.3e} (tol {tol_b1:.3e})"
    print(f"{name} gt={gt} hkv={hkv} d={d} tn={tn} k_len={k_len} s={s}: acc "
          f"/ l err {err:.3e} (tol {tol:.3e}), m err {err_m:.1e}, l rel err "
          f"{err_l:.1e}; {merge_note}; kernel {ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), sdpa {lib_ms} ms, plain "
          f"{plain_ms:.4f} ms", flush=True)
    return dict(gt=gt, hkv=hkv, d=d, tn=tn, k_len=k_len, s=s,
                max_abs_err=err, tol=tol, err_m=err_m, err_l_rel=err_l,
                err_merge_vs_b1=err_b1, tol_merge_vs_b1=tol_b1, **extra,
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def _bf16_ulps(a, b) -> int:
    """Largest elementwise distance of two bf16 tensors in ulps (bit
    patterns in sign-magnitude order, so -0 and +0 are one value)."""
    def key(x):
        k = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(k < 0, -(k & 0x7FFF), k)
    return int((key(a) - key(b)).abs().max().item())


def kernel_glue(lg, tc, rope_mod, cache_mod, dev):
    """The layer glue (``ops/layer_glue.py``) against its plain versions
    on the card, in bf16 (the path's type), at the main path's shapes:
    the verifies (T 7 / 8), the rows step (8 rows x 7), a 512-token
    prefill chunk and the drafter's width and 275-slot window, at the
    widths of Llama2-7B-128K (the end-to-end phases), Mistral-7B (GQA 4)
    and Yi-6B's rows (GQA 8; the benchmark's cells), TinyLlama-1.1B (D 64)
    and Llama-68M. RoPE and silu * up must be bit-equal; add + norm's x + y
    bit-equal, its normalised value (a gain of 1) within one ulp and h
    within two (only the order of the fp32 sum of squares differs). Each
    row: the kernel's, the plain chain's and a library yardstick's device
    ms (``_device_ms``: a CUDA graph, as the path runs them) and the bound
    (bytes / 3.35 TB/s). -> {kernel: [row per shape]}"""
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(20)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    def timed(what, fn, plain, lib, nbytes, **row):
        row.update(ms=_device_ms(fn), plain_ms=_device_ms(plain),
                   library_ms=_device_ms(lib),
                   bound_ms=_bound(nbytes, 0, H100_BF16_FLOPS)[0],
                   bound_by="bytes")
        print(f"glue {what}: kernel {row['ms'] * 1e3:.2f} us, plain "
              f"{row['plain_ms'] * 1e3:.2f} us, library "
              f"{row['library_ms'] * 1e3:.2f} us, bound "
              f"{row['bound_ms'] * 1e3:.2f} us", flush=True)
        return row

    out = {"add_rms_norm": [], "rope": [], "silu_mul": []}
    eps = 1e-5
    for rows, hidden, residual in ((1, 4096, True), (7, 4096, True),
                                   (8, 4096, False), (56, 4096, True),
                                   (512, 4096, True), (512, 4096, False),
                                   (7, 768, True), (7, 768, False),
                                   (8, 2048, True)):
        x = rn(1, rows, hidden)
        y = rn(1, rows, hidden, scale=0.3) if residual else None
        w = 1 + rn(hidden, scale=0.1)
        xo, h = lg.add_rms_norm(x, y, w, eps)
        _, n = lg.add_rms_norm(x, y, torch.ones_like(w), eps)
        px, ph = lg.add_rms_norm_plain(x, y, w, eps)
        _, pn = lg.add_rms_norm_plain(x, y, torch.ones_like(w), eps)
        what = f"add_rms_norm rows={rows} hidden={hidden} y={residual}"
        n_ulps, h_ulps = _bf16_ulps(n, pn), _bf16_ulps(h, ph)
        if not torch.equal(xo, px) or n_ulps > 1 or h_ulps > 2:
            _fail(f"{what}: x + y equal {torch.equal(xo, px)}, normalised "
                  f"value {n_ulps} ulps (tol 1), h {h_ulps} ulps (tol 2)")
        err = (h.float() - ph.float()).abs().max().item()
        nbytes = 2 * rows * hidden * (4 if residual else 2) + 2 * hidden
        out["add_rms_norm"].append(timed(
            what, lambda: lg.add_rms_norm(x, y, w, eps),
            lambda: lg.add_rms_norm_plain(x, y, w, eps),
            lambda: torch.nn.functional.rms_norm(
                x if y is None else x + y, (hidden,), w, eps), nbytes,
            rows=rows, hidden=hidden, residual=residual,
            normalised_ulps=n_ulps, h_ulps=h_ulps, max_abs_err=err,
            library="torch.add + F.rms_norm"))

    l7 = tc.LLAMA2_7B_128K
    tables = {}
    for b, hq, hkv, t, d, per_row in (
            (1, 32, 32, 7, 128, False), (1, 32, 32, 8, 128, False),
            (1, 32, 8, 7, 128, False), (8, 32, 4, 7, 128, True),
            (1, 32, 32, 512, 128, False), (1, 32, 4, 8, 64, False),
            (1, 12, 12, 7, 64, False)):
        if d not in tables:
            tables[d] = rope_mod.cos_sin_tables(l7.with_(head_dim=d),
                                                device=dev)
        cos, sin = tables[d]
        pos = torch.randint(0, cos.shape[0], (b, t) if per_row else (t,),
                            generator=g, device=dev)
        q = rn(b, t, hq, d).transpose(1, 2)
        k = rn(b, t, hkv, d).transpose(1, 2)
        what = (f"rope b={b} hq={hq} hkv={hkv} t={t} d={d}"
                f"{' per row' if per_row else ''}")
        rq, rk = lg.rope((q, k), cos, sin, pos)
        if not (torch.equal(rq, lg.rope_plain(q, cos, sin, pos))
                and torch.equal(rk, lg.rope_plain(k, cos, sin, pos))):
            _fail(f"{what}: not bit-equal to the plain version")
        cq, ck = torch.empty_like(rq), torch.empty_like(rk)
        nbytes = 4 * (q.numel() + k.numel()) + pos.numel() * (8 + 8 * d)
        out["rope"].append(timed(
            what, lambda: lg.rope((q, k), cos, sin, pos),
            lambda: (lg.rope_plain(q, cos, sin, pos),
                     lg.rope_plain(k, cos, sin, pos)),
            lambda: (cq.copy_(q), ck.copy_(k)), nbytes,
            b=b, hq=hq, hkv=hkv, t=t, d=d, per_row=per_row, max_abs_err=0.0,
            library="copy_ of q and k (the same bytes)"))
    # the drafter's re-rotation of one layer of its window, every slot
    dcfg = tc.LLAMA_68M
    dkv = cache_mod.init_streaming(dcfg, tc.SpecConfig(gamma=GAMMA),
                                   device=dev)
    dkv.k.copy_(rn(*dkv.k.shape))
    layer, s = dkv.k[1], dkv.real_budget
    cos, sin = rope_mod.cos_sin_tables(dcfg, max_len=s, device=dev)
    slot_pos = torch.arange(s, device=dev)
    (got,) = lg.rope((layer,), cos, sin, slot_pos)
    what = f"rope drafter window slots={s} d={dcfg.head_dim}"
    if not torch.equal(got, lg.rope_plain(layer, cos, sin, slot_pos)):
        _fail(f"{what}: not bit-equal to the plain version")
    cw = torch.empty_like(got)
    out["rope"].append(timed(
        what, lambda: lg.rope((layer,), cos, sin, slot_pos),
        lambda: lg.rope_plain(layer, cos, sin, slot_pos),
        lambda: cw.copy_(layer),
        4 * layer.numel() + s * (8 + 8 * dcfg.head_dim),
        slots=s, heads=dcfg.num_kv_heads, d=dcfg.head_dim, max_abs_err=0.0,
        library="copy_ of the window (the same bytes)"))
    del dkv

    for rows, inter in ((7, 11008), (8, 11008), (7, 14336), (56, 11008),
                        (512, 14336), (512, 11008), (7, 3072)):
        gate, up = rn(1, rows, inter, scale=3.0), rn(1, rows, inter)
        what = f"silu_mul rows={rows} intermediate={inter}"
        if not torch.equal(lg.silu_mul(gate, up),
                           lg.silu_mul_plain(gate, up)):
            _fail(f"{what}: not bit-equal to the plain version")
        out["silu_mul"].append(timed(
            what, lambda: lg.silu_mul(gate, up),
            lambda: lg.silu_mul_plain(gate, up),
            lambda: torch.mul(gate, up), 6 * rows * inter,
            rows=rows, intermediate=inter, max_abs_err=0.0,
            library="torch.mul (one launch, the same bytes)"))
    torch.cuda.synchronize()
    return out


def kernel_moe_window(moe, fd, dev):
    """The hybrid path's kernels on the card against their plain versions
    at Mellum2-12B-A2.5B's widths (hidden 2304, 64 experts of 896, top 8;
    4 KV heads of 128 at GQA 8, a 1024-token window on a 1536-slot ring):
    the expert kernel at 1 / 7 / 8 tokens routed by the router kernel,
    8 tokens routed over 12 experts (skewed), 64 tokens all through one
    expert, and a 512-token chunk through the grouped GEMM; B1's window
    kernel at 1 / 8 / 512 new tokens over rings holding 1023, 1024, 1536
    and 122880 positions (wrapped from 1537 on). Limits: an expert output
    within 2e-3 of the plain version's norm (bf16 roundings of sums taken
    in another order), B1's 0.05 / sqrt(keys) as ``kernel_b1``. Each row:
    device ms (a CUDA graph), the plain version's (host-timed: it reads
    its routing back), a library yardstick's (the grouped GEMM; fused
    attention over the window's keys gathered beforehand) and the bound
    (bytes read / 3.35 TB/s). -> {kernel: [row]}"""
    bf = torch.bfloat16
    h, e, i, k = 2304, 64, 896, 8
    g = torch.Generator(device=dev).manual_seed(31)

    def rn(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(bf)

    wr, wg, wu, wd = (rn(e, h, std=h ** -0.5), rn(e, i, h, std=h ** -0.5),
                      rn(e, i, h, std=h ** -0.5), rn(e, h, i, std=i ** -0.5))
    out = {"moe_experts": [], "moe_route": [], "b1_window": []}
    for n, kind in ((1, "router"), (7, "router"), (8, "router"),
                    (8, "skewed"), (64, "one"), (512, "router")):
        x = rn(n, h)
        ids, w = moe.route(x, wr, k)
        if kind == "router":
            # the plain router's choice, but at a near tie (its k-th and
            # (k+1)-th probabilities within 1e-3), and its weights
            ids_p, w_p = moe.route_plain(x, wr, k)
            top = torch.softmax(x.float() @ wr.float().T, -1).topk(
                k + 1, -1).values
            same = (ids.sort(-1).values == ids_p.sort(-1).values).all(-1)
            tie = top[:, k - 1] - top[:, k] <= 1e-3 * top[:, k - 1]
            w_err = float((w - w_p).abs()[same].max())
            if not bool((same | tie).all()) or not w_err <= 1e-5:
                _fail(f"moe route [{n} tokens]: {int((~same).sum())} "
                      f"choices differ, weights within {w_err}")
        if kind == "skewed":
            ids = torch.stack([torch.randperm(12, generator=g, device=dev)[:k]
                               for _ in range(n)]).to(torch.int32)
        elif kind == "one":
            ids = torch.stack([torch.randperm(e - 1, generator=g,
                                              device=dev)[:k] + 1
                               for _ in range(n)]).to(torch.int32)
            ids[:, 0] = 0
        got = moe.experts(x, ids, w, wg, wu, wd)
        want = moe.combine_plain(moe.expert_outputs_plain(x, ids, wg, wu,
                                                          wd), w)
        rel = float((got.float() - want.float()).norm()
                    / want.float().norm())
        if not rel < 2e-3:
            _fail(f"moe experts [{n} tokens, {kind}]: {rel}")
        read = torch.unique(ids).numel()
        row = dict(tokens=n, routing=kind, experts_read=read, rel_err=rel,
                   ms=_device_ms(lambda: moe.experts(x, ids, w, wg, wu, wd)),
                   plain_ms=_time_ms(lambda: moe.combine_plain(
                       moe.expert_outputs_plain(x, ids, wg, wu, wd), w),
                       reps=5, warm=1),
                   library_ms=_device_ms(lambda: moe._grouped(
                       x, ids, w, wg, wu, wd)),
                   bound_ms=_bound(read * 3 * h * i * 2, 0,
                                   H100_BF16_FLOPS)[0])
        print(f"moe experts [{n} tokens, {kind}, {read} experts]: kernel "
              f"{row['ms'] * 1e3:.1f} us, plain {row['plain_ms'] * 1e3:.1f} "
              f"us, grouped GEMM {row['library_ms'] * 1e3:.1f} us, bound "
              f"{row['bound_ms'] * 1e3:.1f} us, rel {rel:.2e}", flush=True)
        out["moe_experts"].append(row)
        if kind == "router":
            row = dict(tokens=n, w_err=w_err,
                       ms=_device_ms(lambda: moe.route(x, wr, k)),
                       plain_ms=_device_ms(lambda: moe.route_plain(x, wr, k)),
                       bound_ms=_bound(e * h * 2, 0, H100_BF16_FLOPS)[0])
            print(f"moe route [{n} tokens]: kernel {row['ms'] * 1e3:.1f} "
                  f"us, plain {row['plain_ms'] * 1e3:.1f} us", flush=True)
            out["moe_route"].append(row)
    hkv, grp, d, win, ring = 4, 8, 128, 1024, 1536
    for t in (1, 8, 512):
        for length in (1023, 1024, 1536, 122880):
            q, kn, vn = rn(hkv, grp * t, d), rn(hkv, t, d), rn(hkv, t, d)
            kc, vc = rn(hkv, ring, d), rn(hkv, ring, d)
            kl = torch.tensor(length, dtype=torch.int32, device=dev)
            mask = fd.causal_mask(t, t, grp, dev)
            got = fd.flash_decode_window(q, kc, vc, kn, vn, kl, mask, win)
            ref = fd.flash_decode_append_plain(q, kc, vc, kn, vn, kl, mask,
                                               window=win)
            keys = min(length, win - 1)
            err = float((got - ref).abs().max())
            if not err <= 0.05 / (keys + t) ** 0.5:
                _fail(f"b1 window [T {t}, L {length}]: {err}")
            pos = torch.arange(length - keys, length, device=dev) % ring
            kw = torch.cat([kc[:, pos], kn], 1).repeat_interleave(grp, 0)
            vw = torch.cat([vc[:, pos], vn], 1).repeat_interleave(grp, 0)
            qw = q.reshape(hkv, grp, t, d).reshape(hkv * grp, t, d)
            band = (torch.arange(keys + t, device=dev)[None, :]
                    <= torch.arange(keys, keys + t, device=dev)[:, None]) \
                & (torch.arange(keys + t, device=dev)[None, :]
                   > torch.arange(t, device=dev)[:, None] + keys - win)
            row = dict(tokens=t, length=length, max_abs_err=err,
                       ms=_device_ms(lambda: fd.flash_decode_window(
                           q, kc, vc, kn, vn, kl, mask, win)),
                       plain_ms=_device_ms(lambda: fd.flash_decode_append_plain(
                           q, kc, vc, kn, vn, kl, mask, window=win)),
                       library_ms=_device_ms(
                           lambda: torch.nn.functional.scaled_dot_product_attention(
                               qw, kw, vw, attn_mask=band)),
                       bound_ms=_bound(2 * hkv * (keys + t) * d * 2
                                       + 2 * hkv * grp * t * d * 2,
                                       4 * hkv * grp * t * d * (keys + t),
                                       H100_BF16_FLOPS)[0])
            print(f"b1 window [T {t}, L {length}]: kernel "
                  f"{row['ms'] * 1e3:.1f} us, plain {row['plain_ms'] * 1e3:.1f}"
                  f" us, sdpa {row['library_ms'] * 1e3:.1f} us, bound "
                  f"{row['bound_ms'] * 1e3:.1f} us, err {err:.2e}", flush=True)
            out["b1_window"].append(row)
    return out


HYBRID_LAYERS = 4          # Mellum2's widths, its first 4 layers (three
HYBRID_PREFILL = 8192      # sliding, one full); the prompt wraps each ring
HYBRID_TOKENS = 32         # tokens a decode call of the hybrid phase


def _hybrid_wrappers(fd, rk):
    """The kernels a hybrid model's forwards launch, by ``kernels`` name."""
    from triforce_tpu_torch.ops import layer_glue, moe
    return {"flash_decode_append": fd.flash_decode_append,
            "flash_decode_window": fd.flash_decode_window,
            "chunk_scores": rk.chunk_scores, "moe_route": moe.route,
            "moe_experts": moe.experts, "moe_grouped": moe._grouped,
            **{k: getattr(layer_glue, k) for k in GLUE_COUNTERS}}


def hybrid_end_to_end(tc, Engine, llama, fd, rk, dev):
    """The hybrid path end to end (sliding-window layers on rings, expert
    MLPs): Mellum2-12B-A2.5B's widths at HYBRID_LAYERS layers with random
    weights and a Llama-68M drafter, a HYBRID_PREFILL-token prompt. A
    graphed engine and its eager witness (``graphs=False``) run, from one
    seed, the prefill, then forced-acceptance TriForce, retrieval
    speculation and AR calls of HYBRID_TOKENS tokens; each phase zeroes
    the launch counters just before it. The two must leave the same
    tokens, step counters, expert counts, launch counts and cache bits
    (word digests of the full cache to its length, the rings, the
    retrieval cache) after every phase; each phase must launch its kinds'
    kernels (the window kernel, B1 on the full layer, the router, the
    expert kernel in the decode phases and the build token, the grouped
    GEMM in the prefill's chunks alone, B2 in the build alone, silu * up
    where the drafter or the grouped GEMM runs alone).
    -> {"launches":
    {phase: {kernel: n}}, "ms_per_token": {mode: ms}, ...}"""
    cfg = dataclasses.replace(
        tc.MELLUM2_12B_A2_5B, num_layers=HYBRID_LAYERS,
        layer_types=tc.MELLUM2_12B_A2_5B.layer_types[:HYBRID_LAYERS])
    dcfg = tc.LLAMA_68M.with_(vocab_size=cfg.vocab_size)
    spec = tc.SpecConfig(gamma=GAMMA, budget=4096, chunk_size=8)
    params = llama.init_params(cfg, device=dev, seed=11)
    draft = llama.init_params(dcfg, device=dev, seed=12)
    ids = torch.randint(3, cfg.vocab_size, (1, HYBRID_PREFILL),
                        generator=torch.Generator(device=dev).manual_seed(13),
                        device=dev)
    room = HYBRID_PREFILL + 8 * HYBRID_TOKENS + 64
    wrappers = _hybrid_wrappers(fd, rk)

    def forced(mode):
        def run(eng, st):
            st, buf, n, c = eng.generate_forced(st, HYBRID_TOKENS, 0.9,
                                                mode=mode)
            return st, buf[:n].tolist(), c.tolist()
        return run

    def ar(eng, st):
        kv, tok, _, buf = eng.generate_ar(st.kv, st.next_token, st.gen,
                                          HYBRID_TOKENS)
        return (dataclasses.replace(st, kv=kv, next_token=tok),
                buf.tolist(), [])
    decode = (("triforce", forced("triforce")),
              ("retrieval", forced("retrieval")), ("ar", ar))
    runs = {}
    for name, graphs in (("graphed", None), ("eager", False)):
        eng = Engine(cfg, spec, params, draft_cfg=dcfg, draft_params=draft,
                     prefill=HYBRID_PREFILL, max_cache_len=room,
                     graphs=graphs, device=dev)
        rec = {"launches": {}, "seen": {}, "s": {}}

        def phase(what, fn):
            for w in wrappers.values():
                w.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            rec["s"][what] = time.perf_counter() - t0
            rec["launches"][what] = {k: w.launches
                                     for k, w in wrappers.items()}
            return out

        st = phase("prefill", lambda: eng.prefill_draft(
            eng.prefill_target(eng.init_state(7), ids), ids))
        st_ = [st]
        rec["seen"]["prefill"] = [
            _digest([st.kv.k[..., :HYBRID_PREFILL, :],
                     st.kv.v[..., :HYBRID_PREFILL, :], st.kv.ring_k,
                     st.kv.ring_v, st.rkv.k, st.rkv.v]),
            eng.moe_counts.tolist(), int(st.next_token[0])]
        for mode, fn in decode:
            s, toks, counters = phase(mode, lambda: fn(eng, st_[0]))
            st_[0] = s
            n = int(s.kv.seq_len)
            rec["seen"][mode] = [
                toks, counters, n, eng.moe_counts.tolist(),
                _digest([s.kv.k[..., :n, :], s.kv.v[..., :n, :],
                         s.kv.ring_k, s.kv.ring_v, s.rkv.k, s.rkv.v])]
            rec.setdefault("tokens", {})[mode] = len(toks)
        runs[name] = rec
        eng.release_graphs()
        del eng, st, st_
        torch.cuda.empty_cache()
    g, e = runs["graphed"], runs["eager"]
    for what in g["seen"]:
        print(f"hybrid [{what}]: graphed {g['s'][what]:.2f} s, eager "
              f"{e['s'][what]:.2f} s; launches {g['launches'][what]}",
              flush=True)
        if g["seen"][what] != e["seen"][what]:
            _fail(f"hybrid [{what}]: the graphed run's tokens, counters or "
                  f"caches differ from the eager witness's")
        if g["launches"][what] != e["launches"][what]:
            _fail(f"hybrid [{what}]: launches {g['launches'][what]} != the "
                  f"eager witness's {e['launches'][what]}")
        got = g["launches"][what]
        # silu * up runs in the drafter and the grouped GEMM's chunks (the
        # expert kernel fuses it): in retrieval and AR it launches never
        need = ["flash_decode_append", "flash_decode_window", "moe_route",
                "moe_experts", "add_rms_norm", "rope"]
        zero = []
        if what in ("prefill", "triforce"):
            need.append("silu_mul")
        else:
            zero.append("silu_mul")
        if what == "prefill":    # chunks: grouped; the build token: kernel
            need += ["moe_grouped", "chunk_scores"]
            if got["moe_experts"] != HYBRID_LAYERS:
                _fail(f"hybrid [prefill]: the expert kernel launched "
                      f"{got['moe_experts']} times, not once a layer of "
                      f"the build token")
        else:
            zero += ["moe_grouped", "chunk_scores"]
        if any(got[k] == 0 for k in need) or any(got[k] for k in zero):
            _fail(f"hybrid [{what}]: launches {got}: {need} must run, "
                  f"{zero} must not")
    ms = {mode: 1e3 * g["s"][mode] / g["tokens"][mode]
          for mode, _ in decode}
    print(f"hybrid ms/token (graphed, first calls, captures included): "
          f"{ms}", flush=True)
    return {"layers": HYBRID_LAYERS, "prefill": HYBRID_PREFILL,
            "tokens": HYBRID_TOKENS, "launches": g["launches"],
            "seconds": {"graphed": g["s"], "eager": e["s"]},
            "ms_per_token": ms}


def hybrid_entries(kmw, hyb):
    """``kernels`` entries of the hybrid path's kernels: device, plain,
    library and bound ms at a target verify's shape (8 tokens; the grouped
    GEMM at a 512-token chunk, B1's window at 8 over a ring of 122880
    positions) from ``kernel_moe_window``, launches from the TriForce call
    of ``hybrid_end_to_end`` (every phase's beside it)."""
    def entry(name, entry_point, rows, main, err_key, library):
        r = rows[main]
        lb = {ph: lc[name] for ph, lc in hyb["launches"].items()}
        return dict(name=name, route="cuda",
                    source="triforce_tpu_torch/csrc/" + (
                        "flash_decode.cu" if name.startswith("flash")
                        else "moe.cu"),
                    entry_point=entry_point,
                    replaces="none (no JAX counterpart: " + library + ")",
                    launches=lb["triforce"], launches_by_phase=lb,
                    max_abs_err=max(x.get(err_key, 0.0) for x in rows),
                    ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], library_ms=r.get("library_ms"),
                    shapes=rows)
    ex = kmw["moe_experts"]
    return [
        entry("moe_route", "tf_moe_route", kmw["moe_route"], 2, "w_err",
              "the router of a sparse layer"),
        entry("moe_experts", "tf_moe_experts",
              [r for r in ex if r["tokens"] <= 64], 2, "rel_err",
              "the expert kernel: gate/up, down, combine"),
        entry("moe_grouped", "tf_moe_combine",
              [r for r in ex if r["tokens"] > 64], 0, "rel_err",
              "torch._grouped_mm and the combine kernel, prefill chunks"),
        entry("flash_decode_window", "tf_flash_decode_window_bf16",
              kmw["b1_window"], 7, "max_abs_err",
              "B1 over a sliding layer's ring"),
    ]


def _kernel_name(key: str) -> str:
    """A profiler kernel name without its namespace and argument list."""
    return key.replace("(anonymous namespace)::", "").split("(")[0]


def _profile_kernels(fn, calls: int = 5) -> dict:
    """Device ms per call of each kernel ``fn()`` launches, summed by
    kernel name over ``calls`` calls under ``torch.profiler`` (CUDA
    activity), and under "span" the device ms from a call's first kernel
    start to its last kernel end (a programmatic dependent starts before
    its primary ends, so the kernels' times may overlap); {} when the
    profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = next((getattr(e, a) for a in ("device_time_total",
                                            "cuda_time_total")
                   if getattr(e, a, 0)), 0)
        if us and e.count:
            name = _kernel_name(e.key)
            out[name] = out.get(name, 0.0) + us / 1e3 / calls
    kern = sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if str(e.device_type).endswith("CUDA") and e.name
                  and _kernel_name(e.name) in out)
    if out and len(kern) == calls * len(out):
        per = len(out)
        out["span"] = sum(max(b for _, b in kern[i:i + per]) - kern[i][0]
                          for i in range(0, len(kern), per)) / 1e3 / calls
    return out


def _ptxas_kernels(log: str) -> list:
    """(kernel, registers, static smem bytes, spill bytes) of every entry
    function in an ``nvcc -Xptxas -v`` log."""
    rows, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name, spill = ln.split("'")[1], 0
        elif name and "bytes spill stores" in ln:
            spill = int(ln.split("bytes stack frame, ")[1].split()[0])
        elif name and "Used " in ln and "registers" in ln:
            regs = int(ln.split("Used ")[1].split()[0])
            smem = int(ln.split(" bytes smem")[0].split()[-1]) \
                if "bytes smem" in ln else 0
            rows.append((name, regs, smem, spill))
            name = None
    return rows


def _resident_ctas(regs: int, smem: int, threads: int = 128) -> int:
    """CTAs per SM of an H100 for a kernel of ``regs`` registers a thread
    and ``smem`` bytes of shared memory a CTA: registers allocated per warp
    in units of 256, 64K per SM; 228 KB of shared memory per SM with 1 KB
    reserved per CTA; at most 64 warps and 32 CTAs."""
    warps = -(-threads // 32)
    by_regs = 65536 // (-(-regs * 32 // 256) * 256) // warps
    by_smem = 233472 // (smem + 1024)
    return min(by_regs, by_smem, 64 // warps, 32)


def _print_profile(key, prof):
    print(f"profile {key}: " + ", ".join(
        f"{n} {ms:.4f} ms" for n, ms in prof.items())
        if prof else f"profile {key}: not measured (no device time in the "
        "trace)", flush=True)


def _nsplit_sweep(fd, x, key, tol, splits, ref, s, quant):
    """B1's device ms at each of ``splits`` through the C entry point,
    each held to the plain version's output ``ref`` first."""
    sweep = {}
    for ns in splits:
        err = (_b1_entry(fd, x, ns) - ref).abs().max().item()
        if not err <= tol:
            _fail(f"{key} at nsplit {ns}: kernel disagrees with plain "
                  f"(err {err:.3e}, tol {tol:.3e})")
        sweep[ns] = _device_ms(lambda: _b1_entry(fd, x, ns))
    print(f"nsplit sweep {key} (device ms; the wrapper's choice "
          f"{fd._plan(x['q'], s, quant)[0]}): " + ", ".join(
              f"{ns}: {ms:.4f}" for ns, ms in sweep.items()), flush=True)
    return sweep


def b2_plan_sweep(rk, cache_mod, dev, prefill, s, quant, hkv, d, g, cpbs,
                  chunk=8):
    """B2 (or B2-int8) at one build shape through its C entry point under
    plans of ``cpbs`` chunks a block and the wrapper's (blocks a head to
    match), each held bit-equal to the wrapper's output first (a chunk's
    score does not depend on the block that sums it), with its device
    ms."""
    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((hkv, g, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((hkv, s, d), generator=gen, device=dev).to(torch.bfloat16)
    lib = rk._build.lib(rk._SOURCE)
    n = prefill // chunk

    def stream():     # the graph capture's stream while _device_ms captures
        return torch.cuda.current_stream(dev).cuda_stream
    if quant:
        k, ks = cache_mod.quantize_tokens(k)
        want = rk.chunk_scores_int8(q, k, ks, chunk=chunk, prefill=prefill)

        def entry(cpb, out):
            return lib.tf_chunk_scores_int8(
                q.data_ptr(), 1, k.data_ptr(), k.stride(0), k.stride(1),
                ks.data_ptr(), ks.stride(0), out.data_ptr(), hkv, g, d,
                prefill, chunk, cpb, -(-n // cpb), stream())
    else:
        want = rk.chunk_scores(q, k, chunk=chunk, prefill=prefill)

        def entry(cpb, out):
            return lib.tf_chunk_scores_bf16(
                q.data_ptr(), k.data_ptr(), k.stride(0), k.stride(1),
                out.data_ptr(), hkv, g, d, prefill, chunk, cpb,
                -(-n // cpb), stream())
    key = f"{'int8' if quant else 'bf16'} Hkv {hkv} G {g} D {d} P {prefill}"
    choice = rk.plan(q, chunk, prefill, quant)
    sweep = {}
    for cpb in sorted({*cpbs, choice[0]}, reverse=True):
        out = torch.empty_like(want)
        if entry(cpb, out) != 0:
            _fail(f"B2 {key}: the entry point refused {cpb} chunks a block")
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            _fail(f"B2 {key} at {cpb} chunks a block: not the wrapper's bits")
        sweep[cpb] = _device_ms(lambda: entry(cpb, out))
    print(f"b2 plan sweep {key} (device ms by chunks a block; the wrapper's "
          f"choice {choice}): " + ", ".join(
              f"{c}: {ms:.4f}" for c, ms in sweep.items()), flush=True)
    return sweep


def kernel_study(fd, rk, cache_mod, dev, prefill, s_kv, s_rkv, tree_mask):
    """Both paths' phases: per-kernel device times from the profiler at
    B1's decode shapes, the B4 root, and the wide shapes (the prefill tile,
    the tree verify under ``tree_mask``, GT 17, B4's grow level over the
    budget region and over the full cache), both precisions; B1's time
    against ``nsplit`` at the AR, middle-verify, prefill-tile and
    tree-verify shapes (each nsplit also held to the plain version); B1's
    device time at the wide shapes and a GQA prefill tile; the ptxas
    resources of every kernel with its resident CTAs per SM; B2's CTAs per
    SM and its time against its plan at both models' builds and at a
    served request's prefill (``b2_plan_sweep``)."""
    res = {"profile": {}, "nsplit_sweep": {}, "ptxas": []}
    tile = min(16384, prefill)
    n_tree = len(tree_mask)
    # (gt, tn, k_len, s, ancestor mask, nsplit sweep or None)
    shapes = [(1, 1, prefill, s_kv, None, (8, 17, 33, 66, 132, 264)),
              (GAMMA + 2, GAMMA + 2, prefill, s_kv, None, None),
              (GAMMA + 1, GAMMA + 1, 4096, 4096 + GAMMA + 1, None,
               (8, 17, 33, 66, 132, 264)),
              (512, 512, tile, s_kv, None, (1, 2, 3, 4, 6, 8, 12)),
              (n_tree, n_tree, prefill, s_kv + n_tree, tree_mask,
               (1, 2, 4, 8, 9, 16, 32)),
              (17, 17, 4096, 4113, None, None)]
    for quant in (False, True):
        tag = "int8" if quant else "bf16"
        for gt, tn, k_len, s, tmask, splits in shapes:
            x = _b1_inputs(cache_mod, dev, gt, tn, k_len, s, quant,
                           tree_mask=tmask)
            args = [x[n] for n in ("q", "k", "v", "kn", "vn", "klen",
                                   "mask")]
            if quant:
                prof = _profile_kernels(lambda: fd.flash_decode_append_int8(
                    *args, x["ks"], x["vs"]))
            else:
                prof = _profile_kernels(lambda: fd.flash_decode_append(*args))
            key = f"B1 {tag} ({gt}, {tn}, {k_len})" \
                + (" ancestor mask" if tmask is not None else "")
            res["profile"][key] = prof
            _print_profile(key, prof)
            if splits is not None:
                tol = (INT8_B1_TOL if quant else 0.05) / (k_len + tn) ** 0.5
                ref = (fd.flash_decode_append_int8_plain(
                    *args, x["ks"], x["vs"], group=fd.KERNEL_GROUP) if quant
                    else fd.flash_decode_append_plain(*args))
                res["nsplit_sweep"][key] = _nsplit_sweep(
                    fd, x, key, tol, splits, ref, s, quant)
                del ref
            del x, args
        # B4: the root (one row) and a grow level (22 rows) over the tree's
        # retrieval budget, a level over the full cache
        for gt, k_len, s in ((1, 4096, s_rkv), (22, 4096, s_rkv),
                             (22, prefill, s_kv + n_tree)):
            x = _b1_inputs(cache_mod, dev, gt, 1, k_len, s, quant)
            if quant:
                prof = _profile_kernels(lambda: fd.flash_decode_partials_int8(
                    x["q"], x["k"], x["v"], x["klen"], x["ks"], x["vs"]))
            else:
                prof = _profile_kernels(lambda: fd.flash_decode_partials(
                    x["q"], x["k"], x["v"], x["klen"]))
            key = f"B4 {tag} ({gt}, {k_len})"
            res["profile"][key] = prof
            _print_profile(key, prof)
            del x
    # B1's device ms at the wide shapes, wrapper only (the numbers PERF.md
    # compares the wide path's variants by), with the GQA prefill tile
    res["wide_ms"] = {}
    for quant in (False, True):
        for name, (gt, tn, k_len, s, tmask, hkv, d) in {
                "prefill tile": (512, 512, tile, s_kv, None, 32, 128),
                "tree verify": (n_tree, n_tree, prefill, s_kv + n_tree,
                                tree_mask, 32, 128),
                "gt17": (17, 17, 4096, 4113, None, 32, 128),
                "gqa tile": (4096, 512, tile, tile + 512, None, 4, 64)}.items():
            x = _b1_inputs(cache_mod, dev, gt, tn, k_len, s, quant, hkv, d,
                           tree_mask=tmask)
            args = [x[n] for n in ("q", "k", "v", "kn", "vn", "klen", "mask")]
            if quant:
                ms = _device_ms(lambda: fd.flash_decode_append_int8(
                    *args, x["ks"], x["vs"]))
            else:
                ms = _device_ms(lambda: fd.flash_decode_append(*args))
            res["wide_ms"][f"{'int8' if quant else 'bf16'} {name}"] = ms
            del x, args
    print("wide B1 device ms: " + json.dumps(
        {k: round(v, 4) for k, v in res["wide_ms"].items()}), flush=True)
    rows = [r for src in (fd._SOURCE, rk._SOURCE)
            for r in _ptxas_kernels(fd._build.BUILD_LOG.get(src, ""))]
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True).stdout.split("\n")
        rows = [(_kernel_name(n), *r[1:]) for n, r in zip(names, rows)]
    for name, regs, smem, spill in rows:
        ctas = _resident_ctas(regs, smem)
        res["ptxas"].append(dict(kernel=name, registers=regs,
                                 static_smem=smem, spill=spill,
                                 ctas_per_sm_static=ctas))
        print(f"ptxas {name}: {regs} registers, {smem} B static smem, "
              f"{spill} B spill stores -> {ctas} CTAs/SM of 128 threads "
              "(static shared memory only)", flush=True)
    # what the plan reads: the occupancy calculator on the built kernels
    lib = fd._build.lib(fd._SOURCE)
    res["ctas_per_sm"] = {
        f"{path} D={d} {'int8' if quant else 'bf16'}":
            lib.tf_flash_decode_ctas_per_sm(gt, d, int(quant))
        for path, gt in (("decode", 1), ("wide 64 rows", 17),
                         ("wide 128 rows", 128)) for d in (64, 128)
        for quant in (False, True)}
    print(f"CTAs per SM ({fd._wave(dev, 128, False)[0]} SMs): "
          + json.dumps(res["ctas_per_sm"]), flush=True)
    res["b2_ctas_per_sm"] = {
        f"D={d} {'int8' if quant else 'bf16'}":
            rk._wave(dev, d, quant)[1] for d in (64, 128)
        for quant in (False, True)}
    print("B2 CTAs per SM: " + json.dumps(res["b2_ctas_per_sm"]), flush=True)
    # B2's time against its plan (chunks a block) at the build and at a
    # served request's prefill: one wave of long runs, the wrapper's runs
    # of at most 64 KB of keys, and others
    res["b2_sweep"] = {}
    for model, hkv, g, d in (("7B", 32, 1, 128), ("GQA", 4, 8, 64)):
        for quant in (False, True):
            sms, per_sm = rk._wave(dev, d, quant)
            for p in sorted({prefill, SERVE_PREFILL}, reverse=True):
                wave = -(-(p // 8) // max(1, sms * per_sm // hkv))
                res["b2_sweep"][f"{model} {'int8' if quant else 'bf16'} "
                                f"{p}"] = b2_plan_sweep(
                    rk, cache_mod, dev, p, p + 200, quant, hkv, d, g,
                    sorted({wave, 128, 64, 32, 16, 8}, reverse=True))
    return res


def pdl_study(fd, cache_mod, dev, prefill, s_kv, s_tree, tree_mask):
    """B1 (bf16 and int8) replayed from a CUDA graph with its dependent
    phase launched as a programmatic dependent (the default) and as an
    ordinary launch, at the AR step, the target verify and the tree
    verify: the graph keeps the programmatic edge, and this is what it is
    worth there (median device ms of one launch)."""
    shapes = {"ar": (1, 1, prefill, s_kv),
              "verify": (GAMMA + 2, GAMMA + 2, prefill, s_kv),
              "tree verify": (TREE_SIZE, TREE_SIZE, prefill, s_tree)}
    out = {}
    for quant in (False, True):
        for what, (gt, tn, k_len, s) in shapes.items():
            x = _b1_inputs(cache_mod, dev, gt, tn, k_len, s, quant,
                           tree_mask=tree_mask if what == "tree verify"
                           else None)
            if quant:
                def fn():
                    return fd.flash_decode_append_int8(
                        x["q"], x["k"], x["v"], x["kn"], x["vn"], x["klen"],
                        x["mask"], x["ks"], x["vs"])
            else:
                def fn():
                    return fd.flash_decode_append(
                        x["q"], x["k"], x["v"], x["kn"], x["vn"], x["klen"],
                        x["mask"])
            ms = {}
            for on in (True, False, True, False):
                fd.set_programmatic_launch(on)
                ms.setdefault(on, []).append(_device_ms(fn))
            fd.set_programmatic_launch(True)
            key = ("int8 " if quant else "") + what
            out[key] = dict(pdl_ms=min(ms[True]), plain_launch_ms=min(
                ms[False]))
            print(f"pdl [{key}] GT {gt}: B1 from a graph, programmatic "
                  f"dependent {out[key]['pdl_ms']:.4f} ms, ordinary launch "
                  f"{out[key]['plain_launch_ms']:.4f} ms", flush=True)
    return out


def _host_probe(fd, cache_mod, dev, quant):
    """Host us of one B1 wrapper call (best of 5 x 500 calls, no
    synchronisation between them) and its device ms, at GT = 1 over 37 and
    64 keys (the host outruns the card there) and over 32768."""
    out = {}
    g = torch.Generator(device=dev).manual_seed(0)
    for k_len, s in ((37, 64), (64, 4200), (32768, 32928)):
        q, kn, vn = (torch.randn((32, 1, 128), generator=g, device=dev)
                     .to(torch.bfloat16) for _ in range(3))
        k, v = (torch.randn((32, s, 128), generator=g, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        mask = torch.ones(1, 1, dtype=torch.bool, device=dev)
        klen = torch.tensor(k_len, dtype=torch.int32, device=dev)
        if quant:
            (k, ks), (v, vs) = (cache_mod.quantize_tokens(t) for t in (k, v))

            def fn():
                return fd.flash_decode_append_int8(q, k, v, kn, vn, klen,
                                                   mask, ks, vs)
        else:
            def fn():
                return fd.flash_decode_append(q, k, v, kn, vn, klen, mask)
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        best = []
        for _ in range(5):
            t = time.perf_counter()
            for _ in range(500):
                fn()
            best.append((time.perf_counter() - t) / 500 * 1e6)
            torch.cuda.synchronize()
        out[f"k_len={k_len}"] = dict(host_us=min(best),
                                     device_ms=_device_ms(fn))
    return out


def kernel_ab(fd, att, rk, rt, cache_mod, dev, prefill, tree_mask):
    """``--ab``: the kernels of the checkout this file runs in, each
    precision, checked and timed as the kernel phase does them: B1 at the
    decode shapes (AR, target and middle verify) and the wide ones (the
    prefill tile, the tree verify under ``tree_mask``, GT 17, the GQA
    prefill tile: Hkv 4, GT 4096, D 64), B2 at both models' builds
    (Llama2-7B: Hkv 32, G 1, D 128; TinyLlama: Hkv 4, G 8, D 64; chunk
    8) and at a served request's prefill (``SERVE_PREFILL``), B4 at the
    root and at a grow level (GT 22), B3's 4 rows at the batched AR, the
    middle verify and GT 17, and ``_host_probe``. To
    compare two versions on one card, copy this file into the other
    checkout's root and run both in one call on the card (parent, change,
    change, parent)."""
    s_kv = prefill + GEN + 4 * (GAMMA + 2)
    n_tree = len(tree_mask)
    keep = ("ms", "ms_one_live_three_dead", "library_ms", "bound_ms",
            "max_abs_err")
    res = {"b1": {}, "b2": {}, "b3": {}, "b4": {}, "host": {}}
    for quant in (False, True):
        tag = "int8" if quant else "bf16"
        for model, kw in (("7B", dict(hkv=32, g=1, d=128)),
                          ("GQA", dict(hkv=4, g=8, d=64))):
            r = kernel_b2(rk, rt, cache_mod, dev, prefill, 8, 4096, s_kv,
                          quant, **kw)
            res["b2"][f"{tag} {model}"] = {k: r[k] for k in keep if k in r}
            r = kernel_b2(rk, rt, cache_mod, dev, SERVE_PREFILL, 8, 4096,
                          SERVE_PREFILL + s_kv - prefill, quant, **kw)
            res["b2"][f"{tag} {model} {SERVE_PREFILL}"] = {
                k: r[k] for k in keep if k in r}
        for sh in ((1, 1, prefill, s_kv), (GAMMA + 2, GAMMA + 2, prefill,
                                            s_kv),
                   (GAMMA + 1, GAMMA + 1, 4096, 4096 + GAMMA + 1),
                   (512, 512, min(16384, prefill), s_kv),
                   (17, 17, 4096, 4113)):
            r = kernel_b1(fd, cache_mod, dev, *sh, quant=quant)
            res["b1"][f"{tag} {sh[:3]}"] = {k: r[k] for k in keep if k in r}
        r = kernel_b1(fd, cache_mod, dev, n_tree, n_tree, prefill,
                      s_kv + n_tree, quant=quant, tree_mask=tree_mask)
        res["b1"][f"{tag} {(n_tree, n_tree, prefill)} ancestor mask"] = {
            k: r[k] for k in keep if k in r}
        tile = min(16384, prefill)
        r = kernel_b1(fd, cache_mod, dev, 4096, 512, tile, tile + 512,
                      quant=quant, hkv=4, d=64)
        res["b1"][f"{tag} {(4096, 512, tile)} Hkv 4 D 64"] = {
            k: r[k] for k in keep if k in r}
        for sh in ((1, 4096, 4246), (22, 4096, 4246)):
            r = kernel_b4(fd, att, cache_mod, dev, *sh, quant=quant)
            res["b4"][f"{tag} {sh[:2]}"] = {k: r[k] for k in keep if k in r}
        for sh in ((1, 1, 8192, 8352), (GAMMA + 1, GAMMA + 1, 4096,
                                        4096 + GAMMA + 1),
                   (17, 17, 4096, 4113)):
            r = kernel_b3(fd, cache_mod, dev, *sh, quant=quant)
            res["b3"][f"{tag} {sh[:3]}"] = {k: r[k] for k in keep if k in r}
        res["host"][tag] = _host_probe(fd, cache_mod, dev, quant)
    return res


def int8_gemm_probe(llama, dev, rows=22):
    """The library's integer GEMM under ``_wmm(aq=True)`` (no kernel of
    the port: a plain matrix product) at the tree grow's shapes, rows = a
    padded level: exact against an fp64 reference, and its device time
    beside the bf16 product of the same shape, the weight-only int8 path
    (convert the weight, then the bf16 product) and the same integer GEMM
    over a column-major copy of the weight."""
    g = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for k, n in ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)):
        x8 = torch.randint(-127, 128, (rows, k), generator=g, device=dev,
                           dtype=torch.int8)
        w8 = torch.randint(-127, 128, (2, k, n), generator=g, device=dev,
                           dtype=torch.int8)[1]      # a layer of a stack
        got = llama._int_matmul(x8, w8)
        want = (x8.double() @ w8.double()).to(torch.int64)
        if not torch.equal(got.to(torch.int64), want):
            _fail(f"int8 GEMM [{rows}, {k}] x [{k}, {n}] is not exact")
        xb, wb = x8.to(torch.bfloat16), w8.to(torch.bfloat16)
        w_cm = w8.t().contiguous().t()
        out[f"{k}x{n}"] = dict(
            int_mm_ms=_device_ms(lambda: llama._int_matmul(x8, w8)),
            int_mm_colmajor_ms=_device_ms(
                lambda: llama._int_matmul(x8, w_cm)),
            bf16_ms=_device_ms(lambda: torch.matmul(xb, wb)),
            weight_only_ms=_device_ms(
                lambda: torch.matmul(xb, w8.to(torch.bfloat16))))
        del w8, wb, w_cm
    print("int8 GEMM (torch._int_mm, exact), device ms at "
          f"{rows} rows: " + json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# Reference phase: the card's kernel path vs an fp32 CPU run
# ---------------------------------------------------------------------------

def _near_tie_misses(got, ref, rows):
    """Of ``rows`` (where got's top-1 differs from ref's), those that are
    not a near tie: ref's two candidates further apart than twice the
    row's largest |got - ref| logit difference."""
    hard = []
    for r in rows:
        e = (got[r] - ref[r]).abs().max().item()
        gap = (ref[r, ref[r].argmax()] - ref[r, got[r].argmax()]).item()
        if gap > 2 * e:
            hard.append(r)
    return hard


def _flips(a, b):
    return (a.argmax(-1) != b.argmax(-1)).nonzero().flatten().tolist()


def reference_check(tc, llama, cache_mod, rt, fd, dev, quant=False,
                    layers=2, prompt=512, model="llama2-7b-128k"):
    """bf16: the card's bf16 weights, activations and cache against fp32
    on the CPU; and, as the witness of where the card's top-1 flips come
    from, the same card run with the attention and chunk-score kernels
    swapped for their plain versions. ``quant``: int8 weights and an int8
    cache on both sides (the card's activations bf16, through B1-int8 and
    B2-int8; the CPU's fp32, through the dequantizing partials path and
    chunk_scores_xla). ``model``: the preset whose widths the check runs
    at, cut to ``layers``."""
    name = ("int8" if quant else "bf16") + f" {model}"
    cfg = tc.PRESETS[model].with_(num_layers=layers)
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
    rk, kernels = rt.retrieval_kernel, (fd.flash_decode_append,
                                        rt.retrieval_kernel.chunk_scores)
    sides = [("gpu", p_gpu, dev, torch.bfloat16),
             ("cpu", p_cpu, torch.device("cpu"), torch.float32)]
    if not quant:
        sides.append(("plain", p_gpu, dev, torch.bfloat16))
    rt.chunk_scores = recording
    try:
        for side, params, device, dtype in sides:
            if side == "plain":
                fd.flash_decode_append = fd.flash_decode_append_plain
                rk.chunk_scores = rk.chunk_scores_plain
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
        fd.flash_decode_append, rk.chunk_scores = kernels
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
    # rows whose top-1 differs from the CPU's, and those of them that are
    # not a near tie
    flips = _flips(lg, lc)
    hard = _near_tie_misses(lg, lc, flips)
    stats["top1_flips"], stats["top1_flips_not_near_tie"] = flips, hard
    # the witness: the card with the plain attention flips its own rows;
    # where the kernels' top-1 differs from the plain run's it must be a
    # near tie between the two, so each kernel flip is either the plain
    # run's flip too or a near tie between kernel and plain
    if not quant:
        lp = outs["plain"][0]
        kp = _flips(lg, lp)
        stats["plain"] = dict(
            top1_flips=_flips(lp, lc), kernel_vs_plain_cosine=cosine(lg, lp),
            kernel_vs_plain_top1_diffs=kp,
            kernel_vs_plain_not_near_tie=_near_tie_misses(lg, lp, kp))
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
          f"{lg.shape[0]} rows {tuple(round(v, 6) for v in stats['all'].values())}"
          f" (top-1 differs at rows {flips}, {len(hard)} of them not a "
          f"near tie"
          + ("" if quant else
             f"; with the plain attention on the card at rows "
             f"{stats['plain']['top1_flips']}; kernel vs plain cosine "
             f"{stats['plain']['kernel_vs_plain_cosine']:.6f}, top-1 differs"
             f" at rows {stats['plain']['kernel_vs_plain_top1_diffs']}")
          + "); "
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
        # bf16 weights and activations vs fp32 agree to well under 1%; a
        # top-1 flips only at a near tie, and not through the kernels
        pl = stats["plain"]
        ok = (stats["last"]["logits_cosine"] > 0.999
              and stats["all"]["logits_cosine"] > 0.999
              and stats["all"]["top1_agreement"] >= 0.9 and not hard
              and sc_cos > 0.999 and pl["kernel_vs_plain_cosine"] > 0.999
              and not pl["kernel_vs_plain_not_near_tie"])
    if not ok:
        _fail(f"card {name} forward disagrees with the fp32 CPU reference")
    return dict(logits=stats, chunk_scores_cosine=sc_cos,
                selection_agreement=agree, selection_near_ties=n_diff)


# ---------------------------------------------------------------------------
# End-to-end phase
# ---------------------------------------------------------------------------

# kernel wrappers by short name; each counts its own launches
COUNTERS = ("b1", "b1_int8", "b2", "b2_int8", "b3", "b3_int8", "b4",
            "b4_int8")


def _wrappers(fd, rk):
    return dict(b1=fd.flash_decode_append, b1_int8=fd.flash_decode_append_int8,
                b2=rk.chunk_scores, b2_int8=rk.chunk_scores_int8,
                b3=fd.flash_decode_append_batched,
                b3_int8=fd.flash_decode_append_batched_int8,
                b4=fd.flash_decode_partials,
                b4_int8=fd.flash_decode_partials_int8)


# the layer glue's counters (ops/layer_glue.py): every forward launches
# them, so they are recorded beside the path's counts, not held to zero
GLUE_COUNTERS = ("add_rms_norm", "rope", "silu_mul")


def _glue_wrappers():
    from triforce_tpu_torch.ops import layer_glue
    return {k: getattr(layer_glue, k) for k in GLUE_COUNTERS}


def _reset(fd, rk):
    for fn in (*_wrappers(fd, rk).values(), *_glue_wrappers().values()):
        fn.launches = 0


def _check_counts(fd, rk, what, quant, want_b1, want_b2, want_b3=0,
                  want_b4=0):
    """The path's kernels (the int8 ones when ``quant``) must have launched
    exactly as often as the path implies, the others never."""
    want = dict.fromkeys(COUNTERS, 0)
    want["b1_int8" if quant else "b1"] = want_b1
    want["b2_int8" if quant else "b2"] = want_b2
    want["b3_int8" if quant else "b3"] = want_b3
    want["b4_int8" if quant else "b4"] = want_b4
    got = {k: fn.launches for k, fn in _wrappers(fd, rk).items()}
    print(f"  launches [{what}]: {got} (path implies {want})", flush=True)
    if got != want:
        _fail(f"{what}: kernel launch counts {got} != {want}")
    return got


# ---------------------------------------------------------------------------
# Graph gates: every graphed decode mode against its eager witness
# ---------------------------------------------------------------------------

GATE_TOKENS, GATE_STEPS = 16, 2   # the witness's share of a mode (tokens:
                                  # 32 until PR 15, cut for the time limit;
                                  # steps of the rows)
TREE_GATE_TOKENS = 4              # the tree gates' generations (>= 1 step)


def _busy(fn, graphs):
    """``fn()``, a generation whose device work is replays of ``graphs``
    (a ``GraphSet``), and its record: the device's busy ms (the sum over
    the replays of the device time between CUDA events recorded just
    before and just after each, so the host's holding back the device
    shows as the rest), the call's wall ms (device synchronised at both
    ends, the seconds of graphs captured meanwhile left out) and the busy
    share of the wall. The profiler does not serve here: on this card's
    torch CUPTI tracing of a graph with if-nodes crashed the process (a
    segfault in a replay, an illegal address)."""
    replay = torch.cuda.CUDAGraph.replay
    marks = []

    def timed_replay(graph):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        replay(graph)
        b.record()
        marks.append((a, b))
    torch.cuda.CUDAGraph.replay = timed_replay
    s0 = graphs.capture_s
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0 - (graphs.capture_s - s0))
    finally:
        torch.cuda.CUDAGraph.replay = replay
    busy = sum(a.elapsed_time(b) for a, b in marks)
    return out, dict(busy_ms=busy, wall_ms=wall, share=busy / wall,
                     replays=len(marks))


def _eager_twin(eng):
    """The eager witness (``graphs=False``) of a graphed engine: the same
    configs, settings and weights (shared, not copied; int8 codes pass
    ``quantize_weights`` unchanged)."""
    from triforce_tpu_torch.engine import Engine
    from triforce_tpu_torch.tree.spectree import TreeEngine
    if isinstance(eng, TreeEngine):
        return TreeEngine(
            eng.cfg, eng.gm, eng.params, prefill=eng.prefill,
            max_cache_len=eng.max_cache_len - eng.gm.size - eng.W,
            budget=eng.budget, chunk_size=eng.chunk_size,
            temperature=eng.temperature, top_p=eng.top_p,
            eos_ids=eng.eos_ids, dtype=eng.dtype,
            prefill_chunk=eng.prefill_chunk, kv_quant=eng.kv_quant,
            weight_quant=eng.weight_quant, ssl=eng.ssl, device=eng.device,
            graphs=False, mesh=eng.mesh, shard_seq=eng.shard_seq)
    return Engine(eng.target_cfg, eng.spec, eng.t_params,
                  draft_cfg=eng.draft_cfg, draft_params=eng.d_params,
                  prefill=eng.prefill, max_cache_len=eng.max_cache_len,
                  eos_token_id=eng.eos_token_id, dtype=eng.dtype,
                  prefill_chunk=eng.prefill_chunk,
                  draft_prefill_chunk=eng.draft_prefill_chunk,
                  kv_quant=eng.kv_quant, device=eng.device, graphs=False,
                  mesh=eng.mesh, shard_seq=eng.shard_seq)


def _snap(graphs):
    return (graphs.captures, graphs.capture_s, graphs.pool_bytes)


def _since(graphs, snap):
    """(captures, capture seconds, pool bytes) ``graphs`` added since
    ``snap``."""
    now = _snap(graphs)
    return dict(captures=now[0] - snap[0], capture_s=now[1] - snap[1],
                pool_bytes=now[2] - snap[2])


def _decode_since(graphs, snap, r):
    """``_since`` over a ``decoding`` call, less the graphs its prefill
    captured (``DecodeResult.prefill_captures``): the decode's share."""
    d = _since(graphs, snap)
    d["captures"] -= r.prefill_captures
    d["capture_s"] -= r.prefill_capture_s
    return d


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _digest(tensors) -> list:
    """Exact digests of ``tensors``, to hold two runs' caches bit-equal
    without keeping both on the card: per tensor its dtype and shape and,
    per index of its leading axis, two int64 sums (mod 2^64) of its 32-bit
    words, one plain and one with each word weighted by a 32-bit hash of
    its position (Knuth's multiplicative one: distinct for every
    position). Bit-equal tensors give equal digests; a change of one word,
    or an exchange of two, always changes them; any other difference goes
    unseen only where it cancels in both sums."""
    out = []
    for t in tensors:
        sums = []
        for part in (t.unbind(0) if t.dim() > 1 else [t.reshape(-1)]):
            b = part.contiguous().view(torch.uint8).reshape(-1)
            if b.numel() % 4:
                b = torch.cat([b, b.new_zeros(-b.numel() % 4)])
            a = w = 0
            for i, piece in enumerate(b.view(torch.int32).split(1 << 25)):
                x = piece.to(torch.int64)
                pos = (((torch.arange(x.numel(), device=x.device)
                         + (i << 25)) * 2654435761) & 0xFFFFFFFF) + 1
                a += int(x.sum())
                w += int((x * pos).sum())
            sums.append((a, w))
        out.append((str(t.dtype), tuple(t.shape), sums))
    return out


def _planes(c):
    return [getattr(c, n) for n in ("k", "v", "k_scale", "v_scale")
            if getattr(c, n, None) is not None]


def _prefill_tensors(kv, rkv, dkv, token):
    """What a prefill leaves in a batch-1 state (or a pool's row): the full
    cache's planes up to its length, the retrieval cache's and the drafter
    window's planes whole, the lengths and the first token."""
    n = int(kv.seq_len)
    out = [kv.seq_len.reshape(()), token.reshape(-1)]
    out += [p[:, :, :, :n] for p in _planes(kv)]
    if rkv is not None:
        out += _planes(rkv)
    if dkv is not None:
        out += [dkv.seq_len.reshape(())] + _planes(dkv)
    return out


def _dense_bytes(eng):
    """Bytes of the prefill's converted copy of int8 weights that ``eng``
    holds (0 for bf16 weights or before its first graphed prefill)."""
    dense = getattr(eng, "_dense", None)
    params = getattr(eng, "t_params", None) or eng.params
    if dense is None:
        return 0
    pairs = [(dense["lm_head"], params["lm_head"])] + [
        (dense["layers"][k], params["layers"][k]) for k in dense["layers"]]
    return sum(d.numel() * d.element_size() for d, p in pairs if d is not p)


def _prefill_run(eng, fn):
    """``fn()``, a prefill on ``eng`` returning its state: the state and
    its record: seconds (device synchronised at both ends, the graphs'
    capture seconds left out), the graphs captured and replayed meanwhile
    (replays by region and width), the pool bytes they added, the
    converted int8 weights' bytes and the digest of what it left."""
    g = eng.graphs
    c0, s0, p0 = g.captures, g.capture_s, g.pool_bytes
    r0 = dict(g.replays_by)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    cap = g.capture_s - s0
    rep = {k: n - r0.get(k, 0) for k, n in g.replays_by.items()
           if n != r0.get(k, 0)}
    return st, dict(prefill_s=dt - cap, captures=g.captures - c0,
                    capture_s=cap, pool_bytes=g.pool_bytes - p0,
                    replays=rep, dense_bytes=_dense_bytes(eng),
                    allocated_gib=torch.cuda.memory_allocated() / 2**30,
                    digest=_digest(_prefill_tensors(
                        st.kv, st.rkv, getattr(st, "dkv", None),
                        st.next_token)))


def prefill_line(what, g, e, unit="prefill"):
    """The line of a prefill graph gate: the graphed run's record ``g``
    (``_prefill_run``) beside the eager witness's ``e``."""
    print(f"prefill graphs [{what}]: graphed {unit} {g['prefill_s']:.3f} s "
          f"(+ {g['captures']} captures in {g['capture_s']:.3f} s, pool "
          f"+{g['pool_bytes'] / 2**20:.1f} MiB), eager witness "
          f"{e['prefill_s']:.3f} s; kv to seq_len, rkv, the drafter's "
          f"window (if any), lengths and first token bit-equal "
          f"({len(g['digest'])} tensors' word digests); replays "
          f"{json.dumps(g['replays'])}; converted int8 "
          f"weights {g['dense_bytes'] / 2**30:.2f} GiB; "
          f"{g['allocated_gib']:.1f} GiB allocated", flush=True)
    return {k: v for k, v in g.items() if k != "digest"} | dict(
        eager_s=e["prefill_s"])


def ar_gate_run(llama, eng, ids, seed, n=GATE_TOKENS):
    """``decoding.autoregressive``'s steps on ``eng``, for a gate: the
    prefill, then ``n`` tokens."""
    def run():
        state = eng.init_state(seed)
        kv = eng.prefill_body(state.kv, ids[:, :-1])
        logits, kv, _ = llama.forward_append(eng.target_cfg, eng.t_params,
                                             ids[:, -1:], kv, **eng.fwd)
        tok = eng._sample_next(logits, state.gen)
        first = int(tok[0])
        c0 = eng.graphs.captures
        (kv, _, gen, buf), dt = _timed(
            lambda: eng.generate_ar(kv, tok, state.gen, n))
        return dict(tokens=[first] + buf.tolist(), counters=None,
                    seq_len=int(kv.seq_len), decode_s=dt, n=n,
                    captures=eng.graphs.captures - c0)
    return run


def spec_gate_run(eng, ids, mode, seed, alpha=None, n=GATE_TOKENS):
    """The steps of ``decoding.retrieval_spec`` / ``triforce`` (or, with
    ``alpha``, of ``generate_forced``) on ``eng``, for a gate."""
    def prefill():
        st = eng.prefill_target(eng.init_state(seed), ids)
        return eng.prefill_draft(st, ids) if mode == "triforce" else st

    def gen(st):
        if alpha is None:
            return eng.generate(st, n, mode=mode)
        return eng.generate_forced(st, n, alpha, mode=mode)

    def run():
        st, pre = _prefill_run(eng, prefill)
        c0, r0 = eng.graphs.captures, eng.graphs.readbacks
        busy = None
        if eng.graphs.enabled:
            (st, buf, m, c), busy = _busy(lambda: gen(st), eng.graphs)
            dt = busy["wall_ms"] / 1e3
        else:
            (st, buf, m, c), dt = _timed(lambda: gen(st))
        return dict(tokens=buf[:m].tolist(), counters=[int(x) for x in c],
                    seq_len=int(st.kv.seq_len), decode_s=dt, n=m - 1,
                    captures=eng.graphs.captures - c0, prefill=pre,
                    readbacks=eng.graphs.readbacks - r0, steps=int(c[0]),
                    busy=busy)
    return run


def tree_gate_run(eng, ids, seed, alpha=None, n=TREE_GATE_TOKENS):
    """``tree_decode``'s generation of ``n`` tokens (or a forced one) on
    ``eng``, for a gate; the counters held are [steps, nodes, stop] (the
    third generation counter, the call's read-backs, is reported)."""
    def gen(st):
        if alpha is None:
            return eng.generate(st, n)
        return eng.generate_forced(st, n, alpha)

    def run():
        st, pre = _prefill_run(
            eng, lambda: eng.prefill_target(eng.init_state(seed), ids))
        c0 = eng.graphs.captures
        busy = None
        if eng.graphs.enabled:
            (st, buf, m, c, stop), busy = _busy(lambda: gen(st), eng.graphs)
            dt = busy["wall_ms"] / 1e3
        else:
            (st, buf, m, c, stop), dt = _timed(lambda: gen(st))
        return dict(tokens=buf[:m].tolist(),
                    counters=[int(c[0]), int(c[1]), bool(stop)],
                    seq_len=int(st.kv.seq_len), decode_s=dt, n=m - 1,
                    captures=eng.graphs.captures - c0, prefill=pre,
                    readbacks=int(c[2]), steps=int(c[0]), busy=busy)
    return run


def rows_gate_run(bs, eng, mode, prompts, seeds, alpha, steps=GATE_STEPS):
    """One ``BatchedSpecEngine.decode`` call of ``steps`` batched steps on
    ``eng`` (a loop graph's replays where it is graphed), for a gate: the
    counters held are n_emitted, the per-row counters, eos, the target
    forwards and every row's generator state; the lengths kv's and dkv's."""
    def run():
        bat = bs.BatchedSpecEngine(eng, mode=mode, force_accept=alpha)
        state = bat.prefill_rows(prompts, seeds)
        c0, r0 = eng.graphs.captures, eng.graphs.readbacks
        busy = None
        if eng.graphs.enabled:
            (state, toks, ns, c, eos), busy = _busy(
                lambda: bat.decode(state, steps), eng.graphs)
            dt = busy["wall_ms"] / 1e3
        else:
            (state, toks, ns, c, eos), dt = _timed(
                lambda: bat.decode(state, steps))
        return dict(tokens=toks.tolist(),
                    counters=[ns.tolist(), c.tolist(), eos.tolist(),
                              bat.target_forwards,
                              [g.get_state().tolist() for g in state.gens]],
                    seq_len=[state.kv.seq_len.tolist(),
                             None if state.dkv is None
                             else state.dkv.seq_len.tolist()],
                    decode_s=dt, n=int(ns.sum()),
                    captures=eng.graphs.captures - c0,
                    readbacks=eng.graphs.readbacks - r0, steps=steps,
                    busy=busy)
    return run


def graph_gate(what, fd, rk, graphed, eager):
    """One mode's graph gate: ``graphed()`` and ``eager()`` run the same
    seed and prompt (``*_gate_run``) on a graphed engine and on its eager
    witness; tokens, step counters, kv lengths and kernel launch counts
    must be equal (the regions replay the same kernels on the same inputs
    with the same Philox offsets)."""
    res = {}
    for tag, fn in (("graphed", graphed), ("eager", eager)):
        _reset(fd, rk)
        r = fn()
        r["launches"] = {k: f.launches for k, f in _wrappers(fd, rk).items()}
        res[tag] = r
    g, e = res["graphed"], res["eager"]
    for key in ("tokens", "counters", "seq_len", "launches"):
        if g[key] != e[key]:
            _fail(f"graph gate [{what}]: the graphed run's {key} {g[key]} "
                  f"differ from the eager witness's {e[key]}")
    if not g["captures"]:
        _fail(f"graph gate [{what}]: the graphed run captured no graph")
    if "readbacks" in g and g["readbacks"] != 1:
        _fail(f"graph gate [{what}]: the graphed generation read back "
              f"{g['readbacks']} times, not once")
    out = dict(tokens=e["tokens"], n_tokens=e["n"],
               eager_ms_per_token=1e3 * e["decode_s"] / max(e["n"], 1),
               graphed_ms_per_token=1e3 * g["decode_s"] / max(g["n"], 1),
               gate_captures=g["captures"],
               launches=sum(e["launches"].values()),
               launches_by_kernel=e["launches"],
               counters=e["counters"])
    if "readbacks" in g:
        out.update(readbacks=g["readbacks"], steps=g["steps"],
                   eager_readbacks=e["readbacks"], busy=g.get("busy"))
    if "prefill" in g:
        # the prefill's own gate: its caches and first token bit-equal
        gp, ep = g["prefill"], e["prefill"]
        if gp["digest"] != ep["digest"]:
            bad = [i for i, (a, b) in enumerate(zip(gp["digest"],
                                                    ep["digest"])) if a != b]
            _fail(f"prefill graph gate [{what}]: the graphed prefill left "
                  f"other bits than the eager witness's (tensors {bad} of "
                  f"kv length, first token, kv, rkv, dkv planes)")
        if not gp["captures"] or ep["captures"]:
            _fail(f"prefill graph gate [{what}]: {gp['captures']} graphed "
                  f"captures, {ep['captures']} eager")
        out["prefill"] = prefill_line(what, gp, ep)
    return out


def mode_graphs(what, d, ms_graphed, timed_tokens, gate):
    """Report a graphed mode beside its gate: ms/token graphed and eager,
    the timed run's captures ``d`` (``_since``; they must equal the gate's:
    a fixed number per state, however many steps), their seconds and the
    pool bytes; the timed run's first tokens must be the witness's."""
    if d["captures"] != gate["gate_captures"]:
        _fail(f"graphs [{what}]: the timed run captured {d['captures']} "
              f"graphs, the gate's shorter run {gate['gate_captures']}")
    want = gate["tokens"]
    if timed_tokens is not None and timed_tokens[:len(want)] != want:
        _fail(f"graphs [{what}]: the timed run's first tokens differ from "
              f"the eager witness's")
    out = dict(ms_per_token_graphed=ms_graphed,
               ms_per_token_eager=gate["eager_ms_per_token"],
               gate_tokens=gate["n_tokens"],
               gate_ms_per_token_graphed=gate["graphed_ms_per_token"],
               gate_token_ids=gate["tokens"],
               gate_prefill_s=gate.get("prefill", {}).get("prefill_s"), **d)
    loop = ""
    if "readbacks" in gate:
        b = gate["busy"]
        out.update(readbacks=gate["readbacks"], busy=b,
                   eager_readbacks=gate["eager_readbacks"])
        loop = (f"; device loop: {gate['readbacks']} read-back a call "
                f"({gate['steps']} steps; the eager witness "
                f"{gate['eager_readbacks']}), device busy {b['busy_ms']:.1f} "
                f"of {b['wall_ms']:.1f} ms ({100 * b['share']:.1f}%) over "
                f"the gate's call ({b['replays']} graph replays, captures "
                f"left out)")
    print(f"graphs [{what}]: graphed {ms_graphed:.3f} ms/token, eager "
          f"witness {gate['eager_ms_per_token']:.3f} ms/token; gate: "
          f"{gate['n_tokens']} tokens, counters, kv.seq_len and "
          f"{gate['launches']} kernel launches equal; {d['captures']} "
          f"captures in {d['capture_s']:.3f} s (as many as the gate's "
          f"run), pool {d['pool_bytes'] / 2**20:.1f} MiB{loop}", flush=True)
    return out


def end_to_end(tc, decoding, llama, eng, fd, rk, dev, prefill, quant):
    """All four batch-1 modes at full width on ``eng`` (graphed), each with
    its graph gate against an eager witness; ``quant``: it holds int8
    weights and int8 KV."""
    tag = "int8 " if quant else ""
    tcfg = eng.target_cfg
    L = tcfg.num_layers
    witness = _eager_twin(eng)
    ids = torch.randint(0, tcfg.vocab_size, (1, prefill),
                        generator=torch.Generator().manual_seed(5)).to(dev)
    # target forwards of one prefill: full chunks + remainder + last token
    body = prefill - 1
    pre_fwd = body // eng.prefill_chunk + (1 if body % eng.prefill_chunk
                                           else 0) + 1
    res = {"launches": {}, "glue_launches": {}, "graphs": {}}

    def check_tokens(name, toks):
        if not all(0 <= t < tcfg.vocab_size for t in toks):
            _fail(f"{tag}{name}: token out of range")

    def counts(what, want_b1, want_b2):
        res["launches"][what] = _check_counts(fd, rk, tag + what, quant,
                                              want_b1, want_b2)
        glue = {k: fn.launches for k, fn in _glue_wrappers().items()}
        print(f"  glue launches [{tag}{what}]: {glue}", flush=True)
        if not all(glue.values()):
            _fail(f"{tag}{what}: a layer glue kernel was never launched")
        res["glue_launches"][what] = glue
        if what in ("retrieval", "triforce") and not (want_b1 and want_b2):
            _fail(f"{tag}{what}: a kernel of the path was never launched")

    # --- AR
    _reset(fd, rk)
    snap = _snap(eng.graphs)
    r = decoding.autoregressive(eng, ids, max_len=GEN, seed=0,
                                device=dev)
    d = _decode_since(eng.graphs, snap, r)
    check_tokens("ar", r.tokens)
    if len(r.tokens) != GEN + 1:
        _fail(f"{tag}ar: wrong token count")
    counts("ar", L * (pre_fwd + GEN), 0)
    res["ar"] = dict(ms_per_token=1e3 / r.tokens_per_sec,
                     prefill_s=r.prefill_s, tokens=len(r.tokens),
                     prefill_captures=r.prefill_captures,
                     prefill_capture_s=r.prefill_capture_s)
    print(f"{tag}AR: prefill {r.prefill_s:.2f} s (+ {r.prefill_captures} "
          f"captures in {r.prefill_capture_s:.2f} s), "
          f"{1e3 / r.tokens_per_sec:.3f} ms/token", flush=True)
    res["graphs"]["ar"] = mode_graphs(
        tag + "ar", d, 1e3 / r.tokens_per_sec, r.tokens,
        graph_gate(tag + "ar", fd, rk, ar_gate_run(llama, eng, ids, 0),
                   ar_gate_run(llama, witness, ids, 0)))
    torch.cuda.empty_cache()

    # --- retrieval-spec and TriForce through the drivers
    for mode, fn in (("retrieval", decoding.retrieval_spec),
                     ("triforce", decoding.triforce)):
        _reset(fd, rk)
        snap = _snap(eng.graphs)
        r = fn(eng, ids, max_len=GEN, seed=1, device=dev)
        d = _decode_since(eng.graphs, snap, r)
        check_tokens(mode, r.tokens)
        if len(r.tokens) < GEN + 1:
            _fail(f"{tag}{mode}: generated too few tokens")
        # every step: its middle verifies + one full-cache verify
        counts(mode, L * (pre_fwd + r.middle_verifies + r.steps), L)
        if r.readbacks != 1:
            _fail(f"{tag}{mode}: the generation read back {r.readbacks} "
                  f"times, not once")
        res[mode] = dict(ms_per_token=1e3 / r.tokens_per_sec,
                         prefill_s=r.prefill_s, steps=r.steps,
                         prefill_captures=r.prefill_captures,
                         prefill_capture_s=r.prefill_capture_s,
                         acceptance_rate=r.acceptance_rate,
                         avg_tokens_per_step=r.avg_tokens_per_step,
                         middle_verifies=r.middle_verifies,
                         readbacks=r.readbacks)
        print(f"{tag}{mode}: prefill {r.prefill_s:.2f} s (+ "
              f"{r.prefill_captures} captures in "
              f"{r.prefill_capture_s:.2f} s), "
              f"{1e3 / r.tokens_per_sec:.3f} ms/token, {r.steps} steps, "
              f"acceptance {r.acceptance_rate:.3f}, "
              f"{r.avg_tokens_per_step:.2f} tokens/step, {r.readbacks} "
              f"read-back", flush=True)
        res["graphs"][mode] = mode_graphs(
            tag + mode, d, 1e3 / r.tokens_per_sec, r.tokens,
            graph_gate(tag + mode, fd, rk, spec_gate_run(eng, ids, mode, 1),
                       spec_gate_run(witness, ids, mode, 1)))
        torch.cuda.empty_cache()

    # --- TriForce at forced acceptance 0.9 (every forward still runs)
    _reset(fd, rk)
    state, pt = _prefill_run(
        eng, lambda: eng.prefill_target(eng.init_state(2), ids))
    state, pd = _prefill_run(eng, lambda: eng.prefill_draft(state, ids))
    t_pt, t_pd = pt["prefill_s"], pd["prefill_s"]
    counts("prefill_target", L * pre_fwd, L)
    print(f"{tag}graphed prefill (seed 2): target {t_pt:.3f} s (+ "
          f"{pt['captures']} captures in {pt['capture_s']:.3f} s, replays "
          f"{json.dumps(pt['replays'])}), drafter {t_pd:.3f} s (+ "
          f"{pd['captures']} captures in {pd['capture_s']:.3f} s, replays "
          f"{json.dumps(pd['replays'])})", flush=True)
    _reset(fd, rk)
    snap = _snap(eng.graphs)
    r0 = eng.graphs.readbacks
    t0 = time.perf_counter()
    state, buf, n, counters = eng.generate_forced(state, GEN, 0.9,
                                                  mode="triforce")
    toks = buf[:n].tolist()
    readbacks = eng.graphs.readbacks - r0
    d = _since(eng.graphs, snap)
    if readbacks != 1:
        _fail(f"{tag}forced: the generation read back {readbacks} times")
    dt = time.perf_counter() - t0 - d["capture_s"]
    check_tokens("forced", toks)
    steps, accepted, proposed = (int(x) for x in counters[:3])
    mid_verify = int(counters[7])
    counts("forced", L * (steps + mid_verify), 0)
    want_len = prefill + (n - 1)      # every emitted token but the last
    if int(state.kv.seq_len) != want_len:
        _fail(f"{tag}forced: kv.seq_len {int(state.kv.seq_len)} != "
              f"{want_len}")
    del state
    res["forced"] = dict(alpha=0.9, ms_per_token=dt * 1e3 / (n - 1),
                         prefill_target_s=t_pt, prefill_draft_s=t_pd,
                         counters=[int(x) for x in counters],
                         tokens=n - 1, readbacks=readbacks)
    print(f"{tag}forced triforce a=0.9: prefill_target {t_pt:.2f} s, "
          f"prefill_draft {t_pd:.2f} s, {dt * 1e3 / (n - 1):.3f} ms/token, "
          f"counters [steps, accepted, proposed, resampled, bonus, "
          f"mid_draft, mid_accept, mid_verify, mid_live] = "
          f"{[int(x) for x in counters]}", flush=True)
    res["graphs"]["forced"] = mode_graphs(
        tag + "forced", d, dt * 1e3 / (n - 1), toks,
        graph_gate(tag + "forced", fd, rk,
                   spec_gate_run(eng, ids, "triforce", 2, 0.9),
                   spec_gate_run(witness, ids, "triforce", 2, 0.9)))
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    eng.release_graphs()
    return res


def _grow_map(planner):
    """The tree the JAX bench plans: modeled acceptance 0.8 over 4
    branches, 128 nodes, depth limit 12."""
    pvec = planner.modeled_acceptance_vector(0.8, 4)
    T, choice = planner.plan_tree(pvec, TREE_SIZE, TREE_DEPTH)
    return planner.build_grow_map(T, choice, TREE_SIZE, TREE_DEPTH)


def tree_gate(tc, llama, planner, spectree, dev, quant, layers=2,
              prefill=1024):
    """On the card, a ``layers``-layer full-width target and the 128-node
    tree: (1) the tree verify's logits along the deepest root-to-leaf chain
    equal the sequential forward of that chain (cosine > 0.999, top-1
    equal up to near ties); (2) after a step at forced acceptance
    ``kv.seq_len = seq0 + n_nodes`` and the compacted slots hold the
    verify's KV of the accepted nodes bit for bit (codes and scales alike
    with ``quant``)."""
    tag = "int8" if quant else "bf16"
    cfg = tc.LLAMA2_7B_128K.with_(num_layers=layers)
    gm = _grow_map(planner)
    eng = spectree.TreeEngine(
        cfg, gm, llama.init_params(cfg, device=dev, dtype=torch.bfloat16,
                                   seed=7),
        prefill=prefill, max_cache_len=prefill + 64, budget=256,
        chunk_size=8, dtype=torch.bfloat16, prefill_chunk=512, device=dev,
        kv_quant=quant, weight_quant=quant, eos_ids=())
    ids = torch.randint(0, cfg.vocab_size, (1, prefill),
                        generator=torch.Generator().manual_seed(4)).to(dev)
    state = eng.prefill_target(eng.init_state(11), ids)
    seq0 = int(state.kv.seq_len)
    parents = {int(c): i for i in range(gm.size) for c in gm.successors[i]
               if c >= 0}
    chain = [int(gm.depth.argmax())]
    while chain[-1] != 0:
        chain.append(parents[chain[-1]])
    chain.reverse()
    tokens = torch.full((gm.size,), 7, dtype=torch.int64, device=dev)
    tokens[chain] = 11 + torch.arange(len(chain), device=dev)
    positions = state.kv.seq_len.to(torch.int64) + eng._depth
    l_tree, _, _ = llama.forward_append(cfg, eng.params, tokens[None],
                                        state.kv.clone(),
                                        positions=positions,
                                        tree_mask=eng._mask)
    l_seq, _, _ = llama.forward_append(cfg, eng.params, tokens[chain][None],
                                       state.kv.clone())
    a, b = l_tree[0, chain].double(), l_seq[0].double()
    cos = torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(),
                                                dim=0).item()
    top1 = (a.argmax(-1) == b.argmax(-1)).double().mean().item()
    # random-weight logits are nearly flat: a top-1 may differ only where
    # the sequential run's two candidates lie within twice the row's
    # largest |tree - sequential| logit difference (a near tie)
    flips = 0
    for r in (a.argmax(-1) != b.argmax(-1)).nonzero().flatten().tolist():
        gap = (b[r].max() - b[r, a[r].argmax()]).item()
        if gap > 2 * (a[r] - b[r]).abs().max().item():
            _fail(f"tree gate [{tag}]: chain node {r}: the tree verify's "
                  f"top-1 differs from the sequential forward's by "
                  f"{gap:.3e}, not a near tie")
        flips += 1
    if not cos > 0.999:
        _fail(f"tree gate [{tag}]: the tree verify along the deepest chain "
              f"differs from its sequential forward (cosine {cos:.6f})")
    # one step at forced acceptance; the twin redoes its grow and verify
    twin = state.clone()
    new, stats = eng.step(state, force_accept=0.9)
    if int(new.kv.seq_len) != seq0 + stats.n_nodes:
        _fail(f"tree gate [{tag}]: kv.seq_len {int(new.kv.seq_len)} != "
              f"{seq0} + {stats.n_nodes}")
    vt, _ = spectree._grow(eng, twin)
    _, kv_v, _ = llama.forward_append(
        cfg, eng.params, vt[None], twin.kv,
        positions=twin.kv.seq_len.to(torch.int64) + eng._depth,
        tree_mask=eng._mask)
    path = [0]
    for tok in stats.tokens[:stats.n_nodes - 1].tolist():
        kids = [int(c) for c in gm.successors[path[-1]] if c >= 0]
        path.append(next(c for c in kids if int(vt[c]) == tok))
    slots = torch.tensor([seq0 + i for i in path], device=dev)
    planes = ("k", "v", "k_scale", "v_scale") if quant else ("k", "v")
    for plane in planes:
        got = getattr(new.kv, plane)[:, :, :, seq0:seq0 + stats.n_nodes]
        want = getattr(kv_v, plane).index_select(3, slots)
        if not torch.equal(got, want):
            _fail(f"tree gate [{tag}]: the compacted {plane} slots are not "
                  f"the verify's KV of the accepted nodes {path}")
    print(f"tree gate [{tag}]: {layers}-layer full-width model, "
          f"{gm.size}-node tree: verify along the deepest chain "
          f"({len(chain)} nodes) vs sequential cosine {cos:.6f}, top-1 "
          f"{top1:.3f} ({flips} near-tie flips); a forced step accepted "
          f"nodes {path}, kv.seq_len {seq0} -> {int(new.kv.seq_len)}, "
          f"compacted slots bit-equal to "
          f"the verify's", flush=True)
    return dict(chain_cosine=cos, chain_top1=top1, near_tie_flips=flips,
                path=path)


def tree_end_to_end(tc, planner, spectree, fd, rk, dev, params, prefill,
                    quant):
    """Sequoia tree speculation at full width on ``params`` (with
    ``quant`` already int8 codes and scales, over int8 KV; the grow then
    runs int8 activations): ``tree_decode``, then forced acceptance, then
    two steps with 4 hybrid (``ssl``) layers."""
    tag = "int8 " if quant else ""
    cfg = tc.LLAMA2_7B_128K
    L = cfg.num_layers
    gm = _grow_map(planner)
    eng = spectree.TreeEngine(
        cfg, gm, params, prefill=prefill,
        max_cache_len=prefill + TREE_GEN + TREE_FORCED_GEN + 4 * gm.size,
        budget=4096, chunk_size=8, temperature=0.6, top_p=0.9,
        dtype=torch.bfloat16, prefill_chunk=512, device=dev, kv_quant=quant,
        weight_quant=quant, eos_ids=())
    witness = _eager_twin(eng)
    fwd = gm.num_levels + 1          # grow forwards per step: root + levels
    print(f"{tag}tree: {gm.size} nodes, depth {int(gm.depth.max())}, "
          f"{gm.num_levels} levels, W {eng.W}, K {eng.K}, budget 4096, "
          f"prefill {prefill}", flush=True)
    ids = torch.randint(0, cfg.vocab_size, (1, prefill),
                        generator=torch.Generator().manual_seed(5)).to(dev)
    body = prefill - 1
    pre_fwd = body // eng.prefill_chunk + bool(body % eng.prefill_chunk) + 1
    res = {"launches": {}, "graphs": {},
           "tree": dict(size=gm.size, levels=gm.num_levels,
                        depth=int(gm.depth.max()), W=eng.W, K=eng.K)}
    torch.cuda.reset_peak_memory_stats()

    def counts(what, b1, b2, b4):
        res["launches"][what] = _check_counts(fd, rk, tag + what, quant, b1,
                                              b2, 0, b4)

    def check_tokens(what, toks):
        if not all(0 <= t < cfg.vocab_size for t in toks):
            _fail(f"{tag}{what}: token out of range")

    # --- tree_decode, the entry point a user calls
    _reset(fd, rk)
    snap = _snap(eng.graphs)
    r = spectree.tree_decode(eng, ids, max_len=TREE_GEN, seed=1, device=dev)
    d = _decode_since(eng.graphs, snap, r)
    check_tokens("tree_decode", r.tokens)
    if len(r.tokens) < TREE_GEN + 1:
        _fail(f"{tag}tree_decode: generated too few tokens")
    counts("tree_decode", L * (pre_fwd + r.steps), L, L * fwd * r.steps)
    if not r.steps:
        _fail(f"{tag}tree_decode: the partials kernel was never launched")
    if r.readbacks != 1:
        _fail(f"{tag}tree_decode: the generation read back {r.readbacks} "
              f"times, not once")
    prefill_s = r.prefill_s
    res["tree_decode"] = dict(
        prefill_s=prefill_s, steps=r.steps, readbacks=r.readbacks,
        prefill_captures=r.prefill_captures,
        prefill_capture_s=r.prefill_capture_s,
        tokens=len(r.tokens) - 1, ms_per_step=1e3 * r.wall_s / r.steps,
        tokens_per_step=r.avg_tokens_per_step,
        ms_per_token=1e3 / r.tokens_per_sec)
    print(f"{tag}tree_decode: prefill {prefill_s:.2f} s (+ "
          f"{r.prefill_captures} captures in {r.prefill_capture_s:.2f} s), "
          f"{r.steps} "
          f"steps, {1e3 * r.wall_s / r.steps:.1f} ms/step, "
          f"{r.avg_tokens_per_step:.2f} tokens/step, "
          f"{1e3 / r.tokens_per_sec:.3f} ms/token", flush=True)
    res["graphs"]["tree_decode"] = mode_graphs(
        tag + "tree_decode", d, 1e3 / r.tokens_per_sec, r.tokens,
        graph_gate(tag + "tree_decode", fd, rk, tree_gate_run(eng, ids, 1),
                   tree_gate_run(witness, ids, 1)))
    torch.cuda.empty_cache()

    # --- forced acceptance 0.9 (every forward still runs); its gate runs
    # first, so that no gate state lives beside the timed run's
    forced_gate = graph_gate(tag + "tree forced", fd, rk,
                             tree_gate_run(eng, ids, 2, 0.9),
                             tree_gate_run(witness, ids, 2, 0.9))
    state = eng.prefill_target(eng.init_state(2), ids)
    torch.cuda.synchronize()
    _reset(fd, rk)
    snap = _snap(eng.graphs)
    t0 = time.perf_counter()
    state, buf, n, counters, _ = eng.generate_forced(state, TREE_FORCED_GEN,
                                                     0.9)
    toks = buf[:n].tolist()
    d = _since(eng.graphs, snap)
    dt = time.perf_counter() - t0 - d["capture_s"]
    check_tokens("tree forced", toks)
    steps, nodes, readbacks = (int(x) for x in counters)
    if readbacks != 1:
        _fail(f"{tag}tree forced: the generation read back {readbacks} "
              f"times, not once")
    counts("tree forced", L * steps, 0, L * fwd * steps)
    if int(state.kv.seq_len) != prefill + nodes:
        _fail(f"{tag}tree forced: kv.seq_len {int(state.kv.seq_len)} != "
              f"{prefill} + {nodes}")
    res["forced"] = dict(
        alpha=0.9, steps=steps, tokens=n - 1, nodes_accepted=nodes,
        ms_per_step=1e3 * dt / steps, tokens_per_step=(n - 1) / steps,
        ms_per_token=1e3 * dt / (n - 1), readbacks_per_step=readbacks / steps)
    print(f"{tag}tree forced a=0.9: {steps} steps, {1e3 * dt / steps:.1f} "
          f"ms/step, {(n - 1) / steps:.2f} tokens/step, "
          f"{1e3 * dt / (n - 1):.3f} ms/token, {nodes} nodes accepted, "
          f"{readbacks / steps:.3f} host read-backs/step", flush=True)
    res["graphs"]["tree forced"] = mode_graphs(
        tag + "tree forced", d, 1e3 * dt / (n - 1), toks, forced_gate)

    # --- two more steps with the first 4 layers on the full cache (ssl)
    eng.ssl = 4
    _reset(fd, rk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = int(state.kv.seq_len)
    nodes = 0
    for _ in range(2):
        state, stats = eng.step(state, force_accept=0.9)
        nodes += stats.n_nodes
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts("tree ssl=4", L * 2, 0, L * fwd * 2)
    if int(state.kv.seq_len) != seq + nodes:
        _fail(f"{tag}tree ssl=4: kv.seq_len {int(state.kv.seq_len)} != "
              f"{seq} + {nodes}")
    res["ssl4"] = dict(steps=2, ms_per_step=1e3 * dt / 2,
                       nodes_accepted=nodes)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    eng.release_graphs()
    print(f"{tag}tree ssl=4 a=0.9: 2 steps, {1e3 * dt / 2:.1f} ms/step, "
          f"{nodes} nodes accepted; peak {res['peak_gib']:.1f} GiB",
          flush=True)
    return res


def _ulps4(ref, got):
    """|got - ref| at its largest, in units of 4 bf16 ulps of ref's largest
    logit: a GEMM of another height rounds a logit by about one ulp, a row
    that reads another row's cache slots moves it by O(1)."""
    top = ref.abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top else 1.0
    return (got - ref).abs().max().item() / (4 * ulp)


def rows_equal_batch1(tc, llama, Engine, bs, dev, quant, layers=2,
                      prefill=1024, steps=3):
    """On the card, a batched row emits what its batch-1 run with the same
    seed emits: a ``layers``-layer full-width target + Llama-68M, 2 rows,
    ``steps`` TriForce steps. Each row's attention is bit-identical in the
    two runs (B3 splits a row as B1 does), but the matmuls see 2 rows
    instead of 1, and on the card the library's GEMM then sums some outputs
    in another order: logits about one bf16 ulp apart, enough to move a
    token sampled at a near tie. So the batched run is held to its batch-1
    runs forward by forward. Every forward of a row (drafter, middle and
    target) whose input tokens are those of the batch-1 run's next forward
    of its kind must give logits within 4 bf16 ulps of that forward's
    (``_ulps4``), and then hands the row the batch-1 run's logits, so that
    the sampling sees the same numbers in both runs. Every row must then
    emit its batch-1 run's tokens at every step, and every forward of a
    batch-1 run must have met its counterpart: a wrong generator, a wrong
    top-p or a swapped row changes the tokens, a wrong cache the logits."""
    tag = "int8" if quant else "bf16"
    tcfg, dcfg = tc.LLAMA2_7B_128K.with_(num_layers=layers), tc.LLAMA_68M
    spec = tc.SpecConfig(gamma=GAMMA, budget=256, chunk_size=8)
    # eager: the gate wraps the forwards in Python that reads values back
    eng = Engine(tcfg, spec,
                 llama.init_params(tcfg, device=dev, dtype=torch.bfloat16,
                                   seed=7),
                 draft_cfg=dcfg,
                 draft_params=llama.init_params(dcfg, device=dev,
                                                dtype=torch.bfloat16, seed=8),
                 prefill=prefill, max_cache_len=prefill + 64,
                 dtype=torch.bfloat16, device=dev, kv_quant=quant,
                 weight_quant=quant, graphs=False)
    gen = torch.Generator().manual_seed(9)
    prompts = [torch.randint(0, tcfg.vocab_size, (1, prefill),
                             generator=gen).to(dev) for _ in range(2)]
    seeds = [31, 32]
    kinds = ("draft_forward_spec", "forward_spec", "forward_append")
    orig = {n: getattr(llama, n) for k in kinds for n in (k, k + "_rows")}
    # per batch-1 run, per step, per kind: its forwards' (input ids,
    # logits); the batched run's place in them and its drift per kind
    want_fw = []
    at = [{} for _ in prompts]
    drift = [dict.fromkeys(kinds, 0.0) for _ in prompts]
    step_i = [0]

    def logits_of(out):
        return out[0] if isinstance(out, tuple) else out

    def record(kind):
        def fn(*a, **k):
            out = orig[kind](*a, **k)
            want_fw[-1][step_i[0]][kind].append(
                (a[2][0].clone(), logits_of(out)[0].clone()))
            return out
        return fn

    def substitute(kind):
        def fn(*a, **k):
            out = orig[kind + "_rows"](*a, **k)
            lg = logits_of(out).clone()
            for r in range(lg.shape[0]):
                fws = want_fw[r][step_i[0]][kind]
                j = at[r].get((step_i[0], kind), 0)
                if j < len(fws) and torch.equal(a[2][r], fws[j][0]) \
                        and lg[r].shape == fws[j][1].shape:
                    drift[r][kind] = max(drift[r][kind],
                                         _ulps4(fws[j][1], lg[r]))
                    lg[r] = fws[j][1]
                    at[r][(step_i[0], kind)] = j + 1
            return (lg,) + tuple(out[1:]) if isinstance(out, tuple) else lg
        return fn

    def run_steps(step, wrap, names):
        for n in names:
            setattr(llama, n, wrap(n.removesuffix("_rows")))
        try:
            out = []
            for i in range(steps):
                step_i[0] = i
                out.append(step())
        finally:
            for n in names:
                setattr(llama, n, orig[n])
        return out

    want = []
    for ids, seed in zip(prompts, seeds):
        box = [eng.prefill_draft(
            eng.prefill_target(eng.init_state(seed), ids), ids)]
        want_fw.append([{k: [] for k in kinds} for _ in range(steps)])

        def step1():
            box[0], stats = eng._step_fn("triforce", None)(box[0])
            return stats.tokens.tolist(), stats.n_emitted
        want.append(run_steps(step1, record, kinds))
    bat = bs.BatchedSpecEngine(eng, mode="triforce")
    box = [bat.prefill_rows(prompts, seeds)]

    def step2():
        box[0], stats = bat.step(box[0])
        return [(stats.tokens[r].tolist(), int(stats.n_emitted[r]))
                for r in range(2)]
    got = run_steps(step2, substitute, [k + "_rows" for k in kinds])
    for r in range(2):
        for i in range(steps):
            if got[i][r] != want[r][i]:
                _fail(f"rows [{tag}]: row {r} step {i} emitted {got[i][r]}, "
                      f"its batch-1 run {want[r][i]}, on the same logits")
            for kind in kinds:
                n1 = len(want_fw[r][i][kind])
                n2 = at[r].get((i, kind), 0)
                if n2 != n1:
                    _fail(f"rows [{tag}]: row {r} step {i}: {n2} of its "
                          f"batch-1 run's {n1} {kind} forwards met one of "
                          f"the batched run on the same input tokens")
        worst = max(drift[r].values())
        if not worst <= 1.0:
            _fail(f"rows [{tag}]: row {r}'s logits moved {worst:.2f} x 4 "
                  f"bf16 ulps from its batch-1 run's on the same input "
                  f"tokens ({drift[r]})")
    emitted = [[n for _, n in rec] for rec in want]
    forwards = [sum(len(v) for st in fw for v in st.values())
                for fw in want_fw]
    print(f"rows [{tag}]: {layers}-layer full-width model, 2 rows x {steps} "
          f"TriForce steps: every batched row emitted its batch-1 run's "
          f"tokens on its batch-1 run's logits (n_emitted per step "
          f"{emitted}); {forwards} forwards per row met, their logits' "
          f"largest difference on equal inputs in units of 4 bf16 ulps "
          f"{drift}", flush=True)
    return dict(steps=steps, n_emitted=emitted, forwards=forwards,
                logit_drift_of_4_ulps=drift)


def _record_admissions(sched, row_view):
    """Wrap ``sched._admit_one``: as a request's admission completes, the
    digest of its slot's row (``_prefill_tensors``: kv to its length,
    retrieval cache, drafter window, lengths, first token; the AR pool's
    kv and token) lands in ``sched.admitted`` by request id. The digests'
    seconds are kept in ``sched.digest_s`` (the admission clock holds
    them); ``sched.replays0`` is the graph set's replays before the run."""
    sched.admitted, sched.digest_s = {}, 0.0
    sched.replays0 = dict(sched.graphs.replays_by)
    admit = sched._admit_one

    def admit_one(slot, req):
        done = admit(slot, req)
        if done:
            t0 = time.perf_counter()
            st = sched.state
            rows = [row_view(c, slot) if c is not None else None
                    for c in (st.kv, getattr(st, "rkv", None),
                              getattr(st, "dkv", None))]
            tok = getattr(st, "next_token", getattr(st, "tokens", None))
            sched.admitted[req.rid] = _digest(_prefill_tensors(
                *rows, tok[slot]))
            sched.digest_s += time.perf_counter() - t0
        return done
    sched._admit_one = admit_one
    return sched


def _record_segments(sched):
    """Wrap ``sched._decode_segment``: each segment's wall ms (device
    synchronised at both ends, capture seconds left out), its captures
    and, on a graphed scheduler, the device's busy ms over its graph
    replays (``_busy``) land in ``sched.segments``."""
    sched.segments = []
    decode = sched._decode_segment

    def segment():
        c0 = sched.graphs.captures
        if sched.graphs.enabled:
            out, b = _busy(decode, sched.graphs)
        else:
            (out, s) = _timed(decode)
            b = dict(busy_ms=None, wall_ms=1e3 * s)
        sched.segments.append(dict(b, captures=sched.graphs.captures - c0))
        return out
    sched._decode_segment = segment
    return sched


def _segments_line(sched):
    """(text, numbers): the first segment's wall against the others', the
    device's busy share over all of them, the read-backs a segment."""
    segs = sched.segments
    rest = [x["wall_ms"] for x in segs[1:]]
    out = dict(segments=len(segs), first_segment_ms=segs[0]["wall_ms"],
               rest_segment_ms=sum(rest) / max(len(rest), 1),
               readbacks=sched.stats["readbacks"])
    text = (f"{len(segs)} segments, {sched.stats['readbacks']} read-backs; "
            f"first segment {out['first_segment_ms']:.1f} ms, the other "
            f"{len(rest)} {out['rest_segment_ms']:.1f} ms each")
    if segs[0]["busy_ms"] is not None:
        busy = sum(x["busy_ms"] for x in segs)
        wall = sum(x["wall_ms"] for x in segs)
        out.update(busy_ms=busy, wall_ms=wall, share=busy / wall)
        text += (f"; device busy {busy:.1f} of {wall:.1f} ms "
                 f"({100 * busy / wall:.1f}%) over the segments' graph "
                 f"replays")
    return text, out


def serve_gate(what, fd, rk, run_graphed, run_eager):
    """A serving graph gate: ``run_*()`` serve the same requests through a
    graphed and an eager scheduler (their admissions recorded by
    ``_record_admissions``, their segments by ``_record_segments``) and
    return (scheduler, finished requests); every request's tokens, the
    steps, the target forwards, the launch counts, the pool's generator
    states and every admitted row's digest must be equal (the admission's
    prefill gate: line "prefill graphs [... admission]"), and the graphed
    scheduler must read back once a segment. Returns the
    graphed (scheduler, requests), its launch counts and the gate's
    numbers; the scheduler's pool is dropped before the witness runs
    (``drained``: its slots' lengths at the end), so that the two pools
    never live at once."""
    out = {}
    for tag, fn in (("graphed", run_graphed), ("eager", run_eager)):
        _reset(fd, rk)
        sched, done = fn()
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in _wrappers(fd, rk).items()}
        st = sched.stats
        st["admit_s"] -= sched.digest_s
        sched.admit_replays = {
            k: n - sched.replays0.get(k, 0)
            for k, n in sched.graphs.replays_by.items()
            if n != sched.replays0.get(k, 0) and k.split()[0] in (
                "prefill", "build", "draft_prefill")}
        out[tag] = (sched, done, launches,
                    dict(tokens=sorted((r.rid, r.out) for r in done),
                         steps=st["steps"],
                         target_forwards=st["target_forwards"],
                         launches=launches, admitted=sched.admitted,
                         gens=[g.get_state().tolist() for g in getattr(
                             sched.state, "gens", [getattr(sched.state,
                                                           "gen", None)])]))
        sched.drained = sched.state.kv.seq_len.tolist()
        sched.state = sched._row = sched._rows = None   # the pool, the row
        sched.graphs.release()
        del sched
        torch.cuda.empty_cache()
    g, e = out["graphed"][3], out["eager"][3]
    for key in g:
        if g[key] != e[key]:
            _fail(f"graph gate [{what}]: the graphed run's {key} differ "
                  f"from the eager witness's"
                  + ("" if key == "admitted" else f" ({g[key]} != {e[key]})"))
    gs, es = out["graphed"][0], out["eager"][0]
    if gs.stats["readbacks"] != len(gs.segments):
        _fail(f"graph gate [{what}]: {gs.stats['readbacks']} read-backs "
              f"over {len(gs.segments)} decode segments, not one each")
    seg_text, seg = _segments_line(gs)
    print(f"graphs [{what} segments]: graphed {seg_text}; eager witness "
          f"{_segments_line(es)[0]}", flush=True)
    if len(g["admitted"]) != len(g["tokens"]) \
            or not gs.stats["admit_captures"] or es.stats["admit_captures"]:
        _fail(f"graph gate [{what}]: {len(g['admitted'])} admissions "
              f"recorded, {gs.stats['admit_captures']} graphed captures, "
              f"{es.stats['admit_captures']} eager")
    st = gs.stats
    dense = _dense_bytes(gs.engine) if hasattr(gs, "engine") else 0
    print(f"prefill graphs [{what} admission]: graphed admit "
          f"{st['admit_s']:.3f} s (+ {st['admit_captures']} captures in "
          f"{st['admit_capture_s']:.3f} s), eager witness "
          f"{es.stats['admit_s']:.3f} s; {len(g['admitted'])} admitted "
          f"rows (each cache of the slot, kv to its length; lengths, first "
          f"token) bit-equal (word digests), launches equal; replays "
          f"{json.dumps(gs.admit_replays)}; converted int8 weights "
          f"{dense / 2**30:.2f} GiB", flush=True)
    est = es.stats
    decoded = sum(len(r.out) - 1 for r in out["eager"][1])
    gate = dict(eager_tokens_per_s=decoded / est["decode_s"],
                eager_decode_s=est["decode_s"],
                eager_admit_s=est["admit_s"],
                admit_replays=gs.admit_replays,
                requests=len(out["eager"][1]), segments=seg,
                eager_readbacks=est["readbacks"])
    return out["graphed"][0], out["graphed"][1], out["graphed"][2], gate


def batched_end_to_end(tc, llama, Engine, bs, batching, fd, rk, dev, tp, dp,
                       quant):
    """Batched speculation and serving at full width, ROWS slots, prompts
    of SERVE_PREFILL tokens, each graphed and gated against an eager
    witness. ``tp``/``dp`` are the weights as the batch-1 engine runs them:
    with ``quant`` already int8 codes and scales, over int8 KV. No token id
    is an EOS here (random weights would emit one now and then), so every
    request runs to its length."""
    tag = "int8 " if quant else ""
    tcfg, dcfg = tc.LLAMA2_7B_128K, tc.LLAMA_68M
    spec = tc.SpecConfig(gamma=GAMMA, budget=4096, chunk_size=8)
    L, P = tcfg.num_layers, SERVE_PREFILL
    headroom = bs.SpecScheduler.required_headroom(SERVE_NEW, SERVE_SEGMENT,
                                                  GAMMA)
    eng = Engine(tcfg, spec, tp, draft_cfg=dcfg, draft_params=dp, prefill=P,
                 max_cache_len=P + headroom, dtype=torch.bfloat16, device=dev,
                 kv_quant=quant, eos_token_id=-1)
    witness = _eager_twin(eng)
    body = P - 1
    pre_fwd = body // eng.prefill_chunk + bool(body % eng.prefill_chunk) + 1
    gen = torch.Generator().manual_seed(6)
    prompts = [torch.randint(0, tcfg.vocab_size, (1, P), generator=gen)
               for _ in range(SERVE_REQUESTS)]
    rows_in = [p.to(dev) for p in prompts[:ROWS]]
    res = {"launches": {}, "graphs": {}}
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

    def serve_line(what, sched, done, gate):
        st = sched.stats
        decoded = sum(len(r.out) - 1 for r in done)   # all but the prefill's
        out = dict(admit_s=st["admit_s"], decode_s=st["decode_s"],
                   steps=st["steps"], target_forwards=st["target_forwards"],
                   decode_tokens=decoded,
                   tokens_per_s=decoded / st["decode_s"],
                   captures=st["captures"], capture_s=st["capture_s"],
                   admit_captures=st["admit_captures"],
                   admit_capture_s=st["admit_capture_s"], **gate)
        print(f"{tag}{what}: {SERVE_REQUESTS} requests x {SERVE_NEW} tokens "
              f"through {ROWS} slots: {out['tokens_per_s']:.1f} tokens/s "
              f"over decode segments (eager witness "
              f"{gate['eager_tokens_per_s']:.1f}; every request's tokens, "
              f"the steps and the launch counts equal), admit "
              f"{st['admit_s']:.2f} s (+ {st['admit_captures']} captures in "
              f"{st['admit_capture_s']:.2f} s; eager witness "
              f"{gate['eager_admit_s']:.2f} s), decode "
              f"{st['decode_s']:.2f} s, "
              f"{st['steps']} steps, {st['target_forwards']} batched target "
              f"forwards; {st['captures']} captures in "
              f"{st['capture_s']:.3f} s", flush=True)
        return out

    # --- (a) ROWS rows speculate together, TriForce at forced acceptance;
    # the gate runs first, so that no gate state lives beside the timed one
    rows_gate = graph_gate(
        tag + "batched triforce", fd, rk,
        rows_gate_run(bs, eng, "triforce", rows_in, list(range(ROWS)), 0.9),
        rows_gate_run(bs, witness, "triforce", rows_in, list(range(ROWS)),
                      0.9))
    bat = bs.BatchedSpecEngine(eng, mode="triforce", force_accept=0.9)
    _reset(fd, rk)
    t0 = time.perf_counter()
    state = bat.prefill_rows(rows_in, list(range(ROWS)))
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    counts_pre = _check_counts(fd, rk, tag + "batched prefill_rows", quant,
                               L * pre_fwd * ROWS, L * ROWS)
    res["launches"]["prefill_rows"] = counts_pre
    _reset(fd, rk)
    # two decode calls on the pool: the first captures its loop graph and
    # pays a fresh graph's first-call cost, the second replays it
    steps, calls = 8, []
    snap = _snap(eng.graphs)
    for _ in range(2):
        f0, r0, sn = bat.target_forwards, eng.graphs.readbacks, \
            _snap(eng.graphs)
        t0 = time.perf_counter()
        state, toks, ns, counters, _eos = bat.decode(state, steps)
        torch.cuda.synchronize()
        dk = _since(eng.graphs, sn)
        calls.append(dict(s=time.perf_counter() - t0 - dk["capture_s"],
                          toks=toks, ns=ns, counters=counters,
                          forwards=bat.target_forwards - f0,
                          readbacks=eng.graphs.readbacks - r0,
                          captures=dk["captures"]))
    d = _since(eng.graphs, snap)
    counts("batched triforce", 0, 0, L * bat.target_forwards)
    for c in calls:
        toks, ns = c["toks"], c["ns"]
        if toks.shape != (ROWS, steps, GAMMA + 2) or not (ns >= 1).all():
            _fail(f"{tag}batched triforce: wrong outputs")
        for r in range(ROWS):
            for i in range(steps):
                if not all(0 <= t < tcfg.vocab_size
                           for t in toks[r, i, :ns[r, i]]):
                    _fail(f"{tag}batched triforce: token out of range")
        if c["readbacks"] != 1:
            _fail(f"{tag}batched triforce: a decode call read back "
                  f"{c['readbacks']} times, not once")
    # every emitted token but the last of each row is committed
    want_len = P + sum(c["ns"].sum(1) for c in calls)
    if state.kv.seq_len.tolist() != want_len.tolist():
        _fail(f"{tag}batched triforce: kv.seq_len "
              f"{state.kv.seq_len.tolist()} != {want_len.tolist()}")
    first, steady = calls
    emitted, dt = int(steady["ns"].sum()), steady["s"]
    res["batched_triforce"] = dict(
        alpha=0.9, rows=ROWS, steps=steps, prefill_rows_s=t_prefill,
        decode_s=dt, tokens=emitted, tokens_per_s=emitted / dt,
        ms_per_step=1e3 * dt / steps,
        first_call_s=first["s"], first_call_tokens=int(first["ns"].sum()),
        first_call_tokens_per_s=int(first["ns"].sum()) / first["s"],
        readbacks_per_call=[c["readbacks"] for c in calls],
        accepted=int(steady["counters"][:, 0].sum()),
        proposed=int(steady["counters"][:, 1].sum()),
        target_forwards=bat.target_forwards)
    b = res["batched_triforce"]
    print(f"{tag}batched triforce a=0.9: {ROWS} rows, prefill_rows "
          f"{t_prefill:.2f} s; two decode calls of {steps} steps, one "
          f"read-back each: the first (it captures the loop graph; capture "
          f"seconds left out) {first['s']:.3f} s = "
          f"{b['first_call_tokens_per_s']:.1f} tokens/s, the second "
          f"{dt:.3f} s = {emitted / dt:.1f} tokens/s, "
          f"{b['ms_per_step']:.2f} ms/step ({emitted} tokens, accepted "
          f"{b['accepted']} of {b['proposed']}); "
          f"{bat.target_forwards} batched target forwards", flush=True)
    res["graphs"]["batched triforce"] = mode_graphs(
        tag + "batched triforce", d, 1e3 * dt / emitted, None, rows_gate)
    if first["toks"][:, :GATE_STEPS].tolist() != rows_gate["tokens"]:
        _fail(f"{tag}batched triforce: the timed run's first steps differ "
              f"from the eager witness's")
    del state

    # --- (b) speculative serving: chunked admission between segments
    def spec_serving(e, b):
        def run():
            sched = _record_segments(_record_admissions(bs.SpecScheduler(
                e, mode="triforce", slots=ROWS, segment=SERVE_SEGMENT,
                bat=b, admit_chunks=4), bs.row_view))
            for i, p in enumerate(prompts):
                sched.submit(batching.Request(rid=i, prompt=p[0].numpy(),
                                              max_new_tokens=SERVE_NEW))
            return sched, sched.run(max_wall_s=600)
        return run

    before = bat.target_forwards
    sched, done, got, gate = serve_gate(
        tag + "spec serving", fd, rk, spec_serving(eng, bat),
        spec_serving(witness, bs.BatchedSpecEngine(witness, mode="triforce",
                                                   force_accept=0.9)))
    check_requests("spec serving", done)
    _reset(fd, rk)
    for k, fn in _wrappers(fd, rk).items():
        fn.launches = got[k]
    counts("spec serving", L * pre_fwd * SERVE_REQUESTS, L * SERVE_REQUESTS,
           L * (bat.target_forwards - before))
    if sched.drained != [0] * ROWS:
        _fail(f"{tag}spec serving: a drained slot is not gated")
    if sched.stats["captures"] != 1 \
            or [x["captures"] for x in sched.segments][1:] != \
            [0] * (len(sched.segments) - 1):
        _fail(f"{tag}spec serving: {sched.stats['captures']} captures "
              f"(by segment {[x['captures'] for x in sched.segments]}), "
              f"not one loop graph for the pool at its first segment")
    res["spec_serving"] = serve_line("spec serving (triforce a=0.9)", sched,
                                     done, gate)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del sched, bat
    eng.release_graphs()
    torch.cuda.empty_cache()

    # --- (c) AR serving over a bf16 pool (the AR scheduler's pool is never
    # int8; with ``quant`` it runs the int8 weights over bf16 KV)
    chunk = 512

    def ar_serving(graphs):
        def run():
            ar = _record_segments(_record_admissions(batching.Scheduler(
                tcfg, spec, eng.t_params, batch=ROWS,
                max_len=P + SERVE_NEW + 16, prefill_chunk=chunk,
                dtype=torch.bfloat16, segment=16, device=dev,
                eos_token_id=-1, graphs=graphs), bs.row_view))
            for i, p in enumerate(prompts):
                ar.submit(batching.Request(rid=i, prompt=p[0].numpy(),
                                           max_new_tokens=SERVE_NEW))
            return ar, ar.run(max_wall_s=600)
        return run

    ar, done, got, gate = serve_gate(tag + "AR serving", fd, rk,
                                     ar_serving(None), ar_serving(False))
    check_requests("AR serving", done)
    for k, fn in _wrappers(fd, rk).items():
        fn.launches = got[k]
    res["launches"]["ar_serving"] = _check_counts(
        fd, rk, tag + "AR serving (bf16 KV)", False,
        L * -(-P // chunk) * SERVE_REQUESTS, 0, L * ar.stats["steps"])
    if ar.stats["captures"] != 1:
        _fail(f"{tag}AR serving: {ar.stats['captures']} captures, not one")
    res["ar_serving"] = serve_line("AR serving", ar, done, gate)
    return res


# ---------------------------------------------------------------------------
# GQA phase: TinyLlama-1.1B-128K widths (4 KV heads x 64, G = 8), first the
# kernels at the shapes its run gives them, then the command line end to end
# ---------------------------------------------------------------------------

GQA_MODEL, CLI_DRAFT = "tinyllama-1.1b-128k", "llama-68m"
# until PR 15 CLI_PREFILL 32768, CLI_GEN 64, CLI_TREE_GEN and CLI_SERVE_GEN
# 32 (cut for the time limit when the rest of the mesh came)
CLI_PREFILL, CLI_GEN, CLI_TREE_GEN, CLI_BUDGET = 16384, 32, 16, 4096
CLI_TREE_SIZE, CLI_TREE_DEPTH = 128, 8      # --tree_size 128, the default depth
CLI_SERVE_PREFILL, CLI_SERVE_GEN, CLI_SERVE_ROWS, CLI_SERVE_PROMPTS = \
    8192, 16, 4, 6
CLI_SUBPROCESS_GEN = 16


def _cli_grow_map(planner, depth=CLI_TREE_DEPTH):
    """The tree the CLI plans for ``--tree_size 128`` (modeled acceptance
    0.8 over 4 branches, ``--tree_depth``, 8 by default)."""
    pvec = planner.modeled_acceptance_vector(0.8, 4)
    T, choice = planner.plan_tree(pvec, CLI_TREE_SIZE, depth)
    return planner.build_grow_map(T, choice, CLI_TREE_SIZE, depth)


def gqa_kernel_gates(tc, fd, att, rk, rt, cache_mod, planner, spectree,
                     batched_spec, dev):
    """Every kernel, bf16 and int8, at the shapes the TinyLlama run gives
    it (Hkv 4, D 64, G 8 query rows per KV head), against its plain
    version with the kernel phase's tolerances, timed beside its bound and
    the library yardstick: B1 at the target verify (GT 64, Tn 8 over the
    32K prefix), the middle verify (GT 56, Tn 7 over 4096) and the tree
    verify (GT 1024, Tn 128 under the CLI tree's ancestor mask); B2 at the
    build (32768, chunk 8, 8 query rows a head); B3 at 4 served rows of
    the target verify; B4 at a grow level of the CLI's tree (depth 8: W 36,
    GT 288), of the kernel phase's tree (W 22, GT 176) and at the root."""
    cfg = tc.PRESETS[GQA_MODEL]
    hkv, d = cfg.num_kv_heads, cfg.head_dim
    g = cfg.num_heads // hkv
    P = CLI_PREFILL
    s_kv = P + 2 * (CLI_GEN + GAMMA + 2)
    gm = _cli_grow_map(planner)
    w_cli = spectree._padded_levels(gm)[0]
    w_deep = spectree._padded_levels(_grow_map(planner))[0]
    s_tree = P + CLI_TREE_GEN + 3 * gm.size + w_cli
    s_rkv = 4096 + gm.size + max(w_cli, w_deep)
    s_pool = CLI_SERVE_PREFILL + batched_spec.SpecScheduler.required_headroom(
        CLI_SERVE_GEN, 4, GAMMA)
    tree_mask = np.tile(gm.mask, (g, 1))        # each group's rows, in turn
    kw = dict(hkv=hkv, d=d)
    out = {}
    for quant in (False, True):
        out[quant] = dict(
            b1=[kernel_b1(fd, cache_mod, dev, g * (GAMMA + 2), GAMMA + 2, P,
                          s_kv, quant, **kw),
                kernel_b1(fd, cache_mod, dev, g * (GAMMA + 1), GAMMA + 1,
                          4096, 4096 + GAMMA + 1, quant, **kw),
                kernel_b1(fd, cache_mod, dev, g * gm.size, gm.size, P,
                          s_tree, quant, tree_mask=tree_mask, **kw)],
            b2=kernel_b2(rk, rt, cache_mod, dev, P, 8, 4096, s_kv, quant,
                         g=g, **kw),
            b3=kernel_b3(fd, cache_mod, dev, g * (GAMMA + 2), GAMMA + 2,
                         CLI_SERVE_PREFILL, s_pool, quant, **kw),
            b4=[kernel_b4(fd, att, cache_mod, dev, g * w, 4096, s_rkv, quant,
                          tn=w, **kw) for w in (w_cli, w_deep, 1)])
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _constructed(classes, store):
    """Inside the block every instance of ``classes`` lands in ``store``
    with its constructor's seconds: the command line builds its engines
    itself, and the launch counts need their plans. The hook sits on the
    classes, so it sees an instance wherever the class is imported from."""
    saved = {cls: cls.__dict__.get("__init__") for cls in classes}

    def hook(cls, init):
        def __init__(self, *args, **kwargs):
            t0 = time.perf_counter()
            init(self, *args, **kwargs)
            if type(self) is cls:       # once, where it was built
                torch.cuda.synchronize()
                store.append((self, time.perf_counter() - t0))
        return __init__

    for cls in classes:
        cls.__init__ = hook(cls, cls.__init__)
    try:
        yield store
    finally:
        for cls, init in saved.items():
            if init is None:
                del cls.__init__
            else:
                cls.__init__ = init


def _built(store, cls, tag):
    """The one instance of ``cls`` the command line built."""
    got = [o for o, _ in store if type(o) is cls]
    if len(got) != 1:
        _fail(f"cli {tag}: the command line built {len(got)} "
              f"{cls.__name__}, not one")
    return got[0]


def _params_equal(a, b) -> bool:
    """The same leaves, dtypes and values, bit for bit."""
    def leaves(p):
        out = {k: v for k, v in p.items() if k != "layers"}
        out.update({"layers." + k: v for k, v in p["layers"].items()})
        return out
    la, lb = leaves(a), leaves(b)
    return la.keys() == lb.keys() and all(
        la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]) for k in la)


def _pre_fwd(prefill, chunk):
    """Target forwards of one prefill: full chunks, the remainder, the
    last token's."""
    body = prefill - 1
    return body // chunk + bool(body % chunk) + 1


def _device_ops(prof, n=10):
    """The ``n`` device operations (kernels, copies) with the most device
    time in a profile: (name, calls, total ms)."""
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    def dev_us(e):
        return getattr(e, "device_time_total", None) \
            or getattr(e, "cuda_time_total", 0)
    evs.sort(key=dev_us, reverse=True)
    return [(e.key, e.count, dev_us(e) / 1e3) for e in evs[:n]]


def cli_serve_gate(tag, fd, rk, bs, data, eng, sched, done, vocab,
                   launches):
    """The graph gate of ``cli.main --mode serve``: the same requests
    through a ``SpecScheduler`` on the eager witness of the command
    line's engine; every request's tokens, the steps, the target forwards
    and the launch counts (``launches``, the command line's) must be
    equal, and the command line's run must have captured one loop graph
    for its pool and read back once a segment. Leaves the counters at
    ``launches``."""
    wit = _eager_twin(eng)
    prompts = data.synthetic_prompts(CLI_SERVE_PROMPTS, CLI_SERVE_PREFILL,
                                     vocab, 0)
    w = bs.SpecScheduler(wit, mode=sched.mode, slots=sched.slots,
                         segment=sched.segment, seed=0,
                         admit_chunks=sched.admit_chunks)
    for i, p in enumerate(prompts):
        w.submit(bs.batching.Request(
            rid=i, prompt=data.fit_prompt(p, CLI_SERVE_PREFILL).reshape(-1),
            max_new_tokens=CLI_SERVE_GEN))
    _reset(fd, rk)
    wdone = w.run()
    torch.cuda.synchronize()
    got = {k: f.launches for k, f in _wrappers(fd, rk).items()}
    g = (sorted((r.rid, r.out) for r in done), sched.stats["steps"],
         sched.stats["target_forwards"], launches)
    e = (sorted((r.rid, r.out) for r in wdone), w.stats["steps"],
         w.stats["target_forwards"], got)
    for name, a, b in zip(("tokens", "steps", "target forwards",
                           "launches"), g, e):
        if a != b:
            _fail(f"graph gate [cli {tag}]: the graphed run's {name} differ "
                  f"from the eager witness's ({a} != {b})")
    segments = sched.stats["steps"] // sched.segment
    if sched.stats["captures"] != 1:
        _fail(f"cli {tag}: {sched.stats['captures']} captures, not one loop "
              f"graph for the pool")
    if sched.stats["readbacks"] != segments:
        _fail(f"cli {tag}: {sched.stats['readbacks']} read-backs over "
              f"{segments} decode segments, not one each")
    for k, f in _wrappers(fd, rk).items():
        f.launches = launches[k]
    st = sched.stats
    dec = sum(len(r.out) - 1 for r in done)
    out = dict(tokens_per_s_graphed=dec / st["decode_s"],
               tokens_per_s_eager=dec / w.stats["decode_s"],
               captures=st["captures"], capture_s=st["capture_s"],
               pool_bytes=eng.graphs.pool_bytes, segments=segments,
               readbacks=st["readbacks"], eager_readbacks=w.stats["readbacks"])
    print(f"graphs [cli {tag}]: graphed {out['tokens_per_s_graphed']:.1f} "
          f"tokens/s over decode segments, eager witness "
          f"{out['tokens_per_s_eager']:.1f}; gate: every request's tokens, "
          f"the steps and the launch counts equal; {st['captures']} "
          f"capture in {st['capture_s']:.3f} s, pool "
          f"{out['pool_bytes'] / 2**20:.1f} MiB; device loop: "
          f"{st['readbacks']} read-backs over {segments} segments (the eager "
          f"witness {w.stats['readbacks']})", flush=True)
    eng.release_graphs()
    return out


def build_trace(profiling, rk, eng, state, tmp):
    """One retrieval build of ``eng`` (the 1-token forward that scores and
    gathers every layer, ``Engine._build``) replayed from its graph, and
    the same build on the eager witness: each timed on the host clock
    alone and then under the profiler: the device time of its kernels, the
    span from the first kernel's start to the last one's end, and B2's
    device time and launches, so B2's share of the build is read beside
    the build's wall. The cache slot the forward writes is put back."""
    scratch = state.rkv.clone()
    ids = torch.zeros((1, 1), dtype=torch.int64, device=eng.device)

    def b2_launches():
        return rk.chunk_scores.launches + rk.chunk_scores_int8.launches

    res = {}
    with profiling._slots_restored(state.kv, 1):
        for tag, e in (("graphed", eng), ("eager", _eager_twin(eng))):
            def build():
                e._build(state.kv, scratch, ids)
            build()                  # warm: the first call, then the capture
            build()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            build()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            n0 = b2_launches()
            t0 = time.perf_counter()
            with profiling.trace(os.path.join(tmp, "trace_build_" + tag)) \
                    as prof:
                build()
                torch.cuda.synchronize()
            wall_prof = (time.perf_counter() - t0) * 1e3
            n = b2_launches() - n0
            kern = [ev for ev in prof.events()
                    if str(ev.device_type).endswith("CUDA") and ev.name]
            if not kern:
                print(f"cli build trace [{tag}]: {wall:.3f} ms wall; device "
                      f"time not measured (none in the trace)", flush=True)
                res[tag] = dict(wall_ms=wall, b2_launches=n)
                continue
            busy = sum(ev.time_range.end - ev.time_range.start
                       for ev in kern) / 1e3
            b2 = sum(ev.time_range.end - ev.time_range.start for ev in kern
                     if "cs_kernel" in ev.name) / 1e3
            span = (max(ev.time_range.end for ev in kern)
                    - min(ev.time_range.start for ev in kern)) / 1e3
            res[tag] = dict(wall_ms=wall, wall_ms_profiled=wall_prof,
                            device_ms=busy, device_span_ms=span, b2_ms=b2,
                            b2_launches=n, device_ops=len(kern))
            print(f"cli build trace [{tag}]: one retrieval build {wall:.3f} "
                  f"ms wall ({wall_prof:.3f} under the profiler); "
                  f"{len(kern)} device operations, busy {busy:.3f} ms over a "
                  f"{span:.3f} ms span; B2 {b2:.4f} ms in {n} launches: "
                  f"{b2 / max(busy, 1e-9):.2%} of the device time, "
                  f"{b2 / wall:.2%} of the wall", flush=True)
    del scratch
    if res["graphed"]["b2_launches"] != res["eager"]["b2_launches"]:
        _fail("cli build trace: the replayed build launched B2 "
              f"{res['graphed']['b2_launches']} times, the eager one "
              f"{res['eager']['b2_launches']}")
    return res


def cli_phase(tc, llama, Engine, cli, hf, ckpt, data, decoding, profiling,
              planner, spectree, batched_spec, fd, rk, dev, tmp):
    """TinyLlama-1.1B-128K (full width and depth) + Llama-68M through the
    command line a user types, from checkpoints this phase writes: random
    weights from a seed, written in HF layout (the target as two indexed
    shards), loaded back bit-equal by the streaming loader and through the
    native checkpoint; then every mode of ``cli.main`` in bf16 and ``ar``,
    ``triforce``, ``tree`` with int8 weights and KV, each with its launch
    counts checked; the CLI's AR tokens against ``decoding.autoregressive``
    on the in-memory weights; ``python3 -m triforce_tpu_torch.cli`` as a
    process; the card's phase table (``measure_phase_times``) and a
    profiler trace of two TriForce steps."""
    cfg, dcfg = tc.PRESETS[GQA_MODEL], tc.PRESETS[CLI_DRAFT]
    L, P, bf = cfg.num_layers, CLI_PREFILL, torch.bfloat16
    res = {"runs": {}, "launches": {}}

    # --- 1. write the checkpoints (HF layout, nothing downloaded)
    t0 = time.perf_counter()
    tp = llama.init_params(cfg, device=dev, dtype=bf, seed=11)
    dp = llama.init_params(dcfg, device=dev, dtype=bf, seed=12)
    tdir, ddir, ndir = (os.path.join(tmp, n)
                        for n in ("target", "draft", "native"))
    hf.save_params(tdir, cfg, tp, shards=2)
    hf.save_params(ddir, dcfg, dp)
    with open(os.path.join(tdir, "config.json")) as f:
        rs = json.load(f)["rope_scaling"]
    if rs != {"type": cfg.rope.kind, "factor": cfg.rope.scaling_factor,
              "original_max_position_embeddings":
                  cfg.rope.original_max_position_embeddings}:
        _fail(f"cli: the written config's rope_scaling is {rs}")
    if not os.path.isfile(os.path.join(tdir,
                                       "model.safetensors.index.json")):
        _fail("cli: the target was not written as indexed shards")
    res["write_s"] = time.perf_counter() - t0

    # --- 2. the loaders give back what was written, bit for bit
    t0 = time.perf_counter()
    c2, p2 = hf.load_params_streaming(tdir, dtype=bf, device=dev)
    torch.cuda.synchronize()
    res["stream_load_s"] = time.perf_counter() - t0
    if c2 != cfg or not _params_equal(p2, tp):
        _fail("cli: the streamed target differs from what was written")
    del p2
    c3, p3 = hf.load_params_streaming(ddir, dtype=bf, rope_on_slots=True,
                                      device=dev)
    if c3 != dcfg or not c3.rope_on_slots or not _params_equal(p3, dp):
        _fail("cli: the streamed drafter differs from what was written")
    del p3
    t0 = time.perf_counter()
    c4, p4 = ckpt.convert_hf(tdir, ndir, dtype="bfloat16", device=dev)
    del p4
    res["convert_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c5, p5 = ckpt.load_checkpoint(ndir, dtype=bf, device=dev)
    torch.cuda.synchronize()
    res["native_load_s"] = time.perf_counter() - t0
    if c4 != cfg or c5 != cfg or not _params_equal(p5, tp):
        _fail("cli: the native checkpoint differs from what was written")
    del p5
    shutil.rmtree(ndir)
    torch.cuda.empty_cache()
    print(f"cli: {GQA_MODEL} ({cfg.num_layers} layers, hidden "
          f"{cfg.hidden_size}, {cfg.num_heads} heads over {cfg.num_kv_heads} "
          f"KV heads x {cfg.head_dim}) + {CLI_DRAFT} written in HF layout in "
          f"{res['write_s']:.1f} s; streamed back in "
          f"{res['stream_load_s']:.1f} s, converted in {res['convert_s']:.1f}"
          f" s, native load {res['native_load_s']:.1f} s: every leaf "
          f"bit-equal, configs equal the presets", flush=True)

    # --- 3-4. every mode through cli.main, launch counts checked
    base = ["--device", dev.type, "--model", tdir, "--draft", ddir,
            "--prefill", str(P),
            "--budget", str(CLI_BUDGET), "--chunk_size", "8", "--gamma",
            str(GAMMA),
            "--temp", "0.6", "--top_p", "0.9"]
    int8 = ["--kv_dtype", "int8", "--weight_dtype", "int8"]
    gen = ["--gen_len", str(CLI_GEN)]
    tree = ["--tree_size", str(CLI_TREE_SIZE), "--gen_len", str(CLI_TREE_GEN)]
    serve = ["--batch", str(CLI_SERVE_ROWS), "--num_prompts",
             str(CLI_SERVE_PROMPTS), "--prefill", str(CLI_SERVE_PREFILL),
             "--gen_len", str(CLI_SERVE_GEN)]
    runs = [("ar", "ar", gen), ("retrieval", "retrieval", gen),
            ("triforce", "triforce", gen), ("tree", "tree", tree),
            ("serve", "serve", serve), ("int8 ar", "ar", gen + int8),
            ("int8 retrieval", "retrieval", gen + int8),
            ("int8 triforce", "triforce", gen + int8),
            ("int8 tree", "tree", tree + int8),
            ("int8 serve", "serve", serve + int8)]
    outs = {}
    res["graphs"] = {}
    prompt0 = torch.from_numpy(data.fit_prompt(
        data.synthetic_prompts(1, P, cfg.vocab_size, 0)[0], P)).to(dev)
    for tag, mode, extra in runs:
        quant = tag.startswith("int8")
        built, load_s = [], [0.0]
        real_load = cli.load_model

        def timed_load(*args, **kwargs):
            t = time.perf_counter()
            out = real_load(*args, **kwargs)
            torch.cuda.synchronize()
            load_s[0] += time.perf_counter() - t
            return out

        cli.load_model = timed_load
        _reset(fd, rk)
        t0 = time.perf_counter()
        try:
            with _constructed((Engine, spectree.TreeEngine,
                               batched_spec.SpecScheduler), built):
                out = cli.main(base + ["--mode", mode, *extra])
        finally:
            cli.load_model = real_load
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        cli_launches = {k: fn.launches for k, fn in _wrappers(fd, rk).items()}
        setup_s = sum(t for _, t in built)
        if mode == "serve":
            sched = _built(built, batched_spec.SpecScheduler, tag)
            eng = _built(built, Engine, tag)
            n = CLI_SERVE_PROMPTS
            res["graphs"][tag] = cli_serve_gate(
                tag, fd, rk, batched_spec, data, eng, sched, out,
                cfg.vocab_size, cli_launches)
            if len(out) != n or not all(
                    r.done and 1 <= len(r.out) <= CLI_SERVE_GEN
                    and all(0 <= t < cfg.vocab_size for t in r.out)
                    for r in out):
                _fail(f"cli {tag}: the requests did not complete")
            got = _check_counts(
                fd, rk, f"cli {tag}", quant,
                L * _pre_fwd(CLI_SERVE_PREFILL, eng.prefill_chunk) * n,
                L * n, L * sched.bat.target_forwards)
            st = sched.stats
            decoded = sum(len(r.out) - 1 for r in out)
            row = dict(admit_s=st["admit_s"], decode_s=st["decode_s"],
                       admit_captures=st["admit_captures"],
                       admit_capture_s=st["admit_capture_s"],
                       steps=st["steps"], decode_tokens=decoded,
                       tokens_per_s=decoded / st["decode_s"],
                       target_forwards=st["target_forwards"])
            print(f"cli {tag}: {n} requests x <= {CLI_SERVE_GEN} tokens "
                  f"through {CLI_SERVE_ROWS} slots: "
                  f"{row['tokens_per_s']:.1f} tokens/s over decode segments, "
                  f"admit {st['admit_s']:.2f} s (+ {st['admit_captures']} "
                  f"captures in {st['admit_capture_s']:.2f} s), decode "
                  f"{st['decode_s']:.2f} s, {st['steps']} steps; load "
                  f"{load_s[0]:.2f} s, call {total:.1f} s", flush=True)
        else:
            r = out
            if not all(0 <= t < cfg.vocab_size for t in r.tokens):
                _fail(f"cli {tag}: token out of range")
            if mode == "tree":
                te = _built(built, spectree.TreeEngine, tag)
                fwd = te.gm.num_levels + 1
                res["graphs"][tag] = mode_graphs(
                    "cli " + tag, dict(captures=r.captures,
                                       capture_s=r.capture_s,
                                       pool_bytes=te.graphs.pool_bytes),
                    1e3 / r.tokens_per_sec, r.tokens,
                    graph_gate("cli " + tag, fd, rk,
                               tree_gate_run(te, prompt0, 0),
                               tree_gate_run(_eager_twin(te), prompt0, 0)))
                te.release_graphs()
                _reset(fd, rk)
                for k, fn in _wrappers(fd, rk).items():
                    fn.launches = cli_launches[k]
                if not r.steps or len(r.tokens) < 2:
                    _fail(f"cli {tag}: no tree step ran")
                got = _check_counts(
                    fd, rk, f"cli {tag}", quant,
                    L * (_pre_fwd(P, te.prefill_chunk) + r.steps), L, 0,
                    L * fwd * r.steps)
            else:
                eng = _built(built, Engine, tag)
                if len(r.tokens) < CLI_GEN + 1 or (
                        mode == "ar" and len(r.tokens) != CLI_GEN + 1):
                    _fail(f"cli {tag}: {len(r.tokens)} tokens")
                wit = _eager_twin(eng)
                runs_ = ((ar_gate_run(llama, eng, prompt0, 0),
                          ar_gate_run(llama, wit, prompt0, 0))
                         if mode == "ar" else
                         (spec_gate_run(eng, prompt0, mode, 0),
                          spec_gate_run(wit, prompt0, mode, 0)))
                res["graphs"][tag] = mode_graphs(
                    "cli " + tag, dict(captures=r.captures,
                                       capture_s=r.capture_s,
                                       pool_bytes=eng.graphs.pool_bytes),
                    1e3 / r.tokens_per_sec, r.tokens,
                    graph_gate("cli " + tag, fd, rk, *runs_))
                eng.release_graphs()
                del wit
                _reset(fd, rk)
                for k, fn in _wrappers(fd, rk).items():
                    fn.launches = cli_launches[k]
                pre = _pre_fwd(P, eng.prefill_chunk)
                if mode == "ar":
                    got = _check_counts(fd, rk, f"cli {tag}", quant,
                                        L * (pre + CLI_GEN), 0)
                else:
                    got = _check_counts(
                        fd, rk, f"cli {tag}", quant,
                        L * (pre + r.middle_verifies + r.steps), L)
            if mode != "ar" and r.readbacks != 1:
                _fail(f"cli {tag}: the generation read back {r.readbacks} "
                      f"times, not once")
            row = dict(ms_per_token=1e3 / r.tokens_per_sec,
                       tokens_per_step=r.avg_tokens_per_step,
                       acceptance_rate=r.acceptance_rate, steps=r.steps,
                       readbacks=r.readbacks,
                       tokens=len(r.tokens) - 1, prefill_s=r.prefill_s,
                       prefill_captures=r.prefill_captures,
                       prefill_capture_s=r.prefill_capture_s,
                       load_s=load_s[0], setup_s=setup_s, call_s=total)
            print(f"cli {tag}: {row['ms_per_token']:.3f} ms/token, "
                  f"{r.avg_tokens_per_step:.2f} tokens/step, acceptance "
                  f"{r.acceptance_rate:.3f}, {r.steps} steps, prefill "
                  f"{r.prefill_s:.2f} s (+ {r.prefill_captures} captures in "
                  f"{r.prefill_capture_s:.2f} s; load {load_s[0]:.2f} s, "
                  f"engine set-up {setup_s:.2f} s, call {total:.1f} s)",
                  flush=True)
        res["launches"][tag] = got
        res["runs"][tag] = row
        outs[tag] = out
        del built, out
        torch.cuda.empty_cache()

    # --- the CLI's AR tokens are decoding.autoregressive's on the same weights
    spec = tc.SpecConfig(gamma=GAMMA, budget=CLI_BUDGET, chunk_size=8,
                         draft_start_size=16,
                         draft_recent_size=266 - 16 - GAMMA,
                         temperature=0.6, top_p=0.9, max_len=CLI_GEN)
    eng = Engine(cfg, spec, tp, draft_cfg=dcfg, draft_params=dp, prefill=P,
                 max_cache_len=P + 2 * (CLI_GEN + GAMMA + 2), dtype=bf,
                 device=dev)
    ids = torch.from_numpy(data.fit_prompt(
        data.synthetic_prompts(1, P, cfg.vocab_size, 0)[0], P)).to(dev)
    r = decoding.autoregressive(eng, ids, max_len=CLI_GEN, seed=0,
                                device=dev)
    if r.tokens != outs["ar"].tokens:
        _fail("cli ar: the command line's tokens differ from "
              "decoding.autoregressive on the same weights and seed")
    print(f"cli ar: {len(r.tokens)} tokens equal decoding.autoregressive's "
          f"on the in-memory weights, bit for bit", flush=True)

    # --- 5. the command a user types, as its own process
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "triforce_tpu_torch.cli", "--mode", "ar",
         *base, "--gen_len", str(CLI_SUBPROCESS_GEN)],
        capture_output=True, text=True, cwd=root, env=env, timeout=300)
    line = [ln for ln in proc.stdout.splitlines() if "[ar] prompt 0:" in ln]
    if proc.returncode != 0 or not line:
        _fail(f"cli: python3 -m triforce_tpu_torch.cli --mode ar exited "
              f"{proc.returncode}: {proc.stderr[-1500:]}")
    res["subprocess_s"] = time.perf_counter() - t0
    print(f"cli subprocess (python3 -m triforce_tpu_torch.cli --mode ar, "
          f"{res['subprocess_s']:.1f} s): {line[0].strip()}", flush=True)

    # --- 6. the card's phase table and the first profiler trace
    state = eng.prefill_draft(eng.prefill_target(eng.init_state(3), ids),
                              ids)
    times = profiling.measure_phase_times(eng, state, iters=20)
    res["phase_ms"] = {k: v * 1e3 for k, v in times.items()}
    print("cli measure_phase_times, graphed (ms): "
          + json.dumps(res["phase_ms"]), flush=True)
    times = profiling.measure_phase_times(_eager_twin(eng), state, iters=20)
    res["phase_ms_eager"] = {k: v * 1e3 for k, v in times.items()}
    print("cli measure_phase_times, eager (ms): "
          + json.dumps(res["phase_ms_eager"]), flush=True)
    # the eager witness's steps: CUPTI cannot trace the graphed step's
    # if-nodes on this card (``_busy``); the kernels are the same
    step = _eager_twin(eng)._step_fn("triforce", None)
    state, _ = step(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profiling.trace(os.path.join(tmp, "trace")) as prof:
        for _ in range(2):
            state, _ = step(state)
        torch.cuda.synchronize()
    res["trace_wall_ms"] = (time.perf_counter() - t0) * 1e3
    ops = _device_ops(prof)
    res["trace_top_ops"] = [dict(name=n, calls=c, ms=ms) for n, c, ms in ops]
    print(f"cli trace: two TriForce steps of the eager witness, "
          f"{res['trace_wall_ms']:.1f} ms wall under the profiler; ten "
          f"largest device operations by total time:", flush=True)
    for n, c, ms in ops:
        print(f"  {ms:9.3f} ms  x{c:<5d} {n[:110]}", flush=True)
    if not ops:
        print("  (no device time in the trace)", flush=True)
    res["build_trace"] = build_trace(profiling, rk, eng, state, tmp)
    eng.release_graphs()
    del eng, state, tp, dp
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Sharded phase: the batch-1 engine over a mesh (parallel/)
# ---------------------------------------------------------------------------

# the two-rank runs' prompt and tokens, cut from 8192 and 32 for the time
# limit
SHARD_PREFILL, SHARD_GEN = 4096, 8
SHARD_LAYERS = 8      # the two-rank tp / sp runs' depth (32 until PR 15:
#                       cut for the time limit when the rest of the mesh
#                       came)
SHARD_RUNS = ((2, 1), (1, 2))         # (tp, sp) of the two-rank runs
SHARD_TIMEOUT_S = 600


def _probe_tokens(vocab, n, dev):
    return torch.randint(0, vocab, (1, n),
                         generator=torch.Generator().manual_seed(9)).to(dev)


def teacher_logits(llama, eng, ids, probe, kv=None):
    """fp32 logits [T, V] of the prompt's last token and ``probe`` (a
    verify's width of fixed tokens) appended to ``eng``'s prefill of the
    rest of ``ids``: the same input on any engine, meshed or not. ``kv``:
    a cache this engine prefilled with ``ids`` (and maybe decoded on),
    read back to the prompt less its last token, instead of a new
    prefill (its slots below that length are the prefill's)."""
    if kv is None:
        kv = eng.prefill_body(eng.init_state(3).kv, ids[:, :-1])
    else:
        kv = kv.rollback(kv.seq_len - (ids.shape[1] - 1))
    toks = torch.cat([ids[:, -1:], probe], dim=1)
    out, _, _ = llama.forward_append(eng.target_cfg, eng.t_params, toks, kv,
                                     **eng.fwd)
    return out[0].float().cpu()


def hold_logits(what, got, ref):
    """The near-tie rule of the reference phase: ``got``'s top-1 may differ
    from ``ref``'s only where ref's two candidates are closer than twice
    the row's largest logit difference."""
    err = (got - ref).abs().max().item()
    flips = _flips(got, ref)
    hard = _near_tie_misses(got, ref, flips)
    if hard or not torch.isfinite(got).all():
        _fail(f"{what}: top-1 differs from the meshless run's at rows "
              f"{hard} that are no near tie (max |logit diff| {err:.3e})")
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1).min()
    return dict(max_abs_logit_err=err, rel_err=err / ref.abs().max().item(),
                cosine=cos.item(), top1_flips=len(flips),
                rows=int(got.shape[0]))


def _common_prefix(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def _path_counts(what, fd, rk, got, quant, L, pre_fwd, forwards, builds):
    """A meshed run's launches: every attention is B4's (the cache
    partials on each rank's shard), B2 once a layer per retrieval build,
    B1 and B3 never."""
    want = dict.fromkeys(COUNTERS, 0)
    want["b4_int8" if quant else "b4"] = L * (pre_fwd + forwards)
    want["b2_int8" if quant else "b2"] = L * builds
    print(f"  launches [{what}]: {got} (path implies {want})", flush=True)
    if got != want:
        _fail(f"{what}: kernel launch counts {got} != {want}")


MESH_GATE_TOKENS = 8      # tokens a mode in the world-1 gate's two runs


def mesh_gate_run(eng, ids, n=MESH_GATE_TOKENS):
    """The world-1 gate's run on ``eng``: one prefill (target and drafter,
    seed 1), then from the state it leaves, in turn, ``n`` TriForce tokens
    (``generate``), ``n`` forced TriForce tokens at alpha 0.9
    (``generate_forced``) and ``n`` AR tokens (``generate_ar`` from the kv
    and next token where the forced run stopped): one prompt's prefill
    serves the three modes. Each mode's ms/token (graphed: CUDA-event
    busy time around the replays, captures left out)."""
    def gen_spec(mode):
        def call(st):
            if mode == "triforce":
                return eng.generate(st, n, mode="triforce")
            return eng.generate_forced(st, n, 0.9, mode="triforce")
        return call

    def run():
        st, pre = _prefill_run(eng, lambda: eng.prefill_draft(
            eng.prefill_target(eng.init_state(1), ids), ids))
        c0 = eng.graphs.captures
        out = dict(prefill=pre, tokens=[], counters=[], readbacks=[],
                   ms={}, steps={})
        for mode in ("triforce", "forced"):
            r0 = eng.graphs.readbacks
            if eng.graphs.enabled:
                (st, buf, m, c), b = _busy(lambda: gen_spec(mode)(st),
                                           eng.graphs)
                dt = b["wall_ms"] / 1e3
            else:
                (st, buf, m, c), dt = _timed(lambda: gen_spec(mode)(st))
            out["tokens"].append(buf[:m].tolist())
            out["counters"].append([int(x) for x in c])
            out["readbacks"].append(eng.graphs.readbacks - r0)
            out["ms"][mode] = 1e3 * dt / (m - 1)
            out["steps"][mode] = (int(c[0]), int(c[7]))  # steps, mid verifies
        if eng.graphs.enabled:
            (kv, _, _, buf), b = _busy(lambda: eng.generate_ar(
                st.kv, st.next_token, st.gen, n), eng.graphs)
            dt = b["wall_ms"] / 1e3
        else:
            (kv, _, _, buf), dt = _timed(lambda: eng.generate_ar(
                st.kv, st.next_token, st.gen, n))
        out["tokens"].append(buf.tolist())
        out["ms"]["ar"] = 1e3 * dt / n
        out["seq_len"] = int(kv.seq_len)
        out["captures"] = eng.graphs.captures - c0
        out["kv"] = kv
        return out
    return run


def sharded_world1(tc, llama, Engine, mesh, fd, rk, dev, prefill, quant,
                   tp, dp, meshless):
    """World size 1 over ``mesh`` (NCCL, one rank) at full width: the
    meshless engine's weights ``tp`` / ``dp`` in ``Engine(mesh=,
    shard_seq=True)``, graphed. Its logits on a fixed verify-width input
    are held to the meshless engine's by the near-tie rule; TriForce,
    forced TriForce and AR from one prefill (``mesh_gate_run``) are held
    bit for bit against the mesh engine's eager witness (tokens, counters,
    kv length, launches, the prefill's caches; one read-back a
    generation), with B4 and B2 the only kernels launched (exact counts);
    then each mode is timed alone, with the seed, prompt and length of
    the meshless engine's gate (``meshless``: ``end_to_end``'s
    ``graphs``), and printed beside it. This is B4 + the merge against B1's fold, and the
    collectives, at world size 1."""
    tag = "int8 " if quant else ""
    tcfg, dcfg = tc.LLAMA2_7B_128K, tc.LLAMA_68M
    L = tcfg.num_layers
    spec = tc.SpecConfig(gamma=GAMMA, budget=4096, chunk_size=8)
    kw = dict(draft_cfg=dcfg, draft_params=dp, prefill=prefill,
              max_cache_len=prefill + GEN + 4 * (GAMMA + 2),
              dtype=tp["embed"].dtype, device=dev, kv_quant=quant,
              weight_quant=quant)
    ids = torch.randint(0, tcfg.vocab_size, (1, prefill),
                        generator=torch.Generator().manual_seed(5)).to(dev)
    probe = _probe_tokens(tcfg.vocab_size, GAMMA + 1, dev)
    plain = Engine(tcfg, spec, tp, **kw)
    ref = teacher_logits(llama, plain, ids, probe)
    plain.release_graphs()
    del plain
    torch.cuda.empty_cache()
    eng = Engine(tcfg, spec, tp, mesh=mesh, shard_seq=True, **kw)
    witness = _eager_twin(eng)
    runs = {}
    for name, e in (("graphed", eng), ("eager", witness)):
        mesh.collectives.clear()
        _reset(fd, rk)
        r = mesh_gate_run(e, ids)()
        r["launches"] = {k: f.launches for k, f in _wrappers(fd, rk).items()}
        r["collectives"] = dict(mesh.collectives)
        kv = r.pop("kv")
        if name == "graphed":    # the logits over the gate's own prefill
            res = {"logits": hold_logits(
                f"{tag}mesh world 1 logits",
                teacher_logits(llama, eng, ids, probe, kv), ref)}
        del kv
        runs[name] = r
    lg = res["logits"]
    print(f"{tag}mesh world 1 [{mesh.backend}]: logits of a {GAMMA + 2}-token "
          f"verify after the {prefill}-token prefill against the meshless "
          f"engine's: max |diff| {lg['max_abs_logit_err']:.3e} "
          f"({lg['rel_err']:.4f} of the largest), cosine "
          f"{lg['cosine']:.6f}, {lg['top1_flips']} top-1 flips (near ties)",
          flush=True)
    g, w = runs["graphed"], runs["eager"]
    for key in ("tokens", "counters", "seq_len", "launches"):
        if g[key] != w[key]:
            _fail(f"{tag}mesh world 1 gate: the graphed run's {key} {g[key]} "
                  f"differ from the eager witness's {w[key]}")
    if g["prefill"]["digest"] != w["prefill"]["digest"]:
        _fail(f"{tag}mesh world 1 gate: the graphed prefill left other bits "
              f"than the eager witness's")
    if not g["captures"] or g["readbacks"] != [1, 1]:
        _fail(f"{tag}mesh world 1 gate: {g['captures']} captures, "
              f"read-backs {g['readbacks']} (one a generation)")
    body = prefill - 1
    pre_fwd = -(-body // eng.prefill_chunk) + 1
    fwd = sum(sum(x) for x in g["steps"].values()) + MESH_GATE_TOKENS
    _path_counts(f"{tag}mesh world 1", fd, rk, g["launches"], quant, L,
                 pre_fwd, fwd, 1)
    # the timed runs: each mode from its own prefill, with the seed, prompt
    # and length of the meshless engine's gate, so the two windows match
    timed = {}
    for mode, run in (("triforce", spec_gate_run(eng, ids, "triforce", 1)),
                      ("forced", spec_gate_run(eng, ids, "triforce", 2,
                                               0.9)),
                      ("ar", ar_gate_run(llama, eng, ids, 0))):
        r = run()
        timed[mode] = dict(
            ms_per_token=1e3 * r["decode_s"] / max(r["n"], 1),
            tokens=len(r["tokens"]),
            tokens_equal_meshless=_common_prefix(
                r["tokens"], meshless[mode]["gate_token_ids"]))
        if "prefill" in r:
            timed[mode]["prefill_s"] = r["prefill"]["prefill_s"]
    same = timed["triforce"]["tokens_equal_meshless"]
    res.update(timed=timed,
        prefill=prefill_line(f"{tag}mesh world 1", g["prefill"],
                             w["prefill"]),
        meshless_prefill_s=meshless["triforce"]["gate_prefill_s"],
        ms_per_token={m: g["ms"][m] for m in g["ms"]},
        eager_ms_per_token=w["ms"],
        meshless_ms_per_token={
            m: meshless[m]["gate_ms_per_token_graphed"]
            for m in ("triforce", "forced", "ar")},
        steps=g["steps"], readbacks=g["readbacks"], captures=g["captures"],
        triforce_tokens_equal_meshless=same,
        # counted in Python: the eager witness's are the run's (a graph
        # counts what it captured, once)
        collectives=w["collectives"], launches=g["launches"],
        tokens=[len(t) for t in g["tokens"]])
    ms0 = res["meshless_ms_per_token"]
    print(f"{tag}mesh world 1: graphed = eager witness over the prefill and "
          f"{MESH_GATE_TOKENS} tokens each of TriForce, forced TriForce and "
          f"AR (tokens, counters, kv length, launches, caches; one "
          f"read-back a generation); timed as the meshless gates (same "
          f"seeds, prompt and length), ms/token graphed TriForce "
          f"{timed['triforce']['ms_per_token']:.3f} (meshless "
          f"{ms0['triforce']:.3f}), forced "
          f"{timed['forced']['ms_per_token']:.3f} ({ms0['forced']:.3f}), "
          f"AR {timed['ar']['ms_per_token']:.3f} ({ms0['ar']:.3f}); "
          f"prefill {timed['triforce']['prefill_s']:.3f} s (meshless "
          f"{res['meshless_prefill_s']:.3f}); the first {same} of "
          f"{timed['triforce']['tokens']} TriForce tokens equal the "
          f"meshless run's; collectives (the eager witness's, over the "
          f"gate) {w['collectives']}", flush=True)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    eng.release_graphs()
    return res


def _rank_env(rank, world, port):
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port), GLOO_SOCKET_IFNAME="lo")


def shard_rank_main(job_path: str) -> int:
    """One rank of a two-rank run (``sharded_two_ranks``): joins the gloo
    group on the parent's card, makes its shards of the same random
    weights, prefills, runs TriForce eagerly and writes what it saw."""
    from triforce_tpu_torch import config as tc
    from triforce_tpu_torch.engine import Engine
    from triforce_tpu_torch.models import llama
    from triforce_tpu_torch.ops import flash_decode as fd
    from triforce_tpu_torch.ops import retrieval_kernel as rk
    from triforce_tpu_torch.parallel import mesh as mesh_mod
    from triforce_tpu_torch.parallel import sharding
    import torch.distributed as dist
    with open(job_path) as f:
        job = json.load(f)
    dev = mesh_mod.init_distributed(backend="gloo", device=job["device"],
                                    timeout_s=SHARD_TIMEOUT_S)
    rank = dist.get_rank()
    mesh = mesh_mod.make_mesh(tp=job["tp"], sp=job["sp"], device=dev)
    tcfg, dcfg = getattr(tc, job["target"]), getattr(tc, job["draft"])
    if job["layers"]:
        tcfg = tcfg.with_(num_layers=job["layers"])
    spec = tc.SpecConfig(**job["spec"])
    prefill = job["prefill"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tp = llama.init_params(tcfg, device=dev, dtype=getattr(torch,
                                                           job["dtype"]),
                           seed=0, shardings=sharding.param_shardings(
                               mesh, tcfg))
    dp = llama.init_params(dcfg, device=dev, dtype=getattr(torch,
                                                           job["dtype"]),
                           seed=1)
    eng = Engine(tcfg, spec, tp, draft_cfg=dcfg, draft_params=dp,
                 prefill=prefill, max_cache_len=job["max_cache_len"],
                 dtype=getattr(torch, job["dtype"]), device=dev, mesh=mesh,
                 shard_seq=job["sp"] > 1, graphs=False)
    ids = torch.tensor(job["ids"], dtype=torch.int64, device=dev)
    _reset(fd, rk)
    t0 = time.perf_counter()
    st = eng.prefill_draft(eng.prefill_target(eng.init_state(1), ids), ids)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre_coll = dict(mesh.collectives)
    mesh.collectives.clear()
    mesh.collective_bytes.clear()
    t0 = time.perf_counter()
    st, buf, n, counters = eng.generate(st, job["gen"], mode="triforce")
    decode_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in _wrappers(fd, rk).items()}
    steps = int(counters[0])
    out = dict(tokens=buf[:n].tolist(), counters=[int(x) for x in counters],
               prefill_s=prefill_s, ms_per_token=1e3 * decode_s / (n - 1),
               launches=launches, steps=steps,
               prefill_collectives=pre_coll,
               decode_collectives=dict(mesh.collectives),
               decode_collective_bytes=dict(mesh.collective_bytes),
               collectives_per_step={k: v / max(steps, 1) for k, v in
                                     mesh.collectives.items()})
    probe = torch.tensor(job["probe"], dtype=torch.int64, device=dev)
    out["logits"] = teacher_logits(llama, eng, ids, probe, st.kv).tolist()
    del st
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["weights_gib"] = sum(x.numel() * x.element_size() for x in
                                 list(tp["layers"].values())
                                 + [tp["embed"], tp["lm_head"]]) / 2**30
    with open(f"{job['out']}.{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def sharded_two_ranks(tc, llama, Engine, fd, rk, dev, tmp,
                      target="LLAMA2_7B_128K", draft="LLAMA_68M",
                      prefill=SHARD_PREFILL, gen=SHARD_GEN, dtype="bfloat16",
                      rank_device="cuda:0", layers=None):
    """Two ranks on the one card over gloo, eagerly, at full width: for
    each (tp, sp) of ``SHARD_RUNS`` two child processes (this script with
    ``--shard-rank``) each hold their shards of the same random weights,
    prefill ``prefill`` tokens and run ``gen`` TriForce tokens. Every rank
    must emit the same tokens and launch B4 and B2 (never B1); their
    logits on a fixed verify-width input are held to the meshless
    engine's by the near-tie rule, and their tokens printed beside its.
    The meshless reference runs first, graphed, and is freed (its engine,
    graphs and weights) before the children start. ``layers``: cut the
    target's depth (a rehearsal)."""
    tcfg, dcfg = getattr(tc, target), getattr(tc, draft)
    if layers:
        tcfg = tcfg.with_(num_layers=layers)
    spec_kw = dict(gamma=GAMMA, budget=4096, chunk_size=8)
    if prefill < 2 * spec_kw["budget"]:
        spec_kw["budget"] = prefill // 4
    spec = tc.SpecConfig(**spec_kw)
    dt = getattr(torch, dtype)
    max_len = prefill + gen + 4 * (GAMMA + 2)
    ids = torch.randint(0, tcfg.vocab_size, (1, prefill),
                        generator=torch.Generator().manual_seed(6))
    probe = _probe_tokens(tcfg.vocab_size, GAMMA + 1, "cpu")
    tp = llama.init_params(tcfg, device=dev, dtype=dt, seed=0)
    dp = llama.init_params(dcfg, device=dev, dtype=dt, seed=1)
    eng = Engine(tcfg, spec, tp, draft_cfg=dcfg, draft_params=dp,
                 prefill=prefill, max_cache_len=max_len, dtype=dt, device=dev)
    st = eng.prefill_draft(eng.prefill_target(eng.init_state(1),
                                              ids.to(dev)), ids.to(dev))
    st, buf, n, _ = eng.generate(st, gen, mode="triforce")
    ref_tokens = buf[:n].tolist()
    ref = teacher_logits(llama, eng, ids.to(dev), probe.to(dev), st.kv)
    del st
    eng.release_graphs()
    del eng, tp, dp
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        print(f"two ranks: the parent holds "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB before the "
              f"ranks start", flush=True)
    res = {}
    for tp_, sp_ in SHARD_RUNS:
        name = f"tp{tp_} sp{sp_}"
        job = dict(tp=tp_, sp=sp_, target=target, draft=draft,
                   spec=spec_kw, prefill=prefill, gen=gen, dtype=dtype,
                   max_cache_len=max_len, ids=ids.tolist(),
                   probe=probe.tolist(), device=rank_device, layers=layers,
                   out=os.path.join(tmp, name.replace(" ", "_")))
        path = job["out"] + ".job.json"
        with open(path, "w") as f:
            json.dump(job, f)
        port = _free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--shard-rank", path],
            env=_rank_env(r, 2, port), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=SHARD_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                _fail(f"two ranks [{name}]: rank {r} exited "
                      f"{p.returncode}:\n{log[-3000:]}")
        ranks = []
        for r in range(2):
            with open(f"{job['out']}.{r}.json") as f:
                ranks.append(json.load(f))
        if ranks[0]["tokens"] != ranks[1]["tokens"]:
            _fail(f"two ranks [{name}]: the ranks emitted different tokens")
        if ranks[0]["logits"] != ranks[1]["logits"]:
            _fail(f"two ranks [{name}]: the ranks' logits differ")
        for r, x in enumerate(ranks):
            lc = x["launches"]
            # (ranks on the CPU, a rehearsal, take the plain versions)
            if torch.device(rank_device).type == "cuda" and (
                    not (lc["b4"] > 0 and lc["b2"] > 0) or any(
                        lc[k] for k in COUNTERS if k not in ("b4", "b2"))):
                _fail(f"two ranks [{name}] rank {r}: launches {lc} (the "
                      f"mesh path runs B4 and B2 alone)")
        held = hold_logits(f"two ranks [{name}] logits",
                           torch.tensor(ranks[0]["logits"]), ref)
        same = _common_prefix(ranks[0]["tokens"], ref_tokens)
        out = dict(tokens=len(ranks[0]["tokens"]),
                   tokens_equal_meshless=same, logits=held,
                   prefill_s=ranks[0]["prefill_s"],
                   ms_per_token=ranks[0]["ms_per_token"],
                   steps=ranks[0]["steps"],
                   launches=ranks[0]["launches"],
                   prefill_collectives=ranks[0]["prefill_collectives"],
                   decode_collectives=ranks[0]["decode_collectives"],
                   decode_collective_bytes=ranks[0]["decode_collective_bytes"],
                   collectives_per_step=ranks[0]["collectives_per_step"],
                   peak_gib=[x.get("peak_gib") for x in ranks],
                   weights_gib=[x.get("weights_gib") for x in ranks],
                   wall_s=wall)
        res[name] = out
        print(f"two ranks [{name}, gloo on {rank_device}, eager]: both "
              f"ranks emitted the same {out['tokens']} tokens, {same} of "
              f"them equal to the meshless run's; logits max |diff| "
              f"{held['max_abs_logit_err']:.3e} ({held['rel_err']:.4f} of "
              f"the largest, cosine {held['cosine']:.6f}, "
              f"{held['top1_flips']} top-1 flips, near ties); prefill {out['prefill_s']:.2f} s, "
              f"{out['ms_per_token']:.1f} ms/token ({out['steps']} steps); "
              f"per rank peak {out['peak_gib']} GiB, weights "
              f"{out['weights_gib']} GiB; collectives per step "
              f"{out['collectives_per_step']}, decode bytes "
              f"{out['decode_collective_bytes']}; launches {out['launches']}; "
              f"{wall:.1f} s with start-up", flush=True)
    return res


# ---------------------------------------------------------------------------
# The rest of the mesh (PR 15): the tree engine over a mesh, rows over dp,
# the composed dp x tp x sp mesh
# ---------------------------------------------------------------------------

MESH_ROWS_STEPS = 4        # batched steps a decode call of the dp-2 ranks
MESH_SERVE_REQUESTS, MESH_SERVE_NEW = 4, 16
COMPOSED_PREFILL, COMPOSED_STEPS, COMPOSED_BUDGET = 4096, 3, 1024


def kernel_mesh_shapes(fd, att, cache_mod, dev, prefill, s_tree, s_rkv,
                       w_pad):
    """B4 and B3 at the shapes the rest of the mesh gives them: B4 at the
    tree verify over a mesh (every attention of a meshed forward is B4:
    GT 128 over ``prefill`` keys at Llama2-7B; TinyLlama's G 8 x 128 =
    1024 at D 64), at a grow level over 16 heads (tp 2 of 7B: GT 22 over
    the 4096-slot budget region), at a row's verify over a 4096-key shard
    (rows over sp 2 at 8192) and at the composed run's rank (TinyLlama, 2
    KV heads, GT 8 x 8 over a 2048-key shard); B3 over 16 heads (7B at tp
    2, rows at 8192), each against its plain version with device time,
    bound and SDPA time."""
    out = {}
    for quant in (False, True):
        out[quant] = dict(
            b4=[kernel_b4(fd, att, cache_mod, dev, TREE_SIZE, prefill,
                          s_tree, quant=quant, tn=TREE_SIZE),
                kernel_b4(fd, att, cache_mod, dev, 8 * TREE_SIZE, prefill,
                          s_tree, quant=quant, hkv=4, d=64, tn=TREE_SIZE),
                kernel_b4(fd, att, cache_mod, dev, w_pad, 4096, s_rkv,
                          quant=quant, hkv=16),
                kernel_b4(fd, att, cache_mod, dev, GAMMA + 2, 4096,
                          4096 + 64, quant=quant),
                kernel_b4(fd, att, cache_mod, dev, 8 * (GAMMA + 2),
                          COMPOSED_PREFILL // 2, COMPOSED_PREFILL // 2 + 64,
                          quant=quant, hkv=2, d=64, tn=GAMMA + 2)],
            b3=[kernel_b3(fd, cache_mod, dev, GAMMA + 2, GAMMA + 2,
                          SERVE_PREFILL, SERVE_PREFILL + 512, quant=quant,
                          hkv=16)])
    return out


def tree_teacher_logits(llama, eng, state):
    """fp32 logits [1 + W + size, V] of fixed inputs on ``eng``'s prefilled
    ``state``: the grow's root forward, its first level's forward on fixed
    tokens, and the tree verify of those tokens under the ancestor mask
    (the same inputs on any engine, meshed or not: the root is a fixed
    token too, since the sampled first token of a near-uniform random
    model flips with the last bits of its logits). They write what a step
    writes (the tree scratch, slots past the length), which the next step
    overwrites; the length stays."""
    gm, seq = eng.gm, state.kv.seq_len
    fixed = _probe_tokens(eng.cfg.vocab_size, gm.size, eng.device)[0]
    kw = dict(kv=state.kv, ssl=eng.ssl, act_quant=eng.weight_quant,
              **eng.fwd)
    root, _, _ = llama.forward_tree_spec(
        eng.cfg, eng.params, fixed[None, :1], state.rkv, seq,
        eng.budget, depths=eng._depth[0:1], ancestor_mask=eng._mask[0:1],
        slot_start=0, staged_len=0, **kw)
    lvl, _, _ = llama.forward_tree_spec(
        eng.cfg, eng.params, fixed[None, 1:1 + eng.W], state.rkv, seq,
        eng.budget, depths=eng._depth_rows[0], ancestor_mask=eng._mask_rows[0],
        slot_start=eng._starts[0], staged_len=gm.size, **kw)
    ver, _, _ = llama.forward_append(
        eng.cfg, eng.params, fixed[None], state.kv,
        positions=seq.to(torch.int64) + eng._depth, tree_mask=eng._mask,
        **eng.fwd)
    return torch.cat([root[0], lvl[0], ver[0]]).float().cpu()


E2E_PREFILL = 16384        # the 7B end-to-end phases' prompt (32768
#                            until PR 15: cut for the time limit)
TREE_MESH_PREFILL = 4096   # the world-1 tree's prompt (cut from 32768
#                            for the time limit)
TREE_MESH_COSINE = 0.99    # the least cosine of a teacher row (PR 14's
#                            world-1 batch-1 logits read 0.996-0.998)


def tree_mesh_world1(tc, llama, planner, spectree, mesh, fd, rk, dev, params,
                     prefill, quant):
    """The tree engine over ``mesh`` (NCCL, world size 1) at full width:
    Llama2-7B-128K's weights ``params`` (int8 codes with ``quant``) in
    ``TreeEngine(mesh=, shard_seq=True)`` with the path's 128-node tree,
    graphed, at ``prefill``. The grow's root and first-level logits and
    the tree verify's logits on fixed inputs are held to the meshless
    ``TreeEngine``'s by the near-tie rule and a cosine floor;
    ``tree_decode``'s generation and a forced one are held bit for bit
    against the mesh engine's eager witness (tokens, counters, kv length,
    launches, prefill caches; one read-back a generation), with B4 and B2
    the only kernels launched (exact counts); then a timed forced run,
    its ms/step beside the meshless tree's at the same prompt, timed in
    this phase."""
    tag = "int8 " if quant else ""
    cfg = tc.LLAMA2_7B_128K
    L = cfg.num_layers
    gm = _grow_map(planner)
    kw = dict(prefill=prefill,
              max_cache_len=prefill + TREE_GEN + TREE_FORCED_GEN
              + 4 * gm.size, budget=4096, chunk_size=8, temperature=0.6,
              top_p=0.9, dtype=torch.bfloat16, prefill_chunk=512,
              device=dev, kv_quant=quant, weight_quant=quant, eos_ids=())
    ids = torch.randint(0, cfg.vocab_size, (1, prefill),
                        generator=torch.Generator().manual_seed(5)).to(dev)
    plain = spectree.TreeEngine(cfg, gm, params, **kw)
    eng = spectree.TreeEngine(cfg, gm, params, mesh=mesh, shard_seq=True,
                              **kw)
    witness = _eager_twin(eng)
    # both teachers read the meshless prefill's caches: the retrieval
    # build's top-k of chunks flips with the last bits of a prefill, so
    # two prefills would hold apart retrieval caches
    st = plain.prefill_target(plain.init_state(3), ids)
    mst = eng.init_state(3)
    for name in ("kv", "rkv"):
        for plane in ("k", "v", "k_scale", "v_scale"):
            src = getattr(getattr(st, name), plane, None)
            if src is not None:
                dst = getattr(getattr(mst, name), plane)
                n = min(src.shape[3], dst.shape[3])
                dst[:, :, :, :n].copy_(src[:, :, :, :n])
    mst.kv = dataclasses.replace(mst.kv, seq_len=st.kv.seq_len.clone())
    ref = tree_teacher_logits(llama, plain, st)
    got = tree_teacher_logits(llama, eng, mst)
    del st, mst
    meshless = _tree_forced_ms(plain, ids, prefill)
    plain.release_graphs()
    del plain
    torch.cuda.empty_cache()
    held = hold_logits(f"{tag}tree mesh world 1 logits", got, ref)
    if not held["cosine"] >= TREE_MESH_COSINE:
        _fail(f"{tag}tree mesh world 1: a teacher row's cosine "
              f"{held['cosine']:.6f} against the meshless tree's is under "
              f"{TREE_MESH_COSINE}")
    fwd = gm.num_levels + 1            # grow forwards a step
    body = prefill - 1
    pre_fwd = -(-body // eng.prefill_chunk) + 1
    res = dict(logits=held, launches={}, graphs={})
    mesh.collectives.clear()
    for what, seed, alpha in (("tree_decode", 1, None),
                              ("tree forced", 2, 0.9)):
        gate = graph_gate(f"{tag}tree mesh world 1 {what}", fd, rk,
                          tree_gate_run(eng, ids, seed, alpha),
                          tree_gate_run(witness, ids, seed, alpha))
        steps = gate["counters"][0]
        _path_counts(f"{tag}tree mesh world 1 {what}", fd, rk,
                     gate["launches_by_kernel"], quant, L, pre_fwd,
                     steps * (fwd + 1), 1)
        res["launches"][what] = gate["launches_by_kernel"]
        res["graphs"][what] = gate
    # the timed forced run, as the meshless tree's
    forced = _tree_forced_ms(eng, ids, prefill)
    ms0 = meshless["ms_per_step"]
    res.update(forced=dict(forced, meshless=meshless),
               collectives=dict(mesh.collectives),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    eng.release_graphs()
    print(f"{tag}tree mesh world 1 [{mesh.backend}]: logits (root, level, "
          f"verify: {held['rows']} rows) against the meshless tree's: max "
          f"|diff| {held['max_abs_logit_err']:.3e} ({held['rel_err']:.4f} "
          f"of the largest), cosine {held['cosine']:.6f}, "
          f"{held['top1_flips']} top-1 flips (near ties); tree_decode and "
          f"forced graphed = eager witness (one read-back a generation, B4 "
          f"and B2 alone); forced a=0.9 {forced['ms_per_step']:.1f} "
          f"ms/step (meshless at the same prompt {ms0:.1f}), "
          f"{forced['tokens_per_step']:.2f} tokens/step ({prefill}-token "
          f"prompt)", flush=True)
    return res


def _tree_forced_ms(eng, ids, prefill):
    """A forced (0.9) tree generation of TREE_FORCED_GEN tokens on
    ``eng`` from a fresh prefill: ms/step without capture seconds, one
    read-back, the kv length its nodes imply."""
    state = eng.prefill_target(eng.init_state(2), ids)
    torch.cuda.synchronize()
    snap = _snap(eng.graphs)
    t0 = time.perf_counter()
    state, buf, n, counters, _ = eng.generate_forced(state, TREE_FORCED_GEN,
                                                     0.9)
    d = _since(eng.graphs, snap)
    dt = time.perf_counter() - t0 - d["capture_s"]
    steps, nodes, readbacks = (int(x) for x in counters)
    if readbacks != 1 or int(state.kv.seq_len) != prefill + nodes:
        _fail(f"tree forced timing: {readbacks} read-backs, kv.seq_len "
              f"{int(state.kv.seq_len)} != {prefill} + {nodes}")
    return dict(steps=steps, ms_per_step=1e3 * dt / steps,
                tokens_per_step=(n - 1) / steps)


def _rows_ref(bs, eng, prompts, seeds, alpha, calls, steps):
    """Meshless batched TriForce on ``prompts`` (``calls`` decode calls of
    ``steps``): the tokens of every call, rows by row."""
    bat = bs.BatchedSpecEngine(eng, mode="triforce", force_accept=alpha)
    state = bat.prefill_rows(prompts, seeds)
    toks = []
    for _ in range(calls):
        state, t, ns, c, _ = bat.decode(state, steps)
        toks.append([[int(x) for s in range(steps) for x in t[r, s, :ns[r, s]]]
                     for r in range(t.shape[0])])
    return [sum((call[r] for call in toks), []) for r in range(len(seeds))]


def _serve(bs, batching, eng, slots, prompts, new, mesh=None):
    """``SpecScheduler`` (TriForce) over ``slots`` slots serving
    ``prompts`` (request id = index): (outputs by id, stats, wall s)."""
    sched = bs.SpecScheduler(eng, mode="triforce", slots=slots,
                             segment=SERVE_SEGMENT, mesh=mesh)
    for i, p in enumerate(prompts):
        sched.submit(batching.Request(rid=i, prompt=p.reshape(-1).cpu()
                                      .numpy(), max_new_tokens=new))
    t0 = time.perf_counter()
    done = sched.run()
    wall = time.perf_counter() - t0
    return ({r.rid: r.out for r in done}, dict(sched.stats), wall)


def _mesh_ranks_dp_tp(job, dev):
    """One rank of the two-rank run (``mesh_two_ranks``): dp 2 (a meshless
    engine, rows over a dp mesh: batched TriForce, then ``SpecScheduler``),
    then tp 2 (``TreeEngine`` over a tp mesh, two steps, eagerly)."""
    from triforce_tpu_torch import batched_spec as bs, batching
    from triforce_tpu_torch import config as tc
    from triforce_tpu_torch.engine import Engine
    from triforce_tpu_torch.models import llama
    from triforce_tpu_torch.ops import flash_decode as fd
    from triforce_tpu_torch.ops import retrieval_kernel as rk
    from triforce_tpu_torch.parallel import mesh as mesh_mod
    from triforce_tpu_torch.parallel import sharding
    from triforce_tpu_torch.tree import planner, spectree
    tcfg, dcfg = getattr(tc, job["target"]), getattr(tc, job["draft"])

    def launches():
        return {k: f.launches for k, f in _wrappers(fd, rk).items()}
    dt = getattr(torch, job["dtype"])
    cuda = dev.type == "cuda"
    out = {}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    # --- dp 2: rows over dp beside a meshless, graphed engine
    mesh = mesh_mod.make_mesh(dp=2, device=dev)
    tp = llama.init_params(tcfg, device=dev, dtype=dt, seed=0)
    dp = llama.init_params(dcfg, device=dev, dtype=dt, seed=1)
    P = len(job["prompts"][0][0])
    headroom = bs.SpecScheduler.required_headroom(MESH_SERVE_NEW,
                                                  SERVE_SEGMENT, GAMMA)
    eng = Engine(tcfg, tc.SpecConfig(gamma=GAMMA, budget=job["budget"],
                                     chunk_size=8),
                 tp, draft_cfg=dcfg, draft_params=dp, prefill=P,
                 max_cache_len=P + headroom, dtype=dt, device=dev,
                 eos_token_id=-1)
    prompts = [torch.tensor(p, dtype=torch.int64, device=dev)
               for p in job["prompts"]]
    bat = bs.BatchedSpecEngine(eng, mode="triforce", force_accept=0.9,
                               mesh=mesh)
    _reset(fd, rk)
    state = bat.prefill_rows(prompts, job["seeds"])
    rows = []
    ms = []
    for _ in range(2):           # the first call captures its loop graph
        torch.distributed.barrier()
        c0, s0 = eng.graphs.captures, eng.graphs.capture_s
        t0 = time.perf_counter()
        state, t, ns, c, _ = bat.decode(state, MESH_ROWS_STEPS)
        ms.append((1e3 * (time.perf_counter() - t0
                          - (eng.graphs.capture_s - s0))) / MESH_ROWS_STEPS)
        rows.append([[int(x) for s in range(MESH_ROWS_STEPS)
                      for x in t[r, s, :ns[r, s]]] for r in range(ROWS)])
    out["rows"] = [sum((call[r] for call in rows), []) for r in range(ROWS)]
    out["rows_ms_per_step"] = ms
    out["rows_local"] = len(state.gens)
    out["rows_launches"] = launches()
    out["rows_target_forwards"] = bat.target_forwards
    out["pre_fwd"] = -(-(P - 1) // eng.prefill_chunk) + 1
    del state, bat
    eng.release_graphs()          # the rows' loop graph and its pool
    if cuda:
        out["rows_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.empty_cache()
    _reset(fd, rk)
    done, stats, wall = _serve(bs, batching, eng, ROWS,
                               prompts[:MESH_SERVE_REQUESTS],
                               MESH_SERVE_NEW, mesh)
    out["serve_launches"] = launches()
    out["serve"] = {str(k): v for k, v in done.items()}
    out["serve_stats"] = stats
    out["serve_tokens_per_s"] = sum(len(v) for v in done.values()) / wall
    out["dp_collectives"] = dict(mesh.collectives)
    eng.release_graphs()
    del eng, tp, dp
    if cuda:
        torch.cuda.empty_cache()
        out["dp_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
    # --- tp 2: the tree engine over a tp mesh, eagerly (gloo)
    mesh2 = mesh_mod.make_mesh(tp=2, device=dev)
    tp = llama.init_params(tcfg, device=dev, dtype=dt, seed=0,
                           shardings=sharding.param_shardings(mesh2, tcfg))
    pv = planner.modeled_acceptance_vector(0.8, 4)
    gm = planner.build_grow_map(*planner.plan_tree(pv, *job["tree"]),
                                *job["tree"])
    ids = torch.tensor(job["tree_ids"], dtype=torch.int64, device=dev)
    teng = spectree.TreeEngine(
        tcfg, gm, tp, prefill=ids.shape[1],
        max_cache_len=ids.shape[1] + 4 * gm.size,
        budget=min(job["budget"], ids.shape[1] // 4),
        chunk_size=8, temperature=0.6, top_p=0.9, dtype=dt,
        prefill_chunk=512, device=dev, mesh=mesh2, graphs=False, eos_ids=())
    _reset(fd, rk)
    st = teng.prefill_target(teng.init_state(1), ids)
    toks, t0 = [], time.perf_counter()
    mesh2.collectives.clear()
    for _ in range(2):
        st, s = teng.step(st, force_accept=0.9)
        toks += s.tokens[:s.n_emitted].tolist()
    out["tree_tokens"] = toks
    out["tree_launches"] = launches()
    out["tree_pre_fwd"] = -(-(ids.shape[1] - 1) // teng.prefill_chunk) + 1
    out["tree_fwd"] = gm.num_levels + 1
    out["tree_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / 2
    out["tree_collectives_per_step"] = {k: v / 2 for k, v in
                                        mesh2.collectives.items()}
    if cuda:
        out["tree_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def _sub_mesh(mesh_mod, mesh):
    """The (tp, sp) groups of a dp x tp x sp mesh as a mesh of their own
    (dp 1): this rank's dp index's ranks, as a tp x sp run would group
    them. Every rank makes every singleton dp group, in order."""
    import torch.distributed as dist
    solo = None
    for r in range(dist.get_world_size()):
        g = dist.new_group([r], backend=mesh.backend)
        if r == dist.get_rank():
            solo = g
    sub = mesh_mod.Mesh(dict(mesh.shape, dp=1), dict(mesh.coords, dp=0),
                        dict(mesh.groups, dp=solo), mesh.device, mesh.backend)
    sub.all_reduce(torch.zeros(1, device=mesh.device), "dp")
    return sub


def _mesh_ranks_composed(job, dev):
    """One rank of the eight-rank run (``mesh_composed``): TinyLlama over a
    dp 2 x tp 2 x sp 2 mesh, batched retrieval on 4 rows, eagerly; then
    each dp index's (tp, sp) group alone (dp 1) on its own 2 rows, the
    arithmetic the composed run must reproduce bit for bit."""
    from triforce_tpu_torch import batched_spec as bs
    from triforce_tpu_torch import config as tc
    from triforce_tpu_torch.engine import Engine
    from triforce_tpu_torch.models import llama
    from triforce_tpu_torch.ops import flash_decode as fd
    from triforce_tpu_torch.ops import retrieval_kernel as rk
    from triforce_tpu_torch.parallel import mesh as mesh_mod
    from triforce_tpu_torch.parallel import sharding
    cfg = tc.PRESETS[job["model"]]
    dt = getattr(torch, job["dtype"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    mesh = mesh_mod.make_mesh(dp=2, tp=2, sp=2, device=dev)
    params = llama.init_params(cfg, device=dev, dtype=dt, seed=0,
                               shardings=sharding.param_shardings(mesh, cfg))
    spec = tc.SpecConfig(gamma=GAMMA, budget=job["budget"], chunk_size=8)
    prefill = len(job["prompts"][0][0])
    prompts = [torch.tensor(p, dtype=torch.int64, device=dev)
               for p in job["prompts"]]
    out = {}
    for name, m in (("composed", mesh), ("dp group", None)):
        if m is None:
            m = _sub_mesh(mesh_mod, mesh)
            blk = sharding.row_block(mesh, len(prompts))
            rows_in = [prompts[i] for i in blk]
            seeds = [job["seeds"][i] for i in blk]
        else:
            rows_in, seeds = prompts, job["seeds"]
        eng = Engine(cfg, spec, params, prefill=prefill,
                     max_cache_len=prefill + 64, dtype=dt, device=dev,
                     mesh=m, shard_seq=True, graphs=False, eos_token_id=-1)
        bat = bs.BatchedSpecEngine(eng, mode="retrieval")
        m.collectives.clear()
        _reset(fd, rk)
        t0 = time.perf_counter()
        state = bat.prefill_rows(rows_in, seeds)
        prefill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, t, ns, c, _ = bat.decode(state, COMPOSED_STEPS)
        ms = 1e3 * (time.perf_counter() - t0) / COMPOSED_STEPS
        out[name] = dict(
            tokens=[[int(x) for s in range(COMPOSED_STEPS)
                     for x in t[r, s, :ns[r, s]]] for r in range(t.shape[0])],
            counters=c.tolist(), prefill_s=prefill_s, ms_per_step=ms,
            local_rows=len(state.gens), collectives=dict(m.collectives),
            launches={k: f.launches for k, f in _wrappers(fd, rk).items()},
            pre_fwd=-(-(prefill - 1) // eng.prefill_chunk) + 1)
        del state, bat, eng
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def _mesh_counts(what, got, b1=0, b2=0, b3=0, b4=0):
    """A child's bf16 launches must be exactly what its path implies."""
    want = dict.fromkeys(COUNTERS, 0)
    want.update(b1=b1, b2=b2, b3=b3, b4=b4)
    print(f"  launches [{what}]: {got} (path implies {want})", flush=True)
    if got != want:
        _fail(f"{what}: kernel launch counts {got} != {want}")


def mesh_rank_main(job_path: str) -> int:
    """One rank of ``mesh_two_ranks`` or ``mesh_composed`` (this script as
    a child process, ``--mesh-rank``): joins the gloo group on the
    parent's card, runs its job's kind and writes what it saw."""
    from triforce_tpu_torch.parallel import mesh as mesh_mod
    import torch.distributed as dist
    with open(job_path) as f:
        job = json.load(f)
    dev = mesh_mod.init_distributed(backend="gloo", device=job["device"],
                                    timeout_s=SHARD_TIMEOUT_S)
    fn = _mesh_ranks_dp_tp if job["kind"] == "dp tp" \
        else _mesh_ranks_composed
    out = fn(job, dev)
    with open(f"{job['out']}.{dist.get_rank()}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _launch_ranks(job, n, tmp, what):
    """``n`` child processes of this script (``--mesh-rank``) on ``job``;
    their results in rank order."""
    path = os.path.join(tmp, what.replace(" ", "_") + ".job.json")
    job = dict(job, out=path[:-len(".job.json")])
    with open(path, "w") as f:
        json.dump(job, f)
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-rank", path],
        env=_rank_env(r, n, port), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SHARD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [f"rank {r} exited {p.returncode}:\n{log[-3000:]}"
           for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    if bad:
        _fail(f"{what}: " + "\n".join(bad))
    out = []
    for r in range(n):
        with open(f"{job['out']}.{r}.json") as f:
            out.append(json.load(f))
    return out, time.perf_counter() - t0


def mesh_two_ranks(tc, llama, Engine, bs, batching, dev, tmp,
                   target="LLAMA2_7B_128K", draft="LLAMA_68M",
                   prefill=SERVE_PREFILL, tree_prefill=SHARD_PREFILL,
                   budget=4096, dtype="bfloat16", rank_device="cuda:0"):
    """Two gloo ranks on the card, Llama2-7B-128K + Llama-68M bf16 at full
    width: dp 2 (``BatchedSpecEngine(mesh=)`` over a meshless graphed
    engine, 4 rows at 8192 forced 0.9, two decode calls of 4 steps; then
    ``SpecScheduler`` with 4 slots over dp 2 serving 4 requests of 16
    tokens) and tp 2 (``TreeEngine`` over a tp mesh, two forced steps at
    prefill 4096, eagerly). Every rank must return the same global tokens;
    each dp rank's rows and requests must equal, bit for bit, a meshless
    run of the same rows at the same local batch (2 rows; a 2-slot
    scheduler): a GEMM's rounding follows its row count, so 2 and 4 rows
    round apart. Per-rank peak memory printed. The other arguments cut
    the run to size (a rehearsal)."""
    tcfg, dcfg = getattr(tc, target), getattr(tc, draft)
    P, dt = prefill, getattr(torch, dtype)
    gen = torch.Generator().manual_seed(6)
    prompts = [torch.randint(0, tcfg.vocab_size, (1, P), generator=gen)
               for _ in range(ROWS)]
    seeds = list(range(ROWS))
    tree_ids = torch.randint(0, tcfg.vocab_size, (1, tree_prefill),
                             generator=gen)
    # the meshless references: each dp rank's 2 rows, a 2-slot scheduler
    tp = llama.init_params(tcfg, device=dev, dtype=dt, seed=0)
    dp = llama.init_params(dcfg, device=dev, dtype=dt, seed=1)
    headroom = bs.SpecScheduler.required_headroom(MESH_SERVE_NEW,
                                                  SERVE_SEGMENT, GAMMA)
    eng = Engine(tcfg, tc.SpecConfig(gamma=GAMMA, budget=budget,
                                     chunk_size=8),
                 tp, draft_cfg=dcfg, draft_params=dp, prefill=P,
                 max_cache_len=P + headroom, dtype=dt, device=dev,
                 eos_token_id=-1)
    half = ROWS // 2
    ref_rows = []
    for blk in (range(half), range(half, ROWS)):
        ref_rows += _rows_ref(bs, eng, [prompts[i].to(dev) for i in blk],
                              [seeds[i] for i in blk], 0.9, 2,
                              MESH_ROWS_STEPS)
    ref_serve, _, _ = _serve(bs, batching, eng, half,
                             [p.to(dev) for p in
                              prompts[:MESH_SERVE_REQUESTS]], MESH_SERVE_NEW)
    eng.release_graphs()
    del eng, tp, dp
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if dev.type == "cuda":
        print(f"mesh two ranks: the parent holds "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB before the "
              f"ranks start", flush=True)
    job = dict(kind="dp tp", prompts=[p.tolist() for p in prompts],
               seeds=seeds, tree_ids=tree_ids.tolist(), target=target,
               draft=draft, budget=budget, dtype=dtype,
               tree=[TREE_SIZE, TREE_DEPTH], device=rank_device)
    ranks, wall = _launch_ranks(job, 2, tmp, "mesh two ranks")
    for key in ("rows", "serve", "tree_tokens"):
        if ranks[0][key] != ranks[1][key]:
            _fail(f"mesh two ranks: the ranks' {key} differ")
    r0 = ranks[0]
    if r0["rows_local"] != half:
        _fail(f"mesh two ranks: a dp rank holds {r0['rows_local']} rows")
    if r0["rows"] != ref_rows:
        _fail("mesh two ranks: the dp-2 rows differ from the meshless runs "
              "of the same rows")
    if r0["serve"] != {str(k): v for k, v in ref_serve.items()} \
            or len(r0["serve"]) != MESH_SERVE_REQUESTS:
        _fail("mesh two ranks: the dp-2 scheduler's requests differ from "
              "the meshless 2-slot scheduler's")
    if torch.device(rank_device).type == "cuda":
        L = tcfg.num_layers
        for r, x in enumerate(ranks):
            # dp: each rank's meshless engine prefills its rows (B1 every
            # chunk and build, B2 every build) and decodes them (B3 every
            # batched target forward); tp: the tree over the mesh, B4
            # every attention, B2 its build
            n = x["rows_local"]
            _mesh_counts(f"mesh two ranks rank {r} rows", x["rows_launches"],
                         b1=L * n * x["pre_fwd"], b2=L * n,
                         b3=L * x["rows_target_forwards"])
            k = MESH_SERVE_REQUESTS // 2
            _mesh_counts(f"mesh two ranks rank {r} serving",
                         x["serve_launches"], b1=L * k * x["pre_fwd"],
                         b2=L * k,
                         b3=L * x["serve_stats"]["target_forwards"])
            _mesh_counts(f"mesh two ranks rank {r} tree", x["tree_launches"],
                         b2=L, b4=L * (x["tree_pre_fwd"]
                                       + 2 * (x["tree_fwd"] + 1)))
    res = dict(rows_ms_per_step=[x["rows_ms_per_step"] for x in ranks],
               serve_tokens_per_s=r0["serve_tokens_per_s"],
               serve_stats=r0["serve_stats"],
               dp_collectives=r0["dp_collectives"],
               launches={part: r0[part + "_launches"]
                         for part in ("rows", "serve", "tree")},
               dp_peak_gib=[x.get("dp_peak_gib") for x in ranks],
               tree_tokens=len(r0["tree_tokens"]),
               tree_ms_per_step=r0["tree_ms_per_step"],
               tree_collectives_per_step=r0["tree_collectives_per_step"],
               tree_peak_gib=[x.get("tree_peak_gib") for x in ranks],
               wall_s=wall)
    print(f"mesh two ranks [gloo on {rank_device}]: dp 2 rows = the "
          f"meshless runs of the same rows ({sum(map(len, ref_rows))} tokens), ms/step "
          f"(first call captures, second) {res['rows_ms_per_step'][0]}; "
          f"SpecScheduler over dp 2 = the meshless 2-slot scheduler "
          f"({MESH_SERVE_REQUESTS} requests), {res['serve_tokens_per_s']:.1f}"
          f" tokens/s; dp collectives {res['dp_collectives']}; peak "
          f"{res['dp_peak_gib']} GiB a rank; tp 2 tree: the same "
          f"{res['tree_tokens']} tokens on both ranks, "
          f"{res['tree_ms_per_step']:.1f} ms/step eagerly, collectives a "
          f"step {res['tree_collectives_per_step']}, peak "
          f"{res['tree_peak_gib']} GiB a rank; {wall:.1f} s with start-up",
          flush=True)
    return res


def mesh_composed(tc, llama, Engine, bs, dev, tmp, model=GQA_MODEL,
                  prefill=COMPOSED_PREFILL, budget=COMPOSED_BUDGET,
                  dtype="bfloat16", rank_device="cuda:0"):
    """Eight gloo ranks on the card: TinyLlama-1.1B-128K at full width and
    depth over dp 2 x tp 2 x sp 2 (2 KV heads a rank, half the slots),
    batched retrieval on 4 rows at prefill 4096 (budget 1024), 3 steps,
    eagerly. Every rank must return the same global tokens, and each dp
    index's rows must equal bit for bit what its (tp, sp) group computes
    alone on them (dp 1: the same arithmetic, without the row split and
    the gather). The meshless batched run of the same rows (graphed, this
    process) is printed beside it: split bf16 sums round apart, so its
    tokens agree up to where a near tie flips one. The other arguments
    cut the run to size (a rehearsal)."""
    cfg = tc.PRESETS[model]
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(8)
    prompts = [torch.randint(0, cfg.vocab_size, (1, prefill),
                             generator=gen) for _ in range(ROWS)]
    seeds = [11, 22, 33, 44]
    params = llama.init_params(cfg, device=dev, dtype=dt, seed=0)
    eng = Engine(cfg, tc.SpecConfig(gamma=GAMMA, budget=budget,
                                    chunk_size=8), params,
                 prefill=prefill, max_cache_len=prefill + 64, dtype=dt,
                 device=dev, eos_token_id=-1)
    bat = bs.BatchedSpecEngine(eng, mode="retrieval")
    state = bat.prefill_rows([p.to(dev) for p in prompts], seeds)
    _, t, ns, _, _ = bat.decode(state, COMPOSED_STEPS)
    meshless = [[int(x) for s in range(COMPOSED_STEPS)
                 for x in t[r, s, :ns[r, s]]] for r in range(ROWS)]
    eng.release_graphs()
    del state, bat, eng, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    job = dict(kind="composed", prompts=[p.tolist() for p in prompts],
               seeds=seeds, model=model, budget=budget, dtype=dtype,
               device=rank_device)
    ranks, wall = _launch_ranks(job, 8, tmp, "mesh composed")
    got = ranks[0]["composed"]
    for r, x in enumerate(ranks):
        if x["composed"]["tokens"] != got["tokens"] \
                or x["composed"]["counters"] != got["counters"]:
            _fail(f"mesh composed: rank {r}'s rows differ from rank 0's")
        if x["composed"]["local_rows"] != ROWS // 2:
            _fail(f"mesh composed: rank {r} holds "
                  f"{x['composed']['local_rows']} rows")
        blk = range(ROWS // 2) if r < 4 else range(ROWS // 2, ROWS)
        if [got["tokens"][i] for i in blk] != x["dp group"]["tokens"]:
            _fail(f"mesh composed: rank {r}'s dp group alone emits other "
                  f"tokens than the composed run's rows {list(blk)}")
        if torch.device(rank_device).type == "cuda":
            # the rank's 2 rows: prefills over the mesh (B4 every chunk and
            # build, B2 every build), then per step GAMMA middle verifies
            # over the heads-split retrieval cache (B3) and the outer
            # verify over the sp-split full cache (B4 a row)
            L, n = cfg.num_layers, ROWS // 2
            for part in ("composed", "dp group"):
                y = x[part]
                _mesh_counts(f"mesh composed rank {r} {part}",
                             y["launches"], b2=L * n,
                             b3=L * GAMMA * COMPOSED_STEPS,
                             b4=L * n * (y["pre_fwd"] + COMPOSED_STEPS))
    same = [_common_prefix(a, b) for a, b in zip(got["tokens"], meshless)]
    res = dict(tokens=[len(x) for x in got["tokens"]],
               tokens_equal_meshless=same, prefill_s=got["prefill_s"],
               ms_per_step=got["ms_per_step"],
               dp_group_ms_per_step=ranks[0]["dp group"]["ms_per_step"],
               collectives=got["collectives"],
               launches={"composed": got["launches"],
                         "dp group": ranks[0]["dp group"]["launches"]},
               peak_gib=[x.get("peak_gib") for x in ranks], wall_s=wall)
    print(f"mesh composed [dp 2 x tp 2 x sp 2, 8 gloo ranks on "
          f"{rank_device}, eager]: every rank returned the same {sum(res['tokens'])} "
          f"tokens of {ROWS} rows, each dp index's rows = its (tp, sp) "
          f"group's run alone, bit for bit; the first {same} tokens of each "
          f"row equal the meshless run's; prefill {got['prefill_s']:.1f} s "
          f"(2 rows a group), {got['ms_per_step']:.1f} ms/step (group "
          f"alone {res['dp_group_ms_per_step']:.1f}); collectives "
          f"{got['collectives']}; peak {res['peak_gib']} GiB a rank; "
          f"{wall:.1f} s with start-up", flush=True)
    return res


def kernel_shards(fd, att, rk, rt, cache_mod, dev, prefill):
    """B4 and B2 alone at the shapes a rank's shard gives them (sp = 2;
    tp = 2 of Llama2-7B's 32 heads), at the shard of every prompt this
    script runs over a mesh: ``prefill`` (the kernel phase's), E2E_PREFILL
    (the world-1 runs') and, for the verify and the prefill chunk alone,
    SHARD_PREFILL (the two-rank runs'). B4 at the verify (GT 8), at the
    prefill chunk (GT 512; TinyLlama's G 8 x 512 = 4096 at D = 64) and over
    an empty shard (local k_len 0), B2 over P / sp; then B1 and B1-int8 at
    the world-1 prefill's chunk over half of E2E_PREFILL (its 17th
    512-token chunk, whose attention over a mesh is B4 over those keys
    merged with the chunk): each against its plain version with device
    time and bound."""
    out = {quant: dict(b4=[], b2=[], b1=[]) for quant in (False, True)}
    t_all = time.perf_counter()
    for s_loc in sorted({prefill // 2, E2E_PREFILL // 2}, reverse=True):
        t0 = time.perf_counter()
        for quant in (False, True):
            out[quant]["b4"] += [
                kernel_b4(fd, att, cache_mod, dev, GAMMA + 2, s_loc,
                          s_loc + 64, quant=quant, hkv=16),
                kernel_b4(fd, att, cache_mod, dev, 512, s_loc, s_loc + 512,
                          quant=quant),
                kernel_b4(fd, att, cache_mod, dev, 4096, s_loc, s_loc + 512,
                          quant=quant, hkv=4, d=64, tn=512),
                kernel_b4(fd, att, cache_mod, dev, GAMMA + 2, 0, s_loc,
                          quant=quant, hkv=16)]
            out[quant]["b2"].append(kernel_b2(rk, rt, cache_mod, dev, s_loc,
                                              8, 4096, s_loc + 64,
                                              quant=quant))
        print(f"kernel shards [{s_loc} keys]: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    s_loc = SHARD_PREFILL // 2
    for quant in (False, True):
        out[quant]["b4"] += [
            kernel_b4(fd, att, cache_mod, dev, GAMMA + 2, s_loc, s_loc + 64,
                      quant=quant, hkv=16),
            kernel_b4(fd, att, cache_mod, dev, 512, s_loc, s_loc + 512,
                      quant=quant)]
    keys = E2E_PREFILL // 2
    for quant in (False, True):
        out[quant]["b1"].append(kernel_b1(fd, cache_mod, dev, 512, 512, keys,
                                          keys + 512, quant=quant))
    print(f"kernel shards [{s_loc} keys: verify and chunk; B1 at {keys} "
          f"keys, GT 512]: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"kernel shards: {time.perf_counter() - t_all:.1f} s", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--prefill", type=int, default=32768)
    ap.add_argument("--skip-e2e", action="store_true",
                    help="stop after the kernel, reference and tree-gate "
                    "phases")
    ap.add_argument("--ab", metavar="TAG",
                    help="only time the kernels at the decode and wide "
                    "shapes (kernel_ab) and print one 'AB TAG {...}' line")
    ap.add_argument("--study", action="store_true",
                    help="only run the kernel study (kernel_study) and "
                    "print its JSON line")
    ap.add_argument("--gqa", action="store_true",
                    help="only the GQA phase: the kernels at "
                    "tinyllama-1.1b-128k's shapes, its reference check and "
                    "the command line end to end")
    ap.add_argument("--mesh", action="store_true",
                    help="only the rest of the mesh: B4 and B3 at its "
                    "shapes, the tree over a world-1 mesh, the dp / tp "
                    "two-rank and the composed eight-rank runs")
    ap.add_argument("--moe-window", action="store_true",
                    help="only the hybrid path's kernel gate "
                    "(kernel_moe_window): the router, the expert kernel and "
                    "B1's window kernel at Mellum2-12B-A2.5B's widths")
    ap.add_argument("--shard-rank", metavar="JOB",
                    help="run one rank of the sharded phase's two-rank runs "
                    "(started by this script)")
    ap.add_argument("--mesh-rank", metavar="JOB",
                    help="run one rank of the mesh phase's dp / tp and "
                    "composed runs (started by this script)")
    args = ap.parse_args()

    if args.shard_rank:
        return shard_rank_main(args.shard_rank)
    if args.mesh_rank:
        return mesh_rank_main(args.mesh_rank)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from triforce_tpu_torch import _build, config as tc, cache
        from triforce_tpu_torch import batched_spec, batching, decoding
        from triforce_tpu_torch import cli, data, profiling
        from triforce_tpu_torch.engine import Engine
        from triforce_tpu_torch.models import ckpt, hf, llama
        from triforce_tpu_torch.models import rope as rope_mod
        from triforce_tpu_torch.ops import layer_glue, moe
        from triforce_tpu_torch.tree import planner, spectree
        from triforce_tpu_torch.ops import attention as att
        from triforce_tpu_torch.ops import flash_decode as fd
        from triforce_tpu_torch.ops import retrieval as rt
        from triforce_tpu_torch.ops import retrieval_kernel as rk
        from triforce_tpu_torch.parallel import mesh as mesh_mod
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
                for ln in log.splitlines() if "Used " in ln and "registers" in ln]
        spills = sum(" 0 bytes spill stores" not in ln
                     for ln in log.splitlines() if "spill stores" in ln)
        print(f"  ptxas [{name}]: {len(regs)} kernels, registers "
              f"{sorted(set(regs))}, {spills} with spills", flush=True)
    gm = _grow_map(planner)
    if args.moe_window:
        kmw = kernel_moe_window(moe, fd, dev)
        print(json.dumps({"kernels_moe_window": kmw}), flush=True)
        torch.cuda.empty_cache()
        _stamp("hybrid end to end")
        hyb = hybrid_end_to_end(tc, Engine, llama, fd, rk, dev)
        print("hybrid end to end: " + json.dumps(hyb), flush=True)
        print(json.dumps({"kernels": hybrid_entries(kmw, hyb)}), flush=True)
        return 0
    if args.ab:
        print(f"AB {args.ab} " + json.dumps(kernel_ab(
            fd, att, rk, rt, cache, dev, args.prefill, gm.mask)), flush=True)
        return 0

    def gqa_gates():
        return gqa_kernel_gates(tc, fd, att, rk, rt, cache, planner,
                                spectree, batched_spec, dev)

    def references(model):
        return {name: reference_check(tc, llama, cache, rt, fd, dev,
                                      quant=quant, model=model)
                for name, quant in (("bf16", False), ("int8", True))}

    def cli_run():
        """The command line end to end at TinyLlama-1.1B-128K widths."""
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="triforce_cli_") as tmp:
            res = cli_phase(tc, llama, Engine, cli, hf, ckpt, data, decoding,
                            profiling, planner, spectree, batched_spec, fd,
                            rk, dev, tmp)
        res["phase_s"] = time.perf_counter() - t0
        print(f"cli phase: {res['phase_s']:.1f} s; " + json.dumps(res),
              flush=True)
        torch.cuda.empty_cache()
        return res

    if args.gqa:
        gqa_gates()
        print(json.dumps({"reference": {GQA_MODEL: references(GQA_MODEL)}}),
              flush=True)
        cli_run()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    prefill = args.prefill
    s_kv = prefill + GEN + 4 * (GAMMA + 2)
    s_rkv = 4096 + TREE_SIZE + spectree._padded_levels(gm)[0]
    w_pad = spectree._padded_levels(gm)[0]      # the padded level width
    s_tree = prefill + TREE_GEN + TREE_FORCED_GEN + 4 * TREE_SIZE \
        + TREE_SIZE + w_pad
    if args.mesh:
        _stamp("kernel mesh shapes")
        kernel_mesh_shapes(fd, att, cache, dev, prefill, s_tree, s_rkv,
                           w_pad)
        for name, quant in (("bf16", False), ("int8", True)):
            _stamp(f"tree mesh world 1 [{name}]")
            tp = llama.init_params(tc.LLAMA2_7B_128K, device=dev,
                                   dtype=torch.bfloat16, seed=0)
            if quant:
                tp = llama.quantize_weights(tp)
            mesh = mesh_mod.single_device_mesh(dev)
            print(json.dumps(tree_mesh_world1(
                tc, llama, planner, spectree, mesh, fd, rk, dev, tp,
                TREE_MESH_PREFILL, quant)), flush=True)
            torch.distributed.destroy_process_group()
            del tp
            torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="triforce_mesh_") as tmp:
            _stamp("mesh two ranks")
            print(json.dumps(mesh_two_ranks(tc, llama, Engine, batched_spec,
                                            batching, dev, tmp)), flush=True)
            _stamp("mesh composed")
            print(json.dumps(mesh_composed(tc, llama, Engine, batched_spec,
                                           dev, tmp)), flush=True)
        _stamp("end")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.study:
        print(json.dumps({"kernel_study": kernel_study(
            fd, rk, cache, dev, prefill, s_kv, s_rkv, gm.mask)}), flush=True)
        return 0
    _stamp("kernel phase")
    shapes = [(1, 1, prefill, s_kv),                     # AR decode
              (GAMMA + 2, GAMMA + 2, prefill, s_kv),     # full-cache verify
              (GAMMA + 1, GAMMA + 1, 4096, 4096 + GAMMA + 1),  # middle
              (512, 512, min(16384, prefill), s_kv)]     # prefill tile
    b1 = {quant: [kernel_b1(fd, cache, dev, *sh, quant=quant)
                  for sh in shapes] for quant in (False, True)}
    # the decode path's edges: a k_len that is not a whole number of 64-key
    # tiles, one shorter than a tile, GT = 16 (the last decode shape) and
    # 17 (the first wide one), and a GQA decode row at D = 64 with
    # tinyllama-1.1b-128k's widths (4 KV heads, G = 8, Tn = 1); the wide
    # path's widest tile, that model's 512-token prefill chunk (GT 4096)
    edges = [dict(gt=1, tn=1, k_len=4133, s=4200),
             dict(gt=1, tn=1, k_len=37, s=64),
             dict(gt=16, tn=16, k_len=4096, s=4112),
             dict(gt=17, tn=17, k_len=4096, s=4113),
             dict(gt=8, tn=1, k_len=prefill, s=s_kv, hkv=4, d=64),
             # a GQA prefill tile of the same model: G 8 x T 512 rows
             dict(gt=4096, tn=512, k_len=min(16384, prefill),
                  s=min(16384, prefill) + 512, hkv=4, d=64)]
    for quant in (False, True):
        b1[quant] += [kernel_b1(fd, cache, dev, quant=quant, **e)
                      for e in edges]
    # the tree verify: B1 at GT = Tn = tree size under the ancestor mask
    # (the path's 128-node tree, and a 512-node one: the widest q tile)
    pv = planner.modeled_acceptance_vector(0.8, 4)
    gm512 = planner.build_grow_map(*planner.plan_tree(pv, 512, 16), 512, 16)
    for quant in (False, True):
        b1[quant] += [
            kernel_b1(fd, cache, dev, TREE_SIZE, TREE_SIZE, prefill, s_tree,
                      quant=quant, tree_mask=gm.mask),
            kernel_b1(fd, cache, dev, 512, 512, min(16384, prefill), s_tree,
                      quant=quant, tree_mask=gm512.mask)]
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
    # B4 at the tree grow's shapes: a padded level (W rows, 22 here) and the
    # root (1 row) over the 4096-slot budget region of the tree retrieval
    # cache; a level over the full cache (the ssl layers; also one card's
    # share of a sequence-parallel decode); an empty prefix
    shapes4 = [(w_pad, 4096, s_rkv), (1, 4096, s_rkv),
               (w_pad, prefill, s_tree), (w_pad, 0, s_rkv)]
    b4 = {quant: [kernel_b4(fd, att, cache, dev, *sh, quant=quant)
                  for sh in shapes4] for quant in (False, True)}
    # B4 and B2 at a rank's shard of the sharded phase
    _stamp("kernel shards")
    shards = kernel_shards(fd, att, rk, rt, cache, dev, prefill)
    for quant in (False, True):
        b4[quant] += shards[quant]["b4"]
        b1[quant] += shards[quant]["b1"]
    # B4 and B3 at the rest of the mesh's shapes
    _stamp("kernel mesh shapes")
    mshapes = kernel_mesh_shapes(fd, att, cache, dev, prefill, s_tree, s_rkv,
                                 w_pad)
    for quant in (False, True):
        b4[quant] += mshapes[quant]["b4"]
        b3[quant] += mshapes[quant]["b3"]
    # the layer glue at the main path's shapes
    _stamp("glue kernel gates")
    glue = kernel_glue(layer_glue, tc, rope_mod, cache, dev)
    # the hybrid path's experts and window kernel at Mellum2's widths
    _stamp("moe and window kernel gates")
    kmw = kernel_moe_window(moe, fd, dev)
    print(json.dumps({"kernels_moe_window": kmw}), flush=True)
    torch.cuda.empty_cache()
    # every kernel at the GQA model's shapes (the cli phase's run)
    _stamp("GQA kernel gates")
    gates = gqa_gates()
    for quant in (False, True):
        b1[quant] += gates[quant]["b1"]
        b3[quant].append(gates[quant]["b3"])
        b4[quant] += gates[quant]["b4"]
    _stamp("kernel study")
    study = kernel_study(fd, rk, cache, dev, prefill, s_kv, s_rkv, gm.mask)
    study["pdl"] = pdl_study(fd, cache, dev, prefill, s_kv, s_tree, gm.mask)
    int8_gemm_probe(llama, dev)
    torch.cuda.empty_cache()
    _stamp("reference phase")
    ref = {model: references(model) for model in ("llama2-7b-128k",
                                                  GQA_MODEL)}

    # launches of each kernel in its own path's decoding.triforce run
    main_path = dict.fromkeys(COUNTERS + GLUE_COUNTERS)
    by_phase = {}
    hyb = None
    _stamp("tree gate")
    gate = {name: tree_gate(tc, llama, planner, spectree, dev, quant)
            for name, quant in (("bf16", False), ("int8", True))}
    print(json.dumps({"tree_gate": gate}), flush=True)
    torch.cuda.empty_cache()
    if not args.skip_e2e:
        _stamp("rows equal batch 1")
        rows_eq = {name: rows_equal_batch1(tc, llama, Engine, batched_spec,
                                           dev, quant)
                   for name, quant in (("bf16", False), ("int8", True))}
        print(json.dumps({"rows_equal_batch1": rows_eq}), flush=True)
        torch.cuda.empty_cache()
        # the mesh's ranks share the card: they run while this process
        # holds little of it (the later phases leave several GiB behind)
        _stamp("mesh two ranks")
        with tempfile.TemporaryDirectory(prefix="triforce_mesh_") as tmp:
            mesh2 = mesh_two_ranks(tc, llama, Engine, batched_spec, batching,
                                   dev, tmp)
        print("mesh two ranks: " + json.dumps(mesh2), flush=True)
        torch.cuda.empty_cache()
        _stamp("mesh composed")
        with tempfile.TemporaryDirectory(prefix="triforce_mesh_") as tmp:
            composed = mesh_composed(tc, llama, Engine, batched_spec, dev,
                                     tmp)
        print("mesh composed: " + json.dumps(composed), flush=True)
        torch.cuda.empty_cache()
        e2e, bat_e2e, tree_e2e, mesh1, tree_mesh1 = {}, {}, {}, {}, {}
        e2e_prefill = min(prefill, E2E_PREFILL)
        tcfg, dcfg = tc.LLAMA2_7B_128K, tc.LLAMA_68M
        spec = tc.SpecConfig(gamma=GAMMA, budget=4096, chunk_size=8)
        for name, quant in (("bf16", False), ("int8", True)):
            t0 = time.perf_counter()
            tp = llama.init_params(tcfg, device=dev, dtype=torch.bfloat16,
                                   seed=0)
            dp = llama.init_params(dcfg, device=dev, dtype=torch.bfloat16,
                                   seed=1)
            eng = Engine(tcfg, spec, tp, draft_cfg=dcfg, draft_params=dp,
                         prefill=e2e_prefill,
                         max_cache_len=e2e_prefill + GEN + 4 * (GAMMA + 2),
                         dtype=torch.bfloat16, device=dev, kv_quant=quant,
                         weight_quant=quant)
            if quant:    # the batched phase runs the same int8 weights
                tp, dp = eng.t_params, eng.d_params
            torch.cuda.synchronize()
            print(f"{'int8 ' if quant else ''}weights: "
                  f"{time.perf_counter() - t0:.1f} s to make random weights "
                  f"on the card{' and quantize them' if quant else ''}",
                  flush=True)
            _stamp(f"end to end [{name}]")
            e2e[name] = end_to_end(tc, decoding, llama, eng, fd, rk, dev,
                                   e2e_prefill, quant)
            del eng
            torch.cuda.empty_cache()
            # the batch-1 TriForce run counts B1 and B2, the batched phases
            # (rows speculating, then both schedulers) B3
            b12 = ("b1_int8", "b2_int8") if quant else ("b1", "b2")
            for k in b12:
                main_path[k] = e2e[name]["launches"]["triforce"][k]
            # the glue runs in both precisions (bf16 activations either way)
            pre = "int8 " if quant else ""
            for k in GLUE_COUNTERS:
                if not quant:
                    main_path[k] = e2e[name]["glue_launches"]["triforce"][k]
                by_phase.setdefault(k, {}).update(
                    {pre + ph: v[k]
                     for ph, v in e2e[name]["glue_launches"].items()})
            print(f"end to end [{name}]: " + json.dumps(e2e[name]),
                  flush=True)
            _stamp(f"sharded world 1 [{name}]")
            # a world of one rank, NCCL on this card, for this phase alone
            mesh = mesh_mod.single_device_mesh(dev)
            mesh1[name] = sharded_world1(tc, llama, Engine, mesh, fd, rk,
                                         dev, e2e_prefill, quant, tp, dp,
                                         e2e[name]["graphs"])
            torch.distributed.destroy_process_group()
            torch.cuda.empty_cache()
            print(f"sharded world 1 [{name}]: " + json.dumps(mesh1[name]),
                  flush=True)
            _stamp(f"tree end to end [{name}]")
            tree_e2e[name] = tree_end_to_end(tc, planner, spectree, fd, rk,
                                             dev, tp, e2e_prefill, quant)
            torch.cuda.empty_cache()
            print(f"tree end to end [{name}]: " + json.dumps(tree_e2e[name]),
                  flush=True)
            _stamp(f"tree mesh world 1 [{name}]")
            mesh = mesh_mod.single_device_mesh(dev)
            tree_mesh1[name] = tree_mesh_world1(
                tc, llama, planner, spectree, mesh, fd, rk, dev, tp,
                TREE_MESH_PREFILL, quant)
            torch.distributed.destroy_process_group()
            torch.cuda.empty_cache()
            print(f"tree mesh world 1 [{name}]: "
                  + json.dumps(tree_mesh1[name]), flush=True)
            _stamp(f"batched end to end [{name}]")
            bat_e2e[name] = batched_end_to_end(
                tc, llama, Engine, batched_spec, batching, fd, rk, dev, tp,
                dp, quant)
            del tp, dp
            torch.cuda.empty_cache()
            k3 = "b3_int8" if quant else "b3"
            k4 = "b4_int8" if quant else "b4"
            lb = bat_e2e[name]["launches"]
            lt = tree_e2e[name]["launches"]
            main_path[k3] = lb["batched triforce"][k3] \
                + lb["spec serving"][k3]
            main_path[k4] = lt["tree_decode"][k4]
            for k in b12 + (k3, k4):
                by_phase[k] = {ph: v[k] for ph, v in
                               {**e2e[name]["launches"], **lt, **lb}.items()}
            for k in (k4, b12[1]):
                by_phase[k]["mesh world 1 (triforce, forced, ar)"] = \
                    mesh1[name]["launches"][k]
                for what, lc in tree_mesh1[name]["launches"].items():
                    by_phase[k][f"tree mesh world 1 ({what})"] = lc[k]
            print(f"batched end to end [{name}]: " + json.dumps(bat_e2e[name]),
                  flush=True)
        by_phase["b3"]["ar_serving_int8_weights"] = \
            bat_e2e["int8"]["launches"]["ar_serving"]["b3"]
        _stamp("sharded two ranks")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="triforce_ranks_") as tmp:
            two = sharded_two_ranks(tc, llama, Engine, fd, rk, dev, tmp,
                                    layers=SHARD_LAYERS)
        print(f"sharded two ranks: {time.perf_counter() - t0:.1f} s; "
              + json.dumps(two), flush=True)
        for run, r in two.items():
            for k in ("b4", "b2"):
                by_phase[k][f"two ranks {run} (rank 0)"] = r["launches"][k]
        torch.cuda.empty_cache()
        for name, r in (("mesh two ranks", mesh2), ("mesh composed",
                                                     composed)):
            for part, lc in r["launches"].items():
                for k, n in lc.items():
                    if n:
                        by_phase.setdefault(k, {})[
                            f"{name} {part} (rank 0)"] = n
        _stamp("hybrid end to end")
        hyb = hybrid_end_to_end(tc, Engine, llama, fd, rk, dev)
        print("hybrid end to end: " + json.dumps(hyb), flush=True)
        _stamp("cli phase")
        for tag, got in cli_run()["launches"].items():
            for k, n in got.items():
                if n:
                    by_phase.setdefault(k, {})["cli " + tag] = n

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
                    max_abs_err=max(x["max_abs_err"] for x in [
                        r, gates[quant]["b2"], *shards[quant]["b2"]]),
                    ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"],
                    shapes=[r, gates[quant]["b2"], *shards[quant]["b2"]])

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

    def b4_entry(name, source_fn, quant):
        main = b4[quant][0]   # a padded grow level over the budget region
        key = "b4_int8" if quant else "b4"
        return dict(name=name, route="cuda",
                    source="triforce_tpu_torch/csrc/flash_decode.cu",
                    entry_point=source_fn,
                    replaces="triforce_tpu/ops/flash_decode.py:233"
                    + (" (quant branch)" if quant else ""),
                    launches=main_path[key],
                    launches_by_phase=by_phase.get(key),
                    max_abs_err=max(r["max_abs_err"] for r in b4[quant]),
                    ms=main["ms"], plain_ms=main["plain_ms"],
                    bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                    library_ms=main["library_ms"], shapes=b4[quant])

    def glue_entry(name, source_fn, main, replaces):
        rows = glue[name]
        return dict(name=name, route="cuda",
                    source="triforce_tpu_torch/csrc/layer_glue.cu",
                    entry_point=source_fn, replaces=replaces,
                    launches=main_path[name],
                    launches_by_phase=by_phase.get(name),
                    max_abs_err=max(r["max_abs_err"] for r in rows),
                    ms=rows[main]["ms"], plain_ms=rows[main]["plain_ms"],
                    bound_ms=rows[main]["bound_ms"],
                    bound_by=rows[main]["bound_by"],
                    library_ms=rows[main]["library_ms"], shapes=rows)

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
        b4_entry("flash_decode_partials", "tf_flash_decode_partials_bf16",
                 False),
        b4_entry("flash_decode_partials_int8",
                 "tf_flash_decode_partials_int8", True),
        # main shapes: a middle verify's 7 rows at 4096 (with y), its q
        # and k at 7 tokens, its 7 rows of the MLP
        glue_entry("add_rms_norm", "tf_add_rms_norm", 1,
                   "triforce_tpu/models/llama.py:89 (XLA-fused there)"),
        glue_entry("rope", "tf_rope", 0,
                   "triforce_tpu/models/rope.py:141 (XLA-fused there)"),
        glue_entry("silu_mul", "tf_silu_mul", 0,
                   "triforce_tpu/models/llama.py:138 (XLA-fused there)"),
    ] + (hybrid_entries(kmw, hyb) if hyb is not None else [])
    _stamp("end")
    print(json.dumps({"reference": ref}), flush=True)
    print(json.dumps({"kernel_study": study}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
