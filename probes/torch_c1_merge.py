#!/usr/bin/env python3
"""Take apart B4-int8's merge check at a rank's shard shapes, on one card.

    python3 probes/torch_c1_merge.py [--k-lens 8192 16384] [--seed 0]

``chip_smoke.py``'s B4-int8 gate merges the partials kernel's
(m, l, acc) with a new block. It held the result against B1-int8 on the
same inputs, and that missed ``INT8_B1_TOL / sqrt(k_len + Tn)`` at GT 512
over 8192 keys (ROADMAP C item 2); it now holds it against the same merge
of the plain partials. At each shard shape (the verify, GT 8 over 16
heads; the prefill chunk, GT 512; TinyLlama's GT 4096 at D 64 with Tn
512), made as that gate makes its inputs, this prints one JSON line with:

- ``gate``: merge(B4-int8, new block with q'') against B1-int8, the
  comparison the gate made before, beside ``tol`` = ``INT8_B1_TOL /
  sqrt(k_len + Tn)``;
- ``e1``: B4-int8 against ``flash_decode_partials_int8_plain``
  (normalised acc / l), beside ``INT8_B1_TOL / sqrt(k_len)``;
- ``e2``: B1-int8 against ``flash_decode_append_int8_plain`` at
  ``KERNEL_GROUP``;
- ``e3``: merge(plain B4-int8, new block) against plain B1-int8: no
  kernel involved;
- ``merge_kernel_vs_plain``: merge(B4-int8) against merge(plain B4-int8),
  the same new block on both sides;
- ``e4``: each of merge(B4-int8), merge(plain), B1-int8 and plain B1-int8
  against two fp64 folds of the plain cache part: ``b1_frame`` rounds the
  new block's p to bf16 against the row's final maximum (B1's fold),
  ``merge_frame`` against the new block's own maximum (what
  ``new_block_partials`` + ``merge_partials`` do);
- the launch plan (nsplit, partials a row, CTA rows).

Then B1-int8 through ``chip_smoke.kernel_b1`` at the prefill chunk over
each ``--k-lens`` value, whose gate is recorded, not enforced.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def shard_inputs(cache_mod, dev, gt, k_len, s, hkv, d, tn, seed):
    """The inputs ``chip_smoke.kernel_b4`` makes at one shape (the same
    generator calls in the same order), int8 cache."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    q, kn, vn = rn(hkv, gt, d), rn(hkv, tn, d), rn(hkv, tn, d)
    k_st, v_st = rn(2, 1, hkv, s, d), rn(2, 1, hkv, s, d)
    k_st[1, 0, :, k_len:] = 50.0
    v_st[1, 0, :, k_len:] = 50.0
    mask = torch.rand((gt, tn), generator=g, device=dev) < 0.6
    mask[:, 0] = True
    (k8, ks), (v8, vs) = (cache_mod.quantize_tokens(x) for x in (k_st, v_st))
    return dict(q=q, kn=kn, vn=vn, k=k8[1, 0], v=v8[1, 0], ks=ks[1, 0],
                vs=vs[1, 0], mask=mask,
                klen=torch.tensor(k_len, dtype=torch.int32, device=dev))


def fp64_folds(fd, x, part, qn):
    """Both fp64 folds of the new block into the plain cache part ``part``
    (m, l [Hkv, GT], acc [Hkv, GT, D]) with the new block's query ``qn``:
    (B1's frame, the merge's frame), each [Hkv, GT, D] fp64."""
    m, l, acc = (t.double() for t in part)
    m, l = m[..., None], l[..., None]
    bias = torch.where(x["mask"], 0.0, -1e30).double()
    sn = torch.einsum("hgd,hnd->hgn", qn.double(), x["kn"].double()) + bias
    vn = x["vn"].double()

    def pv(p):
        return torch.einsum("hgn,hnd->hgd",
                            p.to(torch.bfloat16).double(), vn)

    mf = torch.maximum(m, sn.amax(-1, keepdim=True))
    pn = torch.exp(sn - mf)
    a = torch.exp(m - mf)
    b1_frame = (acc * a + pv(pn)) / (l * a + pn.sum(-1, keepdim=True))
    mb = sn.amax(-1, keepdim=True)
    pb = torch.exp(sn - mb)
    wc, wn = torch.exp(m - mf), torch.exp(mb - mf)
    merge_frame = (acc * wc + pv(pb) * wn) \
        / (l * wc + pb.sum(-1, keepdim=True) * wn)
    return b1_frame, merge_frame


def decompose(fd, att, cache_mod, dev, gt, k_len, s, hkv, d, tn, seed):
    x = shard_inputs(cache_mod, dev, gt, k_len, s, hkv, d, tn, seed)
    q, k, v, ks, vs, kl = (x[n] for n in ("q", "k", "v", "ks", "vs", "klen"))
    kern = fd.flash_decode_partials_int8(q, k, v, kl, ks, vs)
    plain = fd.flash_decode_partials_int8_plain(q, k, v, kl, ks, vs,
                                                group=fd.KERNEL_GROUP)
    b1k = fd.flash_decode_append_int8(q, k, v, x["kn"], x["vn"], kl,
                                      x["mask"], ks, vs)
    b1p = fd.flash_decode_append_int8_plain(q, k, v, x["kn"], x["vn"], kl,
                                            x["mask"], ks, vs,
                                            group=fd.KERNEL_GROUP)
    bf = torch.bfloat16
    qf = (q.float() * fd._scale(d)).to(bf).float()
    q8, qs = fd._quantize_rows(qf)
    qn = (q8 * qs).to(bf)
    pn = att._update(qn.reshape(1, hkv, 1, gt, d),
                     *att._init_partials(q[None], hkv), x["kn"][None],
                     x["vn"][None], x["mask"])

    def merged(p):
        m, l, acc = p
        part = (m.reshape(1, hkv, 1, gt), l.reshape(1, hkv, 1, gt),
                acc.reshape(1, hkv, 1, gt, d))
        return att.finalize(att.merge_partials(part, pn), torch.float32)[0]

    mk, mp = merged(kern), merged(plain)
    torch.cuda.synchronize()

    def dist(a, b):
        return (a.double() - b.double()).abs().max().item()

    tol = cs.INT8_B1_TOL / (k_len + tn) ** 0.5
    e1 = dist(kern[2] / kern[1][..., None], plain[2] / plain[1][..., None]) \
        if k_len else 0.0
    b1w, mw = fp64_folds(fd, x, plain, qn)
    nsplit, parts = fd._plan(q, s, True)
    res = dict(
        gt=gt, hkv=hkv, d=d, tn=tn, k_len=k_len, s=s, seed=seed,
        nsplit=nsplit, parts=parts,
        cta_rows=fd._cta_rows(gt) if gt > fd.DECODE_ROWS else 1,
        tol=tol, tol_e1=cs.INT8_B1_TOL / max(k_len, 1) ** 0.5,
        gate=dist(mk, b1k), e1=e1, e2=dist(b1k, b1p), e3=dist(mp, b1p),
        merge_kernel_vs_plain=dist(mk, mp),
        e4={name: dict(b1_frame=dist(out, b1w), merge_frame=dist(out, mw))
            for name, out in (("merge_kernel", mk), ("merge_plain", mp),
                              ("b1_kernel", b1k), ("b1_plain", b1p))},
        frames_apart=dist(b1w, mw))
    res["gate_over_tol"] = res["gate"] / tol
    res["e3_over_tol"] = res["e3"] / tol
    print("c1 " + json.dumps(res), flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k-lens", type=int, nargs="+", default=[8192, 16384])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from triforce_tpu_torch import _build, cache
    from triforce_tpu_torch.ops import attention as att
    from triforce_tpu_torch.ops import flash_decode as fd
    dev = torch.device("cuda")
    print("device:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), torch.__version__, torch.version.cuda, flush=True)
    _build.build()
    for k_len in args.k_lens:
        # chip_smoke.kernel_shards' shapes over a k_len-key shard
        for gt, s, hkv, d, tn in ((cs.GAMMA + 2, k_len + 64, 16, 128,
                                   cs.GAMMA + 2),
                                  (512, k_len + 512, 32, 128, 512),
                                  (4096, k_len + 512, 4, 64, 512)):
            decompose(fd, att, cache, dev, gt, k_len, s, hkv, d, tn,
                      args.seed)
            torch.cuda.empty_cache()
    for k_len in args.k_lens:
        try:
            cs.kernel_b1(fd, cache, dev, 512, 512, k_len, k_len + 512 + 64,
                         quant=True)
            print(f"c1 B1-int8 (512, 512, {k_len}): meets its gate",
                  flush=True)
        except SystemExit:
            print(f"c1 B1-int8 (512, 512, {k_len}): misses its gate",
                  flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
