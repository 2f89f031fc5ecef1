"""What decides ``correct``: the program's caches held against the float32
reference (``model.py``) recomputed from the same weights and tokens.

Under forced acceptance the tokens a step emits are coin flips over the
drafter's and the middle model's proposals, not draws from the target, so
no single token can be judged by its logit. What the timed path must get
right is the state it leaves: every token it emitted was run through the
target and cached. So the judge recomputes, for the exact token sequence
the program reports, what each cache must hold, and reads:

  kv_len_gap  cached positions against tokens reported (exact: 0).
  kv_err      the worst position of any layer's K or V in the full cache:
              the norm of its error over all KV heads, over the layer's
              RMS norm of such a vector. Past layer 0 every key and value
              is made from the attention outputs of the layers below it,
              so this covers the chunked prefill's attention, the build
              token, every target verify's attention (B1 at batch 1, B3
              over rows), its commit and rollback, and every token's
              identity.
  rkv_err     the worst slot of any layer's K or V in the retrieval cache:
              each selected chunk against the reference's values of the
              chunk it holds (matched by its mean key), each refreshed
              tail slot against its generated position: the build's
              gather and the tail refresh.
  build_gap   how far the weakest selected chunk's reference score lies
              below the reference's own selection threshold, in standard
              deviations of that head's scores (a repeated chunk, or a
              first group that is not chunk 0, reads 99): the build's
              scoring and top-k (B2) at every layer.

The cell's file names the readings compared and their limits. The
reference imports nothing of the program; it reads the program's caches
only to judge them.
"""

from __future__ import annotations

import math

import torch

from . import model

BAD = 99.0


def _pos_err(ref, prog, rms):
    """Worst position: ref [T, H, D] float32, prog [H, T, D] -> float."""
    diff = (prog - ref.transpose(0, 1)).pow_(2).sum(dim=(0, 2)).sqrt_()
    return float(diff.max()) / rms


def _rms(ref, dims):
    return float(ref.pow(2).sum(dim=dims).mean().sqrt())


class Judge:
    """Collects the readings while the reference forward runs.

    ``prog`` gives the program's caches, float32 on the card:
      ``kv(li)``    -> (k, v) [Hkv, L, D] of the full cache, L its length;
      ``build(li)`` -> (k, v) [Hkv, budget, D]: the retrieval cache's
                       budget region as the build left it (or as it is at
                       the close, where ``build_groups`` counts the
                       chunk groups the tail has not yet overwritten);
      ``rkv(li)``   -> (k, v) [Hkv, budget, D] at the close;
    and the ints ``length`` (L), ``prompt``, ``budget``, ``chunk``,
    ``build_groups``."""

    def __init__(self, cfg: dict, prog):
        self.cfg, self.prog = cfg, prog
        self.read = dict(kv_err=0.0, rkv_err=0.0, build_gap=0.0)

    def _up(self, key, value):
        if not value <= self.read[key]:          # NaN sticks
            self.read[key] = value

    def layer(self, li, q, k, v):
        p = self.prog
        pk, pv = p.kv(li)
        rms_tok = (_rms(k, (1, 2)), _rms(v, (1, 2)))
        self._up("kv_err", _pos_err(k, pk, rms_tok[0]))
        self._up("kv_err", _pos_err(v, pv, rms_tok[1]))
        del pk, pv
        rms_vec = (_rms(k, (2,)), _rms(v, (2,)))
        self._build(li, q, k, v, rms_vec)
        self._tail(li, k, v, rms_vec)

    def _build(self, li, q, k, v, rms_vec):
        p, cfg = self.prog, self.cfg
        n = p.build_groups
        if n <= 0:
            return
        c, pl = p.chunk, p.prompt
        hkv, d = k.shape[1], k.shape[2]
        g = cfg["num_attention_heads"] // hkv
        sets = p.budget // c
        cm_k = k[:pl].view(pl // c, c, hkv, d).mean(1).transpose(0, 1)
        qg = q[pl - 1].view(hkv, g, d)
        scores = torch.einsum("hgd,hcd->hc", qg, cm_k) / g   # [Hkv, C]
        thr = torch.topk(scores[:, 1:], sets - 1, dim=-1).values[:, -1]
        std = scores.std(dim=-1)
        bk, bv = p.build(li)
        gk = bk[:, :n * c].reshape(hkv, n, c, d)
        gv = bv[:, :n * c].reshape(hkv, n, c, d)
        dist = torch.cdist(gk.mean(2), cm_k)                  # [Hkv, n, C]
        idx = dist.argmin(-1)                                 # [Hkv, n]
        ok = bool((idx[:, 0] == 0).all()) and all(
            torch.unique(idx[h]).numel() == n for h in range(hkv))
        if ok and n > 1:
            sel = torch.gather(scores, 1, idx[:, 1:])
            gap = float(((thr[:, None] - sel) / std[:, None]).max())
            self._up("build_gap", max(gap, 0.0))
        elif not ok:
            self._up("build_gap", BAD)
        tok = (idx[..., None] * c + torch.arange(c, device=idx.device)
               ).reshape(hkv, n * c)                          # [Hkv, n*c]
        for ref, got, rms in ((k, gk, rms_vec[0]), (v, gv, rms_vec[1])):
            want = ref.transpose(0, 1)[torch.arange(hkv, device=idx.device
                                                    )[:, None], tok]
            err = (got.reshape(hkv, n * c, d) - want).norm(dim=-1).max()
            self._up("rkv_err", float(err) / rms)

    def _tail(self, li, k, v, rms_vec):
        p = self.prog
        lo = max(p.prompt, p.length - p.budget)
        if lo >= p.length:
            return
        pos = torch.arange(lo, p.length, device=k.device)
        slot = p.budget - 1 - torch.remainder(pos - p.prompt, p.budget)
        rk, rv = p.rkv(li)
        for ref, got, rms in ((k, rk, rms_vec[0]), (v, rv, rms_vec[1])):
            err = (got[:, slot] - ref[pos].transpose(0, 1)).norm(dim=-1)
            self._up("rkv_err", float(err.max()) / rms)


def judge(cfg: dict, weights: dict, ids: torch.Tensor, prog) -> dict:
    """Run the reference over ``ids`` (the tokens the program cached, in
    order) and return the readings; ``kv_len_gap`` compares the lengths
    first, and a mismatch skips the forward (every reading then fails)."""
    model.strict_fp32()
    gap = abs(int(prog.length) - int(ids.shape[0]))
    if gap:
        return dict(kv_len_gap=float(gap), kv_err=BAD, rkv_err=BAD,
                    build_gap=BAD)
    j = Judge(cfg, prog)
    with torch.no_grad():
        model.forward(cfg, weights, ids, on_layer=j.layer)
    return dict(kv_len_gap=0.0, **j.read)


def verdict(readings: dict, limits: dict) -> tuple:
    """(correct, [[name, value, limit], ...]): every reading at or under
    its limit, NaN failing."""
    rows = [[k, float(readings[k]), float(limits[k])] for k in limits]
    ok = all(v <= lim for _, v, lim in rows if not math.isnan(v)) and \
        not any(math.isnan(v) for _, v, _ in rows)
    return ok, rows
