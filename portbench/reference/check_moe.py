"""What decides ``correct`` in a cell of a model with sliding-window and
expert layers (``moe_window.py``'s): the program's caches and one target
verify's logits, held against the float32 reference recomputed from the
same weights and tokens. The readings are ``check.py``'s, over the layers
that hold each:

  kv_len_gap  cached positions against tokens reported (exact: 0).
  kv_err      the worst position of any layer's K or V: every position of
              each full layer's cache, and the last ``sliding_window``
              positions of each sliding layer, read out of its ring at
              their slots (what the ring must hold), each over the
              layer's RMS norm of such a vector.
  kv_rms_err  the same K and V as a whole: the worst layer's error norm
              over all its positions, heads and dimensions, over the
              reference's norm. ``kv_err``'s worst position is set by the
              few tokens whose expert choice differs between two sound
              precisions (an upstream rounding moves a near tie; their
              residual then differs by a whole expert's output), so a
              coarser precision of every matrix does not raise it; this
              reading weighs every position alike and does.
  rkv_err,    the retrieval cache's chunks and tail slots, and the build's
  build_gap   selection, at the full layers (the only ones it covers).
  moe_err     every expert layer of a closing target verify on its own:
              the program's output for its own input h against the
              reference's experts on the same h, the worst token's error
              norm over the layer's RMS output norm. Upstream rounding
              drops out, so this reads the router, the expert kernel and
              the combine alone (the rounding of the bf16 expert path,
              against what other precisions of the experts give). Where
              the program chose other experts than the reference at a
              near tie (each of its choices within 1e-3 of the reference's
              k-th probability), the reference takes the program's.
  moe_err_middle, moe_err_prefill
              the same of a closing middle verify (gamma + 1 tokens) and
              of a closing prefill chunk (on the card the grouped GEMM
              that every prefill chunk runs, not the expert kernel).
  logit_err   a target verify at the run's close (``logit_tokens``
              appended at its length, through the timed engine's graph):
              the worst position's logit vector error over the RMS norm of
              the reference's. The K/V of layer l are made by the layers
              below it, so this is what covers the last layer's attention
              and experts, the final norm and the head.

``prog`` is ``check.Judge``'s, its ``kv``, ``build`` and ``rkv`` indexed by
a full layer's index among the full layers, and besides: ``ring(si)`` ->
(k, v) [Hkv, n, D] float32, the last n = min(L, window) positions of
sliding layer si in position order, ``logits`` [T, V] float32 of the
closing verify, ``logit_tokens`` [T], the tokens it appended, and
``moe_io``: each layer's (h, output, experts chosen [T, k]) in each of
the closing forwards, by kind (``MOE_READINGS``' keys).
"""

from __future__ import annotations

import torch

from . import check, moe_window

BAD = check.BAD


class MoeJudge(check.Judge):
    """``check.Judge`` with each layer read where its kind keeps it."""

    def __init__(self, cfg: dict, prog):
        super().__init__(cfg, prog)
        self.full = {li: i for i, li in enumerate(
            j for j, kind in enumerate(cfg["layer_types"])
            if kind == moe_window.FULL)}
        self.sliding = {li: i for i, li in enumerate(
            j for j, kind in enumerate(cfg["layer_types"])
            if kind != moe_window.FULL)}
        self.read["kv_rms_err"] = 0.0

    def _whole(self, ref, got):
        """ref [T, H, D] against got [H, T, D]: the error norm over the
        reference's."""
        err = (got - ref.transpose(0, 1)).norm() / ref.norm()
        self._up("kv_rms_err", float(err))

    def layer(self, li, q, k, v):
        n = self.prog.length
        q, k, v = q[:n], k[:n], v[:n]
        if li in self.full:
            pk, pv = self.prog.kv(self.full[li])
            self._whole(k, pk)
            self._whole(v, pv)
            del pk, pv
            return super().layer(self.full[li], q, k, v)
        lo = max(0, n - self.cfg["sliding_window"])
        pk, pv = self.prog.ring(self.sliding[li])
        self._up("kv_err", check._pos_err(k[lo:], pk, check._rms(k, (1, 2))))
        self._up("kv_err", check._pos_err(v[lo:], pv, check._rms(v, (1, 2))))
        self._whole(k[lo:], pk)
        self._whole(v[lo:], pv)


NEAR_TIE = 1e-3
# the reading of each closing forward's expert layers
MOE_READINGS = {"verify": "moe_err", "middle": "moe_err_middle",
                "prefill": "moe_err_prefill"}


def moe_err(cfg: dict, weights: dict, moe_io) -> float:
    """The worst expert-layer error of one closing forward (module
    docstring)."""
    lw = weights["layers"]
    worst = 0.0
    for li, (h, got, chosen) in enumerate(moe_io):
        x = h.float()
        p, e, w = moe_window.route(cfg, lw, li, x)
        chosen = chosen.to(e.device).long()
        kth = p.gather(1, e[:, -1:])                       # [T, 1]
        tie = (p.gather(1, chosen) >= kth * (1 - NEAR_TIE)).all(-1) \
            & (chosen.sort(-1).values != e.sort(-1).values).any(-1)
        if bool(tie.any()):
            pw = p.gather(1, chosen)
            if cfg["norm_topk_prob"]:
                pw = pw / pw.sum(-1, keepdim=True)
            e = torch.where(tie[:, None], chosen, e)
            w = torch.where(tie[:, None], pw, w)
        ref = moe_window.experts(cfg, lw, li, x, e, w)
        scale = ref.norm(dim=-1).pow(2).mean().sqrt()
        err = float((got.float() - ref).norm(dim=-1).max() / scale)
        worst = max(worst, err) if err == err else BAD
    return worst


def judge(cfg: dict, weights: dict, ids: torch.Tensor, prog) -> dict:
    """Run the reference over ``ids`` (the tokens the program cached, in
    order) and the closing verify's tokens, and return the readings; a
    length mismatch skips the forward (every reading then fails)."""
    model = moe_window.model
    model.strict_fp32()
    gap = abs(int(prog.length) - int(ids.shape[0]))
    if gap:
        return dict(kv_len_gap=float(gap), kv_err=BAD, kv_rms_err=BAD,
                    rkv_err=BAD, build_gap=BAD, logit_err=BAD,
                    **{name: BAD for name in MOE_READINGS.values()})
    j = MoeJudge(cfg, prog)
    extra = prog.logit_tokens.to(ids.device)
    n = ids.shape[0]
    with torch.no_grad():
        ref = moe_window.forward(
            cfg, weights, torch.cat([ids, extra]), on_layer=j.layer,
            logits_at=list(range(n, n + extra.shape[0])))
    got = prog.logits.to(ref.device).float()
    err = (got - ref).norm(dim=-1).max() / ref.norm(dim=-1).pow(2).mean().sqrt()
    logit_err = float(err) if bool(torch.isfinite(err)) else BAD
    with torch.no_grad():
        m_err = {name: moe_err(cfg, weights, prog.moe_io[kind])
                 for kind, name in MOE_READINGS.items()}
    return dict(kv_len_gap=0.0, logit_err=logit_err, **m_err, **j.read)
