"""Sampling ops — the port of ``triforce_tpu/ops/sampling.py``: temperature /
top-k / top-p filtering, categorical sampling from an explicit
``torch.Generator`` or from uniforms drawn beforehand (``sample_u``, as a
step's fixed draws give them), and the residual distribution of exact
rejection sampling. No op reads a value back to the host.

``sample`` is Gumbel-max, like the JAX package's, but a torch Generator
never yields JAX's threefry stream: the two packages agree on
distributions, not on individual draws.
"""

from __future__ import annotations

import os

import torch

_NEG_INF = -1e30


def top_k_filter(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Mask everything below the k-th largest logit."""
    if top_k <= 0:
        return logits
    k = min(top_k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, _NEG_INF, logits)


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Sort-based nucleus filter: keep the smallest prefix (by descending
    logit) whose cumulative softmax mass exceeds ``top_p``; the first token
    is always kept."""
    if top_p <= 0.0 or top_p >= 1.0:
        return logits
    sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True)
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    drop_sorted = cum > top_p
    drop_sorted = torch.cat([torch.zeros_like(drop_sorted[..., :1]),
                             drop_sorted[..., :-1]], dim=-1)
    drop = torch.empty_like(drop_sorted).scatter_(-1, sort_idx, drop_sorted)
    return torch.where(drop, _NEG_INF, logits)


def top_p_filter_fast(logits: torch.Tensor, top_p: float,
                      passes: int = 4, grid: int = 64) -> torch.Tensor:
    """Sort-free nucleus filter (the default): grid-refine the probability
    threshold whose upper level set has mass > top_p, then keep that set.
    Each pass evaluates the level-set mass at ``grid`` thresholds and
    narrows [lo, hi) by a factor of ``grid``."""
    if top_p <= 0.0 or top_p >= 1.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    pmax = probs.amax(-1, keepdim=True)
    lo = torch.zeros_like(pmax)
    hi = pmax + 1e-6
    frac = torch.arange(grid, dtype=probs.dtype, device=probs.device) / grid
    for _ in range(passes):
        taus = lo + (hi - lo) * frac                       # [..., G]
        mass = torch.where(probs[..., :, None] >= taus[..., None, :],
                           probs[..., :, None], 0.0).sum(-2)
        j = (mass > top_p).sum(-1, keepdim=True) - 1
        step = (hi - lo) / grid
        lo = lo + step * j
        hi = lo + step
    return torch.where(probs >= lo, logits, _NEG_INF)


def norm_logits(logits: torch.Tensor, temperature: float = 0.6,
                top_k: int = -1, top_p: float = 0.9) -> torch.Tensor:
    """logits [..., V] -> filtered probability simplex [..., V] (fp32).
    ``TRIFORCE_SORT_TOPP=1`` selects the sort-based top-p filter."""
    logits = logits.float() / temperature
    logits = top_k_filter(logits, top_k)
    if os.environ.get("TRIFORCE_SORT_TOPP"):
        logits = top_p_filter(logits, top_p)
    else:
        logits = top_p_filter_fast(logits, top_p)
    return torch.softmax(logits, dim=-1)


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from uniforms ``u`` in [0, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(tiny, 1.0 - 2 ** -24)))


def _log_probs(probs: torch.Tensor) -> torch.Tensor:
    """log p with zero-probability entries at the ``-1e30`` sentinel."""
    return torch.where(probs > 0, torch.log(probs.clamp_min(1e-37)),
                       _NEG_INF)


def _gumbel_argmax(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Gumbel-max over the last axis from uniforms ``u`` of probs' shape."""
    return torch.argmax(_log_probs(probs) + _gumbel(u), dim=-1)


def sample(probs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One token index per row of a probability tensor [..., V], by
    Gumbel-max on uniforms drawn from ``generator`` (on probs' device)."""
    u = torch.rand(probs.shape, generator=generator, device=probs.device,
                   dtype=torch.float32)
    return _gumbel_argmax(probs, u)


def sample_u(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``sample`` from uniforms ``u`` of probs' shape drawn beforehand: a
    step draws all its numbers in one call of fixed shape and hands each
    sample its share, so that which samples are used never changes what
    is drawn (``engine._draws``)."""
    return _gumbel_argmax(probs, u)


def max_fn(x: torch.Tensor) -> torch.Tensor:
    """Normalised positive residual ``norm(max(x, 0))`` used to resample on
    speculative rejection."""
    pos = x.clamp_min(0.0)
    denom = pos.sum(-1, keepdim=True)
    denom = torch.where(denom <= 0, 1.0, denom)
    return pos / denom


def topk_small(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exact ordered top-k indices of ``x`` [..., V] for a SMALL k by k
    argmax-and-mask passes (ties go to the lowest index, as in the JAX
    package). Entries may already sit at the ``-1e30`` sentinel; a picked
    entry is masked with ``-inf``, strictly below it, so a support smaller
    than k still yields distinct indices. Returns [..., k] int64 indices
    in descending-value order."""
    x = x.clamp_min(_NEG_INF)
    idxs = []
    for _ in range(k):
        i = torch.argmax(x, dim=-1, keepdim=True)
        idxs.append(i)
        x = x.scatter(-1, i, float("-inf"))
    return torch.cat(idxs, dim=-1)


def gumbel_u(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from uniforms ``u`` drawn beforehand (fp32)."""
    return _gumbel(u)


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` (fp32) from uniforms drawn from
    ``generator``."""
    return _gumbel(torch.rand(shape, generator=generator, device=device,
                              dtype=torch.float32))


def gumbel_topk_without_replacement(probs: torch.Tensor, k: int,
                                    generator: torch.Generator
                                    ) -> torch.Tensor:
    """``k`` distinct indices ~ probs [..., V], sampled without
    replacement: the arg-top-k of log p + Gumbel noise (k argmax passes,
    see ``topk_small``)."""
    return topk_small(_log_probs(probs) + gumbel_noise(
        probs.shape, generator, probs.device), k)
