"""A plain float32 reference of a decoder with sliding-window and full
attention layers and sparse (expert) MLPs, for the CPU tests of the port's
hybrid path (Mellum2's layer equations at any size).

Written from the published description alone: no kernel, no cache, no
batching, TF32 off; it imports neither JAX nor the port. A forward runs
the whole token sequence through every layer:

  x <- x + Attn(RMSNorm(x)),  x <- x + MoE(RMSNorm(x))    pre-norm, no bias
  full layer:    causal attention over every earlier position, YaRN RoPE
                 (NTK-by-parts, its attention scale 0.1 ln s + 1 on cos and
                 sin)
  sliding layer: position i sees positions i - window + 1 .. i (transformers'
                 ``kv_idx > q_idx - sliding_window``), plain RoPE
  MoE:           p = softmax(h . W_r^T) in float32, the top k of p,
                 renormalised to sum 1; out = sum_k p_k W_down[e_k]
                 (silu(W_gate[e_k] h) * W_up[e_k] h)

Departures from the published model, none of which changes a shape: no
multi-token-prediction head (the published config has no key for one);
the weights are whatever the caller passes (random in the tests), in the
port's layout: attention matrices ``x @ w`` stacked over layers, expert
matrices a row per output (``w_router`` [L, E, H], ``w_gate_e`` /
``w_up_e`` [L, E, I, H], ``w_down_e`` [L, E, H, I]).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FULL, SLIDING = "full_attention", "sliding_attention"


def strict_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _inv_freq(d: int, theta: float, yarn=None) -> torch.Tensor:
    """RoPE inverse frequencies [d / 2]; ``yarn`` = (factor, original
    positions): YaRN's NTK-by-parts blend (beta_fast 32, beta_slow 1)."""
    pos = theta ** (torch.arange(0, d, 2, dtype=torch.float64) / d)
    if yarn is None:
        return (1.0 / pos).float()
    factor, orig = yarn

    def corr(rot):
        return d * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(theta))
    lo = max(math.floor(corr(32.0)), 0)
    hi = min(math.ceil(corr(1.0)), d - 1)
    if lo == hi:
        hi += 0.001
    ramp = ((torch.arange(d // 2, dtype=torch.float64) - lo)
            / (hi - lo)).clamp(0, 1)
    return ((1.0 / (factor * pos)) * ramp + (1.0 / pos) * (1 - ramp)).float()


def rope_tables(d: int, theta: float, n: int, yarn=None):
    """cos, sin [n, d] float32, YaRN's scale folded into both."""
    scale = 1.0 if yarn is None or yarn[0] <= 1 else \
        0.1 * math.log(yarn[0]) + 1.0
    emb = torch.outer(torch.arange(n, dtype=torch.float32),
                      _inv_freq(d, theta, yarn))
    emb = torch.cat([emb, emb], -1)
    return emb.cos() * scale, emb.sin() * scale


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    return x * cos[:, None] + torch.cat([-x[..., half:], x[..., :half]],
                                        -1) * sin[:, None]


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _attention(q, k, v, window: int = 0):
    """q [T, Hq, D], k/v [T, Hkv, D] -> [T, Hq, D]: causal, and with
    ``window`` each query sees its last ``window`` positions only."""
    t, hq, d = q.shape
    g = hq // k.shape[1]
    kk = k.repeat_interleave(g, 1)
    vv = v.repeat_interleave(g, 1)
    s = torch.einsum("ihd,jhd->hij", q, kk) / math.sqrt(d)
    i = torch.arange(t)[:, None]
    j = torch.arange(t)[None, :]
    ok = j <= i
    if window:
        ok = ok & (j > i - window)
    s = s.masked_fill(~ok, float("-inf"))
    return torch.einsum("hij,jhd->ihd", torch.softmax(s, -1), vv)


def route(h, w_router, top_k: int, norm: bool = True):
    """h [N, H] -> (expert ids [N, k], weights [N, k]) in float32."""
    p = torch.softmax(h @ w_router.T, -1)
    w, e = torch.topk(p, top_k, -1)
    return e, (w / w.sum(-1, keepdim=True) if norm else w)


def moe(h, w_router, w_gate, w_up, w_down, top_k: int, norm: bool = True):
    e, w = route(h, w_router, top_k, norm)
    out = torch.zeros_like(h)
    for n in range(h.shape[0]):
        for k in range(top_k):
            x = h[n]
            a = F.silu(w_gate[e[n, k]] @ x) * (w_up[e[n, k]] @ x)
            out[n] += w[n, k] * (w_down[e[n, k]] @ a)
    return out


def forward(c: dict, weights: dict, ids: torch.Tensor, queries=None):
    """float32 forward of ``ids`` [T]. ``c``: vocab, hidden, heads,
    kv_heads, head_dim, eps, layer_types, window, theta_full, yarn
    ((factor, original) or None), theta_local, top_k, norm_topk.
    Returns (logits [T, V], [(k, v) [T, Hkv, D] rotated, a layer]);
    ``queries`` (a list) receives each layer's rotated q [T, Hq, D]."""
    f = {k: (v.float() if torch.is_tensor(v) else
             {kk: vv.float() for kk, vv in v.items()})
         for k, v in weights.items()}
    t, d = ids.shape[0], c["head_dim"]
    tabs = {FULL: rope_tables(d, c["theta_full"], t, c["yarn"]),
            SLIDING: rope_tables(d, c["theta_local"], t)}
    x = f["embed"][ids]
    lw = f["layers"]
    kvs = []
    for li, kind in enumerate(c["layer_types"]):
        h = _rms(x, lw["ln_attn"][li], c["eps"])
        q = (h @ lw["wq"][li]).view(t, c["heads"], d)
        k = (h @ lw["wk"][li]).view(t, c["kv_heads"], d)
        v = (h @ lw["wv"][li]).view(t, c["kv_heads"], d)
        cos, sin = tabs[kind]
        q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
        kvs.append((k, v))
        if queries is not None:
            queries.append(q)
        a = _attention(q, k, v, c["window"] if kind == SLIDING else 0)
        x = x + a.reshape(t, -1) @ lw["wo"][li]
        h = _rms(x, lw["ln_mlp"][li], c["eps"])
        x = x + moe(h, lw["w_router"][li], lw["w_gate_e"][li],
                    lw["w_up_e"][li], lw["w_down_e"][li], c["top_k"],
                    c["norm_topk"])
    x = _rms(x, f["final_norm"], c["eps"])
    return x @ f["lm_head"], kvs
