"""The plain reference of Mellum2's decoder: sliding-window and full
attention layers, every MLP a mixture of experts, in float32 PyTorch,
written from the configuration file alone. It imports nothing of the
program under test.

    x <- x + Attn(RMSNorm(x));  x <- x + MoE(RMSNorm(x))     pre-norm, no bias
    full layers     causal attention over every earlier position, YaRN RoPE
                    (``rope_parameters.full_attention``: NTK-by-parts, its
                    attention_factor on cos and sin)
    sliding layers  position i sees positions i - window + 1 .. i
                    (transformers' ``kv_idx > q_idx - sliding_window``),
                    default RoPE (``rope_parameters.sliding_attention``)
    MoE             p = softmax(h . W_r^T) in float32, the top k of p
                    renormalised to sum 1 (``norm_topk_prob``); out =
                    sum_k p_k W_down[e_k] (silu(W_gate[e_k] h) * W_up[e_k] h)

Departures from the published model, none of which changes a shape: no
multi-token-prediction head (the config has no key for one); the weights
are the harness's random ones (``traffic/batch1_forced_moe.py``), in the
layout the program reads: attention matrices ``x @ w`` stacked over
layers, expert matrices a row per output (``w_router`` [L, E, H],
``w_gate_e`` / ``w_up_e`` [L, E, I, H], ``w_down_e`` [L, E, H, I]).

The forward runs the whole token sequence one layer at a time, so that a
120K-token sequence fits beside the program's weights: each of the
layer's weights is taken to float32 as it is used (an expert at a time),
never all at once (48.6 GB of float32 would not fit beside the 24.3 GB of
bf16). Full attention is PyTorch's fused exact attention (as
``model.causal_attention``), sliding attention the same over blocks of
queries with their window's keys. TF32 is off (``model.strict_fp32``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import model

FULL = "full_attention"
QUERY_BLOCK = 4096


def rope_tables(cfg: dict, kind: str, n: int, device):
    """cos, sin [n, head_dim] float32 of one attention kind, the
    attention factor of a YaRN section folded into both."""
    p = cfg["rope_parameters"][kind]
    d, base = cfg["head_dim"], float(p["rope_theta"])
    if p["rope_type"] == "yarn":
        f = float(p["factor"])
        inv = model._yarn_inv_freq(
            d, base, f, int(p["original_max_position_embeddings"]),
            float(p.get("beta_fast", 32)), float(p.get("beta_slow", 1)),
            device=device)
        scale = float(p.get("attention_factor", 0.1 * math.log(f) + 1.0))
    else:
        inv = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                           device=device) / d))
        scale = 1.0
    emb = torch.outer(torch.arange(n, dtype=torch.float32, device=device),
                      inv)
    emb = torch.cat([emb, emb], dim=-1)
    return emb.cos() * scale, emb.sin() * scale


def window_attention(q, k, v, window: int) -> torch.Tensor:
    """Causal attention in which query i sees keys i - window + 1 .. i:
    q [T, Hq, D], k/v [T, Hkv, D] -> [T, Hq, D], over blocks of queries
    with their window's keys (fused exact attention under a mask)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    t, hq, _ = q.shape
    g = hq // k.shape[1]
    out = torch.empty_like(q)
    for s in range(0, t, QUERY_BLOCK):
        e = min(s + QUERY_BLOCK, t)
        lo = max(0, s - window + 1)
        i = torch.arange(s, e, device=q.device)[:, None]
        j = torch.arange(lo, e, device=q.device)[None, :]
        mask = (j <= i) & (j > i - window)
        qh = q[s:e].permute(1, 0, 2)[None]
        kh = k[lo:e].permute(1, 0, 2).repeat_interleave(g, 0)[None]
        vh = v[lo:e].permute(1, 0, 2).repeat_interleave(g, 0)[None]
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]):
            o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
        out[s:e] = o[0].permute(1, 0, 2)
    return out


def route(cfg: dict, lw: dict, li: int, h: torch.Tensor):
    """Layer ``li``'s router over h [T, H] float32: (p [T, E], the top-k
    experts [T, k] in descending order, their weights [T, k])."""
    p = torch.softmax(h @ lw["w_router"][li].float().T, dim=-1)
    w, e = torch.topk(p, cfg["num_experts_per_tok"], dim=-1)
    if cfg["norm_topk_prob"]:
        w = w / w.sum(-1, keepdim=True)
    return p, e, w


def experts(cfg: dict, lw: dict, li: int, h: torch.Tensor, e, w):
    """sum_k w_k expert_{e_k}(h) of h [T, H] float32, an expert at a time
    over the tokens routed to it."""
    out = torch.zeros_like(h)
    for ex in range(cfg["num_experts"]):
        tok, slot = (e == ex).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok]
        a = F.silu(x @ lw["w_gate_e"][li, ex].float().T) \
            * (x @ lw["w_up_e"][li, ex].float().T)
        out.index_add_(0, tok, (a @ lw["w_down_e"][li, ex].float().T)
                       * w[tok, slot, None])
    return out


def moe(cfg: dict, lw: dict, li: int, h: torch.Tensor) -> torch.Tensor:
    """Layer ``li``'s expert MLP of h [T, H] float32."""
    _, e, w = route(cfg, lw, li, h)
    return experts(cfg, lw, li, h, e, w)


def forward(cfg: dict, weights: dict, ids: torch.Tensor, on_layer=None,
            logits_at=None):
    """float32 forward of ``ids`` [T] through every layer.
    ``on_layer(li, q, k, v)`` sees layer li's rotated q [T, Hq, D] and
    rotated k and v [T, Hkv, D] before its attention. Returns the float32
    logits [len(logits_at), V] at the positions ``logits_at``, or None."""
    dev = ids.device
    t = ids.shape[0]
    d, hq, hkv = cfg["head_dim"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"]
    eps = cfg["rms_norm_eps"]
    kinds = cfg["layer_types"]
    tables = {kind: rope_tables(cfg, kind, t, dev) for kind in set(kinds)}
    x = weights["embed"][ids].float()
    lw = weights["layers"]
    for li, kind in enumerate(kinds):
        h = model.rms_norm(x, lw["ln_attn"][li].float(), eps)
        cos, sin = tables[kind]
        q = model.rotate((h @ lw["wq"][li].float()).view(t, hq, d), cos, sin)
        k = model.rotate((h @ lw["wk"][li].float()).view(t, hkv, d), cos,
                         sin)
        v = (h @ lw["wv"][li].float()).view(t, hkv, d)
        del h
        if on_layer is not None:
            on_layer(li, q, k, v)
        a = model.causal_attention(q, k, v) if kind == FULL else \
            window_attention(q, k, v, cfg["sliding_window"])
        del q, k, v
        x += a.reshape(t, hq * d) @ lw["wo"][li].float()
        del a
        x += moe(cfg, lw, li, model.rms_norm(x, lw["ln_mlp"][li].float(),
                                             eps))
    if logits_at is None:
        return None
    xs = model.rms_norm(x[logits_at], weights["final_norm"].float(), eps)
    return xs @ weights["lm_head"].float()
