"""The plain reference: a Llama-style decoder (RMSNorm, SwiGLU, rotary
positions with YaRN or plain RoPE, grouped-query attention) in float32
PyTorch, written from the published equations and the configuration file
alone. It imports nothing of the program under test.

The forward runs over a whole token sequence, one layer at a time, so that
a 128K-token sequence fits beside the program's cache: every projection is
float32, attention is exact causal softmax (fused, no score matrix held),
the MLP runs in blocks of tokens. ``on_layer`` is handed each layer's rotated
queries and keys and its values before that layer's attention, which is
where the benchmark compares them with what the program cached.

TF32 is switched off for the whole process while it runs (a float32
matrix product on the card may otherwise round its inputs to 10 bits).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def strict_fp32() -> None:
    """No TF32 in float32 products or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _yarn_inv_freq(dim: int, base: float, factor: float, orig: int,
                   beta_fast: float = 32.0, beta_slow: float = 1.0,
                   device=None) -> torch.Tensor:
    """YaRN's NTK-by-parts frequencies (Peng et al. 2023, eq. 15-18): the
    dimensions that rotate fewer than ``beta_slow`` times over the original
    context are interpolated by ``factor``, those that rotate more than
    ``beta_fast`` times are kept, a linear ramp between."""
    def corr_dim(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) / (
            2 * math.log(base))
    low = max(math.floor(corr_dim(beta_fast)), 0)
    high = min(math.ceil(corr_dim(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    pos = base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                device=device) / dim)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp                 # 1: extrapolate (keep), 0: interpolate
    return (1.0 / (factor * pos)) * (1.0 - keep) + (1.0 / pos) * keep


def rope_tables(cfg: dict, n: int, device):
    """cos and sin [n, head_dim] in float32 for positions 0..n-1, with
    YaRN's attention scale (0.1 ln s + 1) folded into both."""
    d = cfg["head_dim"]
    base = float(cfg["rope_theta"])
    scaling = cfg.get("rope_scaling")
    mscale = 1.0
    if scaling and scaling.get("type", scaling.get("rope_type")) == "yarn":
        s = float(scaling["factor"])
        inv = _yarn_inv_freq(d, base, s,
                             int(scaling["original_max_position_embeddings"]),
                             device=device)
        mscale = 0.1 * math.log(s) + 1.0 if s > 1 else 1.0
    else:
        inv = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                           device=device) / d))
    t = torch.arange(n, dtype=torch.float32, device=device)
    emb = torch.outer(t, inv)
    emb = torch.cat([emb, emb], dim=-1)
    return emb.cos() * mscale, emb.sin() * mscale


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [T, H, D] rotated at the positions of the table rows [T, D]."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None] + rot * sin[:, None]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """In float32, rounded to x's dtype before the gain."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
            ).to(x.dtype) * w


def causal_attention(q, k, v) -> torch.Tensor:
    """Exact causal softmax attention over one sequence: q [T, Hq, D],
    k, v [T, Hkv, D] (query head h reads key head h // (Hq / Hkv)) ->
    [T, Hq, D]. PyTorch's fused attention without materialised scores:
    on the card its memory-efficient kernel, whose float32 path matches a
    float64 evaluation to ~1e-6 (no TF32), else the plain math."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    g = q.shape[1] // k.shape[1]
    qh = q.permute(1, 0, 2)[None]
    kh = k.permute(1, 0, 2).repeat_interleave(g, 0)[None]
    vh = v.permute(1, 0, 2).repeat_interleave(g, 0)[None]
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]):
        out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    return out[0].permute(1, 0, 2)


def forward(cfg: dict, weights: dict, ids: torch.Tensor, on_layer=None,
            token_block: int = 8192, logits_at=None, dtype=torch.float32):
    """float32 forward of ``ids`` [T] through every layer (``dtype``:
    every product, table and residual in that type instead, the
    witness of what rounding alone does to the same equations).

    ``weights`` holds the matrices in ``x @ w`` orientation, stacked over
    layers (``layers``: wq, wk, wv, wo, w_gate, w_up, w_down, ln_attn,
    ln_mlp) beside ``embed``, ``final_norm`` and ``lm_head``, in any
    dtype; each layer is taken to float32 as it is used.
    ``on_layer(li, q, k, v)`` sees layer ``li``'s rotated q [T, Hq, D],
    rotated k and v [T, Hkv, D]. Returns the float32 logits at the
    positions ``logits_at`` (a list), or None."""
    dev = ids.device
    t = ids.shape[0]
    d, hq, hkv = cfg["head_dim"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"]
    eps = cfg["rms_norm_eps"]
    cos, sin = (x.to(dtype) for x in rope_tables(cfg, t, dev))
    x = weights["embed"][ids].to(dtype)
    lw = weights["layers"]
    for li in range(cfg["num_hidden_layers"]):
        w = {k: v[li].to(dtype) for k, v in lw.items()}
        h = rms_norm(x, w["ln_attn"], eps)
        q = rotate((h @ w["wq"]).view(t, hq, d), cos, sin)
        k = rotate((h @ w["wk"]).view(t, hkv, d), cos, sin)
        v = (h @ w["wv"]).view(t, hkv, d)
        del h
        if on_layer is not None:
            on_layer(li, q, k, v)
        a = causal_attention(q, k, v)
        del q, k, v
        x += a.reshape(t, hq * d) @ w["wo"]
        del a
        for s in range(0, t, token_block):
            hb = rms_norm(x[s:s + token_block], w["ln_mlp"], eps)
            x[s:s + token_block] += (F.silu(hb @ w["w_gate"])
                                     * (hb @ w["w_up"])) @ w["w_down"]
        del w
    if logits_at is None:
        return None
    xs = rms_norm(x[logits_at], weights["final_norm"].to(dtype), eps)
    return (xs @ weights["lm_head"].to(dtype)).float()
