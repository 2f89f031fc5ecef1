"""The least work of a forward of a model with sliding-window and expert
layers (``configs/mellum2-12b-a2.5b.json``), in ``roofline.py``'s terms
(one H100's peaks; a least time is the larger of the operations over the
first and the bytes over the second).

A forward of T tokens after L cached ones reads, once each: the attention
matrices (wq, wk, wv, wo of every layer), each layer's router, the experts
it actually reads (``experts`` of them over all layers, as the program's
counter ``moe.experts_read`` counts them: 3 x I x H bf16 weights each),
the output head; each full layer's visible keys and values (L + T), each
sliding layer's min(L, window - 1) + T; and it writes the new ones. Its
operations are 2 per weight per token through the attention matrices, the
router and the head, 2 per expert weight per (token, chosen expert), and
4 x head_dim per (query head, query token, visible key). Embedding, norms,
activations and sampling are left out, so a least time is never
overstated.
"""

from __future__ import annotations

import roofline

BF16 = 2


def layers(m: dict) -> tuple:
    """(full layers, sliding layers)."""
    full = sum(k == "full_attention" for k in m["layer_types"])
    return full, m["num_hidden_layers"] - full


def expert_bytes(m: dict) -> int:
    """One expert's gate, up and down matrices in bf16 (12.39 MB for
    Mellum2)."""
    return 3 * m["hidden_size"] * m["moe_intermediate_size"] * BF16


def dense_params(m: dict) -> int:
    """Weights every forward reads whatever the routing: the attention
    matrices and routers of every layer and the head."""
    h, d = m["hidden_size"], m["head_dim"]
    hq = m["num_attention_heads"] * d
    hkv = m["num_key_value_heads"] * d
    per_layer = 2 * h * hq + 2 * h * hkv + m["num_experts"] * h
    return m["num_hidden_layers"] * per_layer + h * m["vocab_size"]


def forward(m: dict, tokens: int, visible: float, experts: float,
            full_visible=None) -> tuple:
    """(flops, bytes) of one forward appending ``tokens`` after
    ``visible`` cached ones that reads ``experts`` experts over all its
    layers (a mean is fine). ``full_visible``: the keys each full layer
    reads where that is not ``visible`` (a middle verify's retrieval
    budget)."""
    full, sliding = layers(m)
    d, hq = m["head_dim"], m["num_attention_heads"]
    kv_token = 2 * m["num_key_value_heads"] * d * BF16     # K and V a layer
    fv = visible if full_visible is None else full_visible
    sv = min(visible, m["sliding_window"] - 1)
    flops = (2.0 * dense_params(m) * tokens
             + 2.0 * expert_bytes(m) / BF16 * tokens
             * m["num_experts_per_tok"] * m["num_hidden_layers"]
             + 4.0 * hq * d * tokens * (full * (fv + (tokens + 1) / 2)
                                        + sliding * (sv + (tokens + 1) / 2)))
    nbytes = (dense_params(m) * BF16 + experts * expert_bytes(m)
              + kv_token * (full * (fv + tokens) + sliding * (sv + tokens)))
    return flops, nbytes


def least_s(m: dict, tokens: int, visible: float, experts: float,
            full_visible=None) -> float:
    return roofline.least_s(*forward(m, tokens, visible, experts,
                                     full_visible))
