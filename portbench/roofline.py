"""The yardstick of the shares: one H100's published peaks and the least
work of each forward and kernel the cells run, counted from shapes.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit): 989
TFLOP/s in bf16 on the tensor cores and 3.35 TB/s of HBM. The least time
of some work is the larger of its operations over the first and its bytes
over the second; work done in several forwards or kernel calls, one
after another, takes the sum of each one's least time. Every share the benchmark reports is such a least time
over a measured time, and it is printed beside the card's power limit,
since a card set below 700 W cannot reach these peaks.

A forward reads each of its matrices once (the embedding table is only
gathered), reads each row's visible keys and values once and writes the
keys and values of its new tokens. Operations are 2 per weight per token
and 4 * head_dim per (query head, query token, visible key). Activations,
norms and sampling are left out, so a least time is never overstated.
"""

from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def matmul_params(m: dict) -> int:
    """Weights of every matrix product of one forward: the layers' seven
    projections and the output head."""
    h, i, d = m["hidden_size"], m["intermediate_size"], m["head_dim"]
    hq = m["num_attention_heads"] * d
    hkv = m["num_key_value_heads"] * d
    per_layer = 2 * h * hq + 2 * h * hkv + 3 * h * i
    return m["num_hidden_layers"] * per_layer + h * m["vocab_size"]


def kv_bytes_per_token(m: dict) -> int:
    """Bytes of bf16 keys and values one token holds over every layer."""
    return 2 * m["num_hidden_layers"] * m["num_key_value_heads"] \
        * m["head_dim"] * 2


def attn_flops(m: dict, tokens: int, visible: float) -> float:
    """Scores and weighted values of ``tokens`` query tokens that see
    ``visible`` keys each on average, over every layer."""
    return (4.0 * m["num_attention_heads"] * m["head_dim"] * tokens
            * visible * m["num_hidden_layers"])


def forward(m: dict, tokens: int, visible: float, rows: int = 1) -> tuple:
    """(flops, bytes) of one forward of ``rows`` rows, each appending
    ``tokens`` tokens after ``visible`` cached ones (their mean over the
    rows), reading its bf16 weights once."""
    n = rows * tokens
    flops = 2.0 * matmul_params(m) * n + rows * attn_flops(
        m, tokens, visible + (tokens + 1) / 2)
    nbytes = (matmul_params(m) * 2
              + rows * (visible + tokens) * kv_bytes_per_token(m))
    return flops, nbytes


def prefill_least_s(m: dict, prompt: int, chunk: int) -> float:
    """Least seconds of a chunked prefill of ``prompt`` tokens: one
    forward a chunk, each over the chunks before it, each its own least
    time (a chunk is compute-bound, the weights' read is not)."""
    return sum(least_s(*forward(m, min(chunk, prompt - start), start))
               for start in range(0, prompt, chunk))


def attention_kernel(m: dict, tokens: int, visible: float) -> tuple:
    """(flops, bytes) of the flash-decode kernels of one forward: over
    every layer, ``tokens`` queries and new keys and values against
    ``visible`` cached ones, read once, and the output written once."""
    layers, d = m["num_hidden_layers"], m["head_dim"]
    hq, hkv = m["num_attention_heads"], m["num_key_value_heads"]
    flops = attn_flops(m, tokens, visible + (tokens + 1) / 2)
    per_layer = (2 * hkv * d * 2 * (visible + tokens)   # K, V in, bf16
                 + 2 * hq * d * tokens * 2)               # q in, out
    return flops, per_layer * layers


def add(*works) -> tuple:
    """The work of one forward or kernel call made of several parts."""
    return (sum(w[0] for w in works), sum(w[1] for w in works))
