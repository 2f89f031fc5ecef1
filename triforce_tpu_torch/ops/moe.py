"""Sparse (mixture-of-experts) MLP layers: the router and the experts.

A sparse layer (``config.HybridConfig``) sends each token's normed hidden
state h [H] to ``top_k`` of ``E`` experts, each a SwiGLU MLP of width I:

  logits = fp32(h) . W_r^T                       [E], fp32 products
  p      = softmax(logits)                        fp32
  (w, e) = the top_k of p, in descending order (a tie: the lower index)
  w      = w / sum(w)                             with ``norm_topk_prob``
  y_k    = bf16(a_k . W_down[e_k]^T),  a_k = silu_mul(bf16(h . W_gate[e_k]^T),
                                                  bf16(h . W_up[e_k]^T))
  out    = bf16(sum_k w_k * y_k)                  fp32, k in order

(``silu_mul`` rounds as ``ops/layer_glue.py``'s does.) Weights are stored
a row per output, as ``torch.nn.Linear`` holds them: ``w_router`` [E, H],
``w_gate_e`` / ``w_up_e`` [E, I, H], ``w_down_e`` [E, H, I].

On the card, ``csrc/moe.cu``:

  ``route``   one CTA a token: the router's products, the softmax, the
              top-k and the renormalisation, indices and weights written
              on the device;
  ``experts`` for up to ``DECODE_TOKENS`` tokens (the AR step, the middle
              and target verifies): a fixed grid over (expert, output
              tile). A CTA whose expert no token chose exits before it
              reads anything; one that was chosen streams its tile of the
              expert's gate and up rows once for every token routed to it
              (up to 8 at a time, so once at the decode shapes), fuses
              silu * up, and the down product's CTAs do the same over
              their rows; a third kernel sums each token's top-k outputs
              in k order (no float atomics: a replay repeats bit for
              bit). For more tokens (prefill chunks) the tokens are sorted
              by expert on the device and run as one grouped GEMM
              (``torch._grouped_mm``: static row count, offsets on the
              device, so the chunk's graph captures it), then the same
              combine kernel.

Every launch has a fixed grid and reads its sizes from the shapes, so the
layers replay inside the engine's CUDA graphs. CPU tensors take the plain
versions (``*_plain``), which define the arithmetic.

Counters. Inside ``counting(sink)`` (``sink`` an int64 [3] device tensor)
the layers add to ``sink`` on the device: the distinct experts each layer
call read, the (token, expert) pairs routed, the layer calls. The engine
keeps one sink per forward kind (``Engine.moe_counts``), so the counts of
graphed forwards accumulate in replays and are read back once.
``<entry point>.launches`` counts kernel launches.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build
from . import layer_glue

_SOURCE = "moe.cu"
DECODE_TOKENS = 64     # tokens up to this take the expert kernel
_SINK: Optional[torch.Tensor] = None


@contextlib.contextmanager
def counting(sink: Optional[torch.Tensor]):
    """Add the sparse layers' counts to ``sink`` (int64 [3] on their
    device: experts read, pairs routed, layer calls) while open."""
    global _SINK
    prev, _SINK = _SINK, sink
    try:
        yield
    finally:
        _SINK = prev


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def route_plain(h, w_router, top_k: int, norm: bool = True):
    """h [N, H] -> (expert ids [N, top_k] int32, weights [N, top_k] fp32)."""
    p = torch.softmax(h.float() @ w_router.float().T, dim=-1)
    w, e = torch.topk(p, top_k, dim=-1)
    if norm:
        w = w / w.sum(-1, keepdim=True)
    return e.to(torch.int32), w


def expert_outputs_plain(h, idx, w_gate, w_up, w_down):
    """[N, top_k, H] in h's dtype: each token through each of its
    experts (rounded as the module docstring says)."""
    n, k = idx.shape
    out = torch.zeros((n * k, h.shape[-1]), dtype=h.dtype, device=h.device)
    flat = idx.reshape(-1).long()
    for e in torch.unique(flat).tolist():
        pairs = (flat == e).nonzero()[:, 0]
        x = h.index_select(0, pairs // k)
        a = layer_glue.silu_mul_plain(x @ w_gate[e].T, x @ w_up[e].T)
        out[pairs] = a @ w_down[e].T
    return out.reshape(n, k, -1)


def combine_plain(y, w):
    """y [N, top_k, H], w [N, top_k] -> bf16-rounded sum_k w_k y_k [N, H],
    summed in fp32 in k order."""
    acc = torch.zeros(y.shape[::2], dtype=torch.float32, device=y.device)
    for k in range(y.shape[1]):
        acc = acc + w[:, k, None] * y[:, k].float()
    return acc.to(y.dtype)


def moe_plain(h, w_router, w_gate, w_up, w_down, top_k: int,
              norm: bool = True):
    """The sparse MLP of tokens h [N, H] in plain PyTorch."""
    idx, w = route_plain(h, w_router, top_k, norm)
    return combine_plain(expert_outputs_plain(h, idx, w_gate, w_up, w_down),
                         w)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

def _check(what, *xs):
    dev = xs[0].device
    for x in xs:
        if x.device != dev or x.dtype != torch.bfloat16 \
                or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{what} takes contiguous, 16-byte aligned "
                             f"bf16 operands on one device; got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def _sink_ptr(dev) -> int:
    if _SINK is None:
        return 0
    if _SINK.device != dev or _SINK.dtype != torch.int64 \
            or _SINK.numel() != 3:
        raise ValueError("the MoE counter sink must be int64 [3] on the "
                         "layer's device")
    return _SINK.data_ptr()


def route(h, w_router, top_k: int, norm: bool = True):
    """``route_plain`` as one kernel launch on the card (h [N, H],
    w_router [E, H]; H a multiple of 8, E <= 256); the CPU takes the plain
    version."""
    if h.device.type == "cpu":
        return route_plain(h, w_router, top_k, norm)
    _check("moe route", h, w_router)
    n, hidden = h.shape
    e = w_router.shape[0]
    if hidden % 8 or e > 256 or not 0 < top_k <= min(e, 32):
        raise ValueError(f"moe route: hidden {hidden}, {e} experts, top "
                         f"{top_k}")
    idx = torch.empty((n, top_k), dtype=torch.int32, device=h.device)
    w = torch.empty((n, top_k), dtype=torch.float32, device=h.device)
    err = _build.lib(_SOURCE).tf_moe_route(
        h.data_ptr(), w_router.data_ptr(), n, hidden, e, top_k, int(norm),
        idx.data_ptr(), w.data_ptr(), _sink_ptr(h.device),
        _stream(h.device))
    _build.check(err, "moe route kernel launch")
    route.launches += 1
    return idx, w


route.launches = 0


def _combine(y, w):
    n, k, hidden = y.shape
    out = torch.empty((n, hidden), dtype=y.dtype, device=y.device)
    err = _build.lib(_SOURCE).tf_moe_combine(
        y.data_ptr(), w.data_ptr(), out.data_ptr(), n, k, hidden,
        _stream(y.device))
    _build.check(err, "moe combine kernel launch")
    return out


def experts(h, idx, w, w_gate, w_up, w_down):
    """sum_k w_k * expert_{idx_k}(h) for tokens h [N, H] (the module
    docstring): the expert kernel for N <= ``DECODE_TOKENS``, the grouped
    GEMM above, the plain version on the CPU. -> [N, H] in h's dtype.
    ``experts.launches`` counts the expert kernel's launches (a launch =
    its gate/up, down and combine kernels), ``_grouped.launches`` the
    grouped path's (its three GEMMs and the combine kernel)."""
    if h.device.type == "cpu":
        return combine_plain(expert_outputs_plain(h, idx, w_gate, w_up,
                                                  w_down), w)
    _check("moe experts", h, w_gate, w_up, w_down)
    n, hidden = h.shape
    k = idx.shape[1]
    ne, inter = w_gate.shape[:2]
    if w_up.shape != w_gate.shape or w_gate.shape[2] != hidden \
            or w_down.shape != (ne, hidden, inter) or hidden % 8 \
            or inter % 8 or idx.dtype != torch.int32 \
            or w.dtype != torch.float32 or w.shape != idx.shape:
        raise ValueError(f"moe experts: h {tuple(h.shape)}, gate "
                         f"{tuple(w_gate.shape)}, down {tuple(w_down.shape)}"
                         f", idx {idx.dtype} {tuple(idx.shape)}")
    if n > DECODE_TOKENS:
        return _grouped(h, idx, w, w_gate, w_up, w_down)
    act = torch.empty((n * k, inter), dtype=h.dtype, device=h.device)
    y = torch.empty((n, k, hidden), dtype=h.dtype, device=h.device)
    out = torch.empty((n, hidden), dtype=h.dtype, device=h.device)
    err = _build.lib(_SOURCE).tf_moe_experts(
        h.data_ptr(), idx.data_ptr(), w.data_ptr(), w_gate.data_ptr(),
        w_up.data_ptr(), w_down.data_ptr(), act.data_ptr(), y.data_ptr(),
        out.data_ptr(), n, k, hidden, inter, ne, _sink_ptr(h.device),
        _stream(h.device))
    _build.check(err, "moe experts kernel launch")
    experts.launches += 1
    return out


experts.launches = 0


def _grouped(h, idx, w, w_gate, w_up, w_down):
    """The prefill chunks' experts: the N * top_k (token, expert) pairs
    sorted by expert on the device, one grouped GEMM each for gate, up
    and down (static row count, offsets on the device), then the combine
    kernel."""
    n, k = idx.shape
    ne = w_gate.shape[0]
    flat = idx.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    per = torch.zeros((ne,), dtype=torch.int32, device=h.device)
    per.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    offs = torch.cumsum(per, 0, dtype=torch.int32)
    rows = h.index_select(0, order // k)
    gate = torch._grouped_mm(rows, w_gate.transpose(-2, -1), offs=offs)
    up = torch._grouped_mm(rows, w_up.transpose(-2, -1), offs=offs)
    y_sorted = torch._grouped_mm(layer_glue.silu_mul(gate, up),
                                 w_down.transpose(-2, -1), offs=offs)
    y = torch.empty_like(y_sorted).index_copy_(0, order, y_sorted)
    if _SINK is not None:
        _SINK[:1].add_((per > 0).sum().reshape(1))
    _grouped.launches += 1
    return _combine(y.reshape(n, k, -1), w)


_grouped.launches = 0


def moe_mlp(h, lp, top_k: int, norm: bool = True):
    """A sparse layer's MLP output for h [..., H] (layer weights ``lp``:
    ``w_router``, ``w_gate_e``, ``w_up_e``, ``w_down_e``)."""
    lead = h.shape[:-1]
    x = h.reshape(-1, h.shape[-1])
    idx, w = route(x, lp["w_router"], top_k, norm)
    if _SINK is not None and x.device.type == "cpu":
        _SINK.add_(torch.tensor([torch.unique(idx).numel(), idx.numel(), 1]))
    out = experts(x, idx, w, lp["w_gate_e"], lp["w_up_e"], lp["w_down_e"])
    return out.reshape(lead + (out.shape[-1],))
