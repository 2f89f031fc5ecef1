"""The non-GEMM glue of a decoder layer, as three hand-written kernels.

Every Llama forward (``models/llama.py``) runs, in every layer, a residual
add followed by an RMSNorm twice, RoPE on q and k, and SiLU(gate) * up
before the down projection. As PyTorch ops that chain is ~35 device
launches a layer on rows of a few KB, each costing its launch whatever its
size. Here each piece is one launch of ``csrc/layer_glue.cu``:

  add_rms_norm(x, y, w, eps) -> (x + y, rms_norm(x + y) * w); y may be None
               (the first layer's norm), and x is then returned as it is
  rope(xs, cos, sin, positions) -> the tensors of ``xs`` (one or two,
               [B, H, T, D]: q and k, or the drafter's whole window)
               rotated at ``positions`` ([T], or [B, T] for a position per
               row), the table rows read in the kernel: no gather
  silu_mul(gate, up) -> silu(gate) * up

Each entry point takes its plain version (``*_plain``, the forwards' code as
it was) for CPU tensors and launches its kernel for CUDA tensors, or
raises: there is no fallback. The kernels round as the plain chain does
(see the source), so RoPE and silu * up are bit-equal to it; the norm's
fp32 sum of squares runs in another order, and may move the normalised
value by one ulp of the type. Every entry point takes bf16 (the model's
type on the card) or fp32, all operands of one type (the tables fp32), and
its sizes from the shapes. On the card the kernels move 16-byte packs: a
row, a half head (D / 2) and every stride a whole number of packs (8 bf16
or 4 fp32 values), every operand on a 16-byte boundary, as every model
width and fresh tensor is; anything else is refused (ValueError). A
position outside the tables stops the RoPE kernel (a device trap, as
PyTorch's gather stops at an index out of range).
``<entry point>.launches`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build

_SOURCE = "layer_glue.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HIDDEN = 16384   # a norm row: 1024 threads x 16 values


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _dtype_code(what: str, x: torch.Tensor, *others) -> int:
    """The kernel's code for x's dtype; every other operand must share
    x's dtype and device."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} takes bf16 or fp32, got {x.dtype}")
    for o in others:
        if o.dtype != x.dtype or o.device != x.device:
            raise ValueError(f"{what}: operands of {x.dtype} on {x.device} "
                             f"and {o.dtype} on {o.device}")
    return _DTYPES[x.dtype]


def _pack(x: torch.Tensor) -> int:
    """Values of x's dtype in one 16-byte pack."""
    return 16 // x.element_size()


def _check_packs(what: str, sizes, tensors) -> None:
    """Every size (in values) a whole number of 16-byte packs and every
    tensor's data on a 16-byte boundary, or ValueError."""
    v = _pack(tensors[0])
    if any(n % v for n in sizes) \
            or any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what} moves 16-byte packs of {v} values: sizes "
                         f"and strides {list(sizes)} must be multiples of "
                         f"{v} and every operand 16-byte aligned")


# ---------------------------------------------------------------------------
# Residual add + RMSNorm
# ---------------------------------------------------------------------------

def add_rms_norm_plain(x, y, w, eps: float):
    """``x = x + y`` (y None: x unchanged), then the RMSNorm of x with gain
    w: the mean of squares in fp32, the normalised value rounded to x's
    dtype before the gain. -> (x, h)."""
    if y is not None:
        x = x + y
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return x, w * (xf * torch.rsqrt(var + eps)).to(x.dtype)


def add_rms_norm(x, y, w, eps: float):
    """Residual add + RMSNorm over the last axis of x [..., hidden] (one
    kernel launch); see the module docstring. -> (x + y, h)."""
    if x.device.type == "cpu":
        return add_rms_norm_plain(x, y, w, eps)
    operands = (w,) if y is None else (w, y)
    code = _dtype_code("add_rms_norm", x, *operands)
    hidden = x.shape[-1]
    if w.shape != (hidden,) or not w.is_contiguous() \
            or not x.is_contiguous() \
            or (y is not None and (y.shape != x.shape
                                   or not y.is_contiguous())):
        raise ValueError(f"add_rms_norm takes contiguous x and y of one "
                         f"shape and w [hidden]; got x {tuple(x.shape)}, y "
                         f"{None if y is None else tuple(y.shape)}, w "
                         f"{tuple(w.shape)}")
    if hidden > MAX_HIDDEN:
        raise ValueError(f"add_rms_norm holds a row of at most {MAX_HIDDEN} "
                         f"values, got {hidden}")
    _check_packs("add_rms_norm", (hidden,),
                 (x, w) if y is None else (x, w, y))
    xo = x if y is None else torch.empty_like(x)
    h = torch.empty_like(x)
    err = _build.lib(_SOURCE).tf_add_rms_norm(
        x.data_ptr(), None if y is None else y.data_ptr(), w.data_ptr(),
        xo.data_ptr(), h.data_ptr(), x.numel() // max(hidden, 1), hidden,
        float(np.float32(1.0) / np.float32(hidden)), eps, code,
        _stream(x.device))
    _build.check(err, "add_rms_norm kernel launch")
    add_rms_norm.launches += 1
    return xo, h


add_rms_norm.launches = 0


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def rope_plain(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` ([..., T, D]) at ``positions`` ([T] long, on x's device);
    table rows are cast to x's dtype before the product, like the JAX
    package. ``positions`` [B, T] rotates each row of ``x`` [B, H, T, D] at
    its own positions."""
    if positions.dim() == 2:
        c = cos[positions][:, None].to(x.dtype)       # [B, 1, T, D]
        s = sin[positions][:, None].to(x.dtype)
    else:
        c = cos.index_select(0, positions).to(x.dtype)
        s = sin.index_select(0, positions).to(x.dtype)
    return x * c + rotate_half(x) * s


def _check_rope(xs, cos, sin, positions):
    if not 1 <= len(xs) <= 2:
        raise ValueError(f"rope takes one or two tensors, got {len(xs)}")
    b, t, d = xs[0].shape[0], xs[0].shape[-2], xs[0].shape[-1]
    for x in xs:
        if x.dim() != 4 or x.shape[0] != b or x.shape[2:] != (t, d) \
                or x.stride(3) != 1 or d % 2:
            raise ValueError(f"rope takes [B, H, T, D] tensors with one B, "
                             f"T and even D and unit D stride; got "
                             f"{tuple(x.shape)} {x.stride()}")
    for name, tab in (("cos", cos), ("sin", sin)):
        if tab.dtype != torch.float32 or tab.dim() != 2 \
                or tab.shape[1] != d or not tab.is_contiguous() \
                or tab.device != xs[0].device:
            raise ValueError(f"rope's {name} table must be a contiguous fp32 "
                             f"[S, {d}] on the tensors' device")
    if cos.shape != sin.shape:
        raise ValueError("rope's cos and sin tables differ in shape")
    if positions.dtype != torch.int64 or positions.device != xs[0].device \
            or not positions.is_contiguous() \
            or positions.shape not in ((t,), (b, t)):
        raise ValueError(f"rope's positions must be contiguous int64 [T] or "
                         f"[B, T] on the tensors' device, got "
                         f"{positions.dtype} {tuple(positions.shape)}")


def rope(xs, cos, sin, positions):
    """RoPE on each tensor of ``xs`` (one or two, [B, H, T, D]) at
    ``positions`` ([T] or [B, T] int64), one kernel launch for all of them;
    ``cos`` / ``sin`` the fp32 [S, D] tables. -> tuple of the rotated
    tensors (contiguous on the card)."""
    xs = tuple(xs)
    if xs[0].device.type == "cpu":
        return tuple(rope_plain(x, cos, sin, positions) for x in xs)
    code = _dtype_code("rope", *xs)
    _check_rope(xs, cos, sin, positions)
    _check_packs("rope", [xs[0].shape[-1] // 2]
                 + [s for x in xs for s in x.stride()[:3]], (*xs, cos, sin))
    outs = tuple(torch.empty(x.shape, dtype=x.dtype, device=x.device)
                 for x in xs)
    b, _, t, d = xs[0].shape
    args = []
    for x, out in zip(xs, outs):
        args += [x.data_ptr(), out.data_ptr(), x.stride(0), x.stride(1),
                 x.stride(2), x.shape[1]]
    if len(xs) == 1:
        args += [None, None, 0, 0, 0, 0]
    pos_sb = t if positions.dim() == 2 else 0
    err = _build.lib(_SOURCE).tf_rope(
        *args, positions.data_ptr(), pos_sb, cos.data_ptr(), sin.data_ptr(),
        cos.shape[0], b, t, d, code, _stream(xs[0].device))
    _build.check(err, "rope kernel launch")
    rope.launches += 1
    return outs


rope.launches = 0


# ---------------------------------------------------------------------------
# SiLU(gate) * up
# ---------------------------------------------------------------------------

def silu_mul_plain(gate, up):
    return F.silu(gate) * up


def silu_mul(gate, up):
    """``silu(gate) * up`` in one kernel launch (contiguous operands of one
    shape and dtype)."""
    if gate.device.type == "cpu":
        return silu_mul_plain(gate, up)
    code = _dtype_code("silu_mul", gate, up)
    if gate.shape != up.shape or not gate.is_contiguous() \
            or not up.is_contiguous():
        raise ValueError(f"silu_mul takes contiguous gate and up of one "
                         f"shape; got {tuple(gate.shape)} "
                         f"{tuple(up.shape)}")
    _check_packs("silu_mul", (gate.numel(),), (gate, up))
    out = torch.empty_like(gate)
    err = _build.lib(_SOURCE).tf_silu_mul(
        gate.data_ptr(), up.data_ptr(), out.data_ptr(), gate.numel(), code,
        _stream(gate.device))
    _build.check(err, "silu_mul kernel launch")
    silu_mul.launches += 1
    return out


silu_mul.launches = 0
