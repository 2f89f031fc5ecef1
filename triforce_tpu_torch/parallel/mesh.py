"""Device mesh over ``torch.distributed`` — the port of
``triforce_tpu/parallel/mesh.py``.

The JAX package runs one program over a ``jax.sharding.Mesh`` and lets
GSPMD insert the collectives. Here every rank is a process of its own
(the reference's ``torchrun`` shape): it holds its local shards, runs the
same program as every other rank and issues the collectives itself. Every
rank computes the same tokens (the same seed, the same draws), so nothing
is broadcast. Axes, in JAX's row-major order (rank = (dp * tp_size + tp)
* sp_size + sp):

  dp — data / batch rows
  tp — tensor parallel: attention heads and MLP columns
  sp — sequence parallel: the target's KV cache split along its slots

``Mesh`` keeps each axis's size, this rank's coordinate on it and the
process group of the ranks that differ from this one on that axis alone;
``all_reduce`` runs over one axis. A group of one rank still issues its
collectives: nothing is skipped at world size 1.

The backend is explicit: NCCL on a CUDA device unless the caller names
gloo (several ranks on one card: NCCL puts one rank on a device), gloo
on the CPU. Nothing changes backend on a failure. gloo on CUDA tensors
copies through the host, so it cannot be captured in a CUDA graph: an
engine over such a mesh runs eagerly.
"""

from __future__ import annotations

import collections
import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

AXES = ("dp", "tp", "sp")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Mesh:
    """This rank's view of a (dp, tp, sp) mesh of processes.

    ``shape[axis]`` is the axis's size and ``coords[axis]`` this rank's
    index on it (``index(axis)``); ``groups[axis]`` the process group of
    the ranks that share every other coordinate. ``device`` is where this
    rank's shards live. ``collectives`` counts the collectives issued and
    ``collective_bytes`` their payload, per axis (counted in Python, so a
    replayed CUDA graph adds nothing to them)."""

    def __init__(self, shape: dict, coords: dict, groups: dict,
                 device: torch.device, backend: str):
        self.shape = dict(shape)
        self.coords = dict(coords)
        self.groups = dict(groups)
        self.device = device
        self.backend = backend
        self.collectives = collections.Counter()
        self.collective_bytes = collections.Counter()

    def index(self, axis: str) -> int:
        return self.coords[axis]

    @property
    def capturable(self) -> bool:
        """Whether its collectives can be captured in a CUDA graph."""
        return self.backend == "nccl"

    def all_reduce(self, x: torch.Tensor, axis: str,
                   op: str = "sum") -> torch.Tensor:
        """In-place ``all_reduce`` of a contiguous ``x`` over ``axis``
        (``op`` "sum" or "max"); returns ``x``."""
        if not x.is_contiguous():
            raise ValueError("all_reduce takes a contiguous tensor")
        dist.all_reduce(x, op=_OPS[op], group=self.groups[axis])
        self.collectives[axis] += 1
        self.collective_bytes[axis] += x.numel() * x.element_size()
        return x

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['dp']}, tp={self.shape['tp']}, "
                f"sp={self.shape['sp']}, coords={self.coords}, "
                f"device={self.device}, backend={self.backend})")


def gather_rows(mesh: Mesh, x: torch.Tensor, rows: int) -> torch.Tensor:
    """This rank's block of rows ``x`` [n, ...] (its ``dp`` index's
    contiguous block, ``sharding.row_block``) -> the global [rows, ...] on
    every rank: each rank writes its block into zeros and one
    ``all_reduce(SUM)`` over ``dp`` adds them (adding zeros is exact; gloo
    on CUDA tensors has no ``all_gather``)."""
    n = x.shape[0]
    if n * mesh.shape["dp"] != rows:
        raise ValueError(f"{n} rows a rank over dp={mesh.shape['dp']} are "
                         f"not {rows}")
    full = x.new_zeros((rows,) + tuple(x.shape[1:]))
    i = mesh.index("dp")
    full[i * n:(i + 1) * n] = x
    return mesh.all_reduce(full, "dp")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, device=None,
                     timeout_s: float = 600.0) -> torch.device:
    """Join the process group, one call per process before any mesh
    (``mesh.py:42-61``, ``jax.distributed.initialize``). What is not
    passed is read from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``
    through ``env://``). ``device``: this rank's device, by default
    ``cuda:<LOCAL_RANK>`` (name one to put several ranks on one card, or
    "cpu"); ``backend``: by default NCCL on a CUDA device, gloo on the CPU.
    Returns the rank's device."""
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run on the CPU")
        device = torch.device("cuda", local)
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    backend = backend or default_backend(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL needs a CUDA device")
    if init_method is None:
        init_method = "env://" if "MASTER_ADDR" in os.environ else \
            f"tcp://127.0.0.1:{_free_port()}"
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return device


def make_mesh(tp: int = 1, sp: int = 1, dp: int = 1, device=None) -> Mesh:
    """The (dp, tp, sp) mesh over every rank of the process group (its
    size must be dp * tp * sp). Every rank must call it, in the same order
    as its other collectives: it makes one group per line of each axis and
    runs one collective on each of this rank's groups, so that NCCL's
    communicators exist before any CUDA graph capture. ``device``: this
    rank's device (by default the current CUDA device under NCCL, else the
    CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("call init_distributed first (or "
                           "single_device_mesh)")
    n = dp * tp * sp
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a dp={dp} x tp={tp} x sp={sp} mesh needs {n} "
                         f"ranks, the process group has {world}")
    backend = dist.get_backend()
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if backend == "nccl" else torch.device("cpu")
    device = torch.device(device)
    rank = dist.get_rank()
    shape = dict(dp=dp, tp=tp, sp=sp)

    def coords_of(r):
        return dict(dp=r // (tp * sp), tp=(r // sp) % tp, sp=r % sp)

    def rank_of(c):
        return (c["dp"] * tp + c["tp"]) * sp + c["sp"]

    groups = {}
    for axis in AXES:
        lines = {tuple(rank_of(dict(coords_of(r), **{axis: i}))
                       for i in range(shape[axis])) for r in range(n)}
        for line in sorted(lines):    # every rank makes every group
            g = dist.new_group(list(line), backend=backend)
            if rank in line:
                groups[axis] = g
    coords = coords_of(rank)
    mesh = Mesh(shape, coords, groups, device, backend)
    for axis in AXES:
        mesh.all_reduce(torch.zeros(1, device=device), axis)
    mesh.collectives.clear()
    mesh.collective_bytes.clear()
    return mesh


def single_device_mesh(device=None, backend: Optional[str] = None) -> Mesh:
    """``make_mesh(1, 1, 1)``, joining a process group of one rank first
    if this process is in none (``device`` as in ``init_distributed``)."""
    if not dist.is_initialized():
        device = init_distributed(backend=backend, world_size=1, rank=0,
                                  device=device,
                                  init_method=f"tcp://127.0.0.1:"
                                              f"{_free_port()}")
    return make_mesh(1, 1, 1, device=device)
