"""Sharding rules for params, caches and decode state — the port of
``triforce_tpu/parallel/sharding.py``.

The JAX package annotates each leaf with a ``NamedSharding`` and GSPMD
places it. Here a ``Sharding`` is the same pair (a mesh and a ``Spec``,
one mesh axis or None per dimension, like ``PartitionSpec``) read as this
rank's slice of the leaf: ``take`` cuts a full tensor to it and
``local_shape`` gives its shape. The rules are JAX's:

  - Q/K/V, gate and up are split by column over ``tp``, O and down by
    row (the forwards then ``all_reduce`` the two row-parallel products);
  - the lm_head is split over the vocabulary (the logits are gathered);
  - an int8 weight's ``_scale`` plane follows its weight's output axis;
  - a dimension that does not divide by ``tp`` stays whole (replicated);
  - KV caches split heads over ``tp`` and, with ``shard_seq``, slots over
    ``sp``; the retrieval cache splits heads only; the drafter, its cache
    and the scalars are replicated;
  - a row-stacked state (batched speculation, serving slots) splits its
    rows in contiguous blocks over ``dp``, every other axis as above
    (``batched_state_shardings``, ``row_block``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..config import ModelConfig


class Spec(tuple):
    """One mesh axis name (or None) per tensor dimension; trailing
    dimensions left out are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """This rank's slice of a tensor split by ``spec`` over ``mesh``."""
    mesh: Any
    spec: Spec

    def _parts(self, dim: int):
        axis = self.spec[dim] if dim < len(self.spec) else None
        if axis is None:
            return 1, 0
        return self.mesh.shape[axis], self.mesh.index(axis)

    def local_shape(self, shape) -> tuple:
        out = []
        for dim, n in enumerate(shape):
            parts, _ = self._parts(dim)
            if n % parts:
                raise ValueError(f"dimension {dim} of {tuple(shape)} does "
                                 f"not divide over {parts}")
            out.append(n // parts)
        return tuple(out)

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the full tensor ``x`` (a view)."""
        for dim in range(x.dim()):
            parts, i = self._parts(dim)
            if parts > 1:
                n = x.shape[dim] // parts
                x = x.narrow(dim, i * n, n)
        return x

    def row(self) -> "Sharding":
        """The sharding of one entry of the leading axis (one layer of a
        stacked [L, ...] weight)."""
        return Sharding(self.mesh, Spec(*self.spec[1:]))


def lookup(shardings, name: str) -> Sharding:
    """The ``Sharding`` of param ``name`` ("embed", "layers.wq", ...) in a
    tree from ``param_shardings``; a missing one raises."""
    node = shardings
    for part in name.split("."):
        node = node.get(part) if isinstance(node, dict) else None
    if not isinstance(node, Sharding):
        raise ValueError(f"shardings has no entry for param {name!r}")
    return node


def _tp_rule(mesh, tp: int):
    def s(dims, *spec):
        spec = tuple(ax if (ax is None or dims[i] % tp == 0) else None
                     for i, ax in enumerate(spec))
        return Sharding(mesh, Spec(*spec))
    return s


def param_shardings(mesh, cfg: ModelConfig, weight_quant: bool = False):
    """A tree of ``Sharding`` in the shape of ``llama.init_params``'s
    params (plus the int8 ``_scale`` leaves with ``weight_quant``),
    ``sharding.py:23-69``: any dimension that does not divide by the tp
    size stays whole."""
    s = _tp_rule(mesh, mesh.shape["tp"])
    h, inter = cfg.hidden_size, cfg.intermediate_size
    hq = cfg.num_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim
    L, v = cfg.num_layers, cfg.vocab_size
    layers = {
        "wq": s((L, h, hq), None, None, "tp"),    # column-parallel
        "wk": s((L, h, hkv), None, None, "tp"),
        "wv": s((L, h, hkv), None, None, "tp"),
        "wo": s((L, hq, h), None, "tp", None),    # row-parallel
        "w_gate": s((L, h, inter), None, None, "tp"),
        "w_up": s((L, h, inter), None, None, "tp"),
        "w_down": s((L, inter, h), None, "tp", None),
        "ln_attn": s((L, h), None, None),
        "ln_mlp": s((L, h), None, None),
    }
    out = {
        "embed": s((v, h), None, None),
        "layers": layers,
        "final_norm": s((h,), None),
        "lm_head": s((h, v), None, "tp"),   # vocab-split; logits gathered
    }
    if weight_quant:
        # int8 scale planes shard like their weight's OUTPUT axis
        layers.update({
            "wq_scale": s((L, hq), None, "tp"),
            "wk_scale": s((L, hkv), None, "tp"),
            "wv_scale": s((L, hkv), None, "tp"),
            "wo_scale": s((L, h), None, None),      # row-parallel: out repl.
            "w_gate_scale": s((L, inter), None, "tp"),
            "w_up_scale": s((L, inter), None, "tp"),
            "w_down_scale": s((L, h), None, None),
        })
        out["lm_head_scale"] = s((v,), "tp")
    return out


def is_split(sh: Sharding) -> bool:
    """Whether a param's sharding splits it over ``tp`` (a row-parallel
    weight's product then needs an ``all_reduce``, a vocabulary-split
    lm_head's logits a gather), at every tp size, 1 included."""
    return "tp" in sh.spec


def _check_heads(mesh, cfg: ModelConfig) -> None:
    tp = mesh.shape["tp"]
    if cfg.num_kv_heads % tp:
        raise ValueError(f"num_kv_heads {cfg.num_kv_heads} not divisible by "
                         f"tp={tp}; use sp for sequence sharding instead")


def kv_shardings(mesh, cfg: ModelConfig, shard_seq: bool = False):
    """A [L, B, Hkv, S, D] cache: heads over tp and, with ``shard_seq``,
    slots over sp (``sharding.py:72-87``). Needs num_kv_heads % tp == 0."""
    _check_heads(mesh, cfg)
    return Sharding(mesh, Spec(None, None, "tp", "sp" if shard_seq else None,
                               None))


def scale_shardings(mesh, cfg: ModelConfig, shard_seq: bool = False):
    """An int8 cache's [L, B, Hkv, S] scale planes: the codes' axes."""
    _check_heads(mesh, cfg)
    return Sharding(mesh, Spec(None, None, "tp", "sp" if shard_seq else None))


@dataclasses.dataclass(frozen=True)
class StateShardings:
    """The shardings of a ``TriForceState``'s caches, by plane name
    (``k``, ``v`` and, int8, ``k_scale``, ``v_scale``); the drafter cache,
    the next token and the generator are replicated."""
    kv: dict
    rkv: dict
    dkv: dict


def state_shardings(mesh, target_cfg: ModelConfig, draft_cfg=None,
                    shard_seq: bool = False, quant: bool = False):
    """The shardings of a ``TriForceState`` (``sharding.py:104-123``): the
    full cache as ``kv_shardings``, the retrieval cache (budget + gamma + 1
    slots) over heads only, the drafter's replicated."""
    full = kv_shardings(mesh, target_cfg, shard_seq)
    rkv = kv_shardings(mesh, target_cfg, False)
    rep = Sharding(mesh, Spec())
    kv, r = dict(k=full, v=full), dict(k=rkv, v=rkv)
    if quant:
        kv.update(k_scale=scale_shardings(mesh, target_cfg, shard_seq),
                  v_scale=scale_shardings(mesh, target_cfg, shard_seq))
        rs = scale_shardings(mesh, target_cfg, False)
        r.update(k_scale=rs, v_scale=rs)
    return StateShardings(kv=kv, rkv=r, dkv=dict(k=rep, v=rep))


def tree_state_shardings(mesh, cfg: ModelConfig, shard_seq: bool = False,
                         quant: bool = False) -> dict:
    """The shardings of a ``TreeState``'s caches (``spectree.py:248-266``):
    the full cache as ``kv_shardings(shard_seq)``, the tree retrieval cache
    (budget + tree slots) over heads only. Returns {"kv": planes, "rkv":
    planes}, planes by name as in ``StateShardings``."""
    full = kv_shardings(mesh, cfg, shard_seq)
    rkv = kv_shardings(mesh, cfg, False)
    kv, r = dict(k=full, v=full), dict(k=rkv, v=rkv)
    if quant:
        kv.update(k_scale=scale_shardings(mesh, cfg, shard_seq),
                  v_scale=scale_shardings(mesh, cfg, shard_seq))
        rs = scale_shardings(mesh, cfg, False)
        r.update(k_scale=rs, v_scale=rs)
    return dict(kv=kv, rkv=r)


def _with_rows(sh: Sharding) -> Sharding:
    """A batch-1 cache's sharding -> its row-stacked cache's: the rows
    lead and take the batch axis's place ([rows, L, Hkv, S(, D)])."""
    return Sharding(sh.mesh, Spec("dp", *(sh.spec[:1] + sh.spec[2:])))


def batched_state_shardings(mesh, target_cfg: ModelConfig, draft_cfg=None,
                            shard_seq: bool = False, quant: bool = False):
    """The shardings of a row-stacked state (``sharding.py:126-137``): a
    leading row axis split over ``dp`` (JAX's ``P("dp")``: contiguous
    blocks), every other axis as ``state_shardings``. The port's
    row-stacked caches have no batch axis of their own
    ([rows, L, Hkv, S, D], ``cache.py``), where JAX stacks [B, L, 1, ...]."""
    base = state_shardings(mesh, target_cfg, draft_cfg, shard_seq, quant)
    return StateShardings(**{
        name: {k: _with_rows(v) for k, v in getattr(base, name).items()}
        for name in ("kv", "rkv", "dkv")})


def row_block(mesh, rows: int) -> range:
    """The rows of a ``rows``-row stacked state this rank holds: the
    ``dp`` axis's contiguous block of them (all of them without a mesh).
    ``rows`` must divide over ``dp``."""
    if mesh is None:
        return range(rows)
    dp = mesh.shape["dp"]
    if rows % dp:
        raise ValueError(f"{rows} rows do not divide over dp={dp}")
    n = rows // dp
    i = mesh.index("dp")
    return range(i * n, (i + 1) * n)


def shard_tree(params, shardings, device=None):
    """Full ``params`` with every leaf cut to this rank's slice by its
    ``Sharding`` (``Sharding.take``), made contiguous on ``device``. A
    leaf without a sharding raises."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = shard_tree(v, shardings.get(k, {}), device)
            continue
        sh = shardings.get(k)
        if sh is None:
            raise ValueError(f"no sharding for param {k!r}")
        out[k] = sh.take(v).to(device if device is not None
                               else v.device).contiguous()
    return out


def is_local(params, mesh, cfg: ModelConfig) -> bool:
    """Whether ``params`` are already this rank's slices (loaded with
    ``shardings=``) rather than the full weights: the K projection's
    columns tell (at tp 1 the two are the same)."""
    full = cfg.num_kv_heads * cfg.head_dim
    return params["layers"]["wk"].shape[-1] != full \
        or mesh.shape["tp"] == 1


def shard_params(params, mesh, cfg: ModelConfig):
    """Cut full params to this rank's slices on the mesh's device
    (``sharding.py:140-143``); int8 params bring their scale planes."""
    quant = "lm_head_scale" in params
    return shard_tree(params, param_shardings(mesh, cfg, weight_quant=quant),
                      mesh.device)
