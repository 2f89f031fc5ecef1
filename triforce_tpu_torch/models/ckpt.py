"""Native checkpoints — the port of ``triforce_tpu/models/ckpt.py``,
without orbax: the stacked params written once by ``safetensors_io``, so
that a later start reads them straight into place instead of converting
the HF checkpoint again.

Layout on disk::

    <dir>/triforce_config.json   ModelConfig (incl. RopeConfig) as JSON
    <dir>/params.safetensors     the params dict, flattened: "embed",
                                 "layers.wq", ..., "lm_head"; int8 codes
                                 and their fp32 "..._scale" planes as they
                                 are
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

from ..config import ModelConfig, RopeConfig, resolve_device
from ..parallel.sharding import lookup
from . import hf
from .safetensors_io import SafeFile, save_file

_CFG_FILE = "triforce_config.json"
_PARAMS_FILE = "params.safetensors"


def is_native_checkpoint(path: str) -> bool:
    return os.path.isfile(os.path.join(path, _CFG_FILE))


def _cfg_from_dict(d: dict) -> ModelConfig:
    rope = RopeConfig(**d.pop("rope"))
    return ModelConfig(rope=rope, **d)


def _flatten(params) -> dict:
    out = {}
    for k, v in params.items():
        if k == "layers":
            out.update({f"layers.{n}": w for n, w in v.items()})
        else:
            out[k] = v
    return out


def save_checkpoint(path: str, cfg: ModelConfig, params) -> None:
    """Write ``params`` plus its ModelConfig. An existing checkpoint is
    replaced whole: the params go to a temporary file renamed into place,
    and the config, which ``is_native_checkpoint`` keys on, is written
    last, so a crash mid-save never leaves a directory the loader accepts
    but cannot read."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    dst = os.path.join(path, _PARAMS_FILE)
    save_file(_flatten(params), dst + ".tmp", metadata={"format": "pt"})
    os.replace(dst + ".tmp", dst)
    with open(os.path.join(path, _CFG_FILE), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)


def read_config(path: str) -> ModelConfig:
    """The ModelConfig of a native checkpoint."""
    with open(os.path.join(os.path.abspath(path), _CFG_FILE)) as f:
        return _cfg_from_dict(json.load(f))


def load_checkpoint(path: str, dtype=None, shardings=None, device=None,
                    ) -> Tuple[ModelConfig, dict]:
    """Read (ModelConfig, params) onto the device one tensor at a time.
    ``dtype``: the compute dtype the caller runs in — every floating leaf
    but the fp32 ``_scale`` planes is converted to it (None keeps what was
    saved); int8 codes stay int8. ``shardings`` (a tree from
    ``parallel.sharding.param_shardings``, ``weight_quant=True`` for a
    checkpoint of int8 codes): each tensor is cut to this rank's slice on
    the host before it moves to the device."""
    dev = resolve_device(device)
    path = os.path.abspath(path)
    cfg = read_config(path)
    dt = None if dtype is None else hf.torch_dtype(dtype)
    params = {"layers": {}}
    with SafeFile(os.path.join(path, _PARAMS_FILE)) as sf:
        for name in sf.keys():
            t = sf.get(name)
            if shardings is not None:
                t = lookup(shardings, name).take(t).contiguous()
            t = t.to(dev)
            if dt is not None and t.is_floating_point() \
                    and not name.endswith("_scale"):
                t = t.to(dt)
            if name.startswith("layers."):
                params["layers"][name.removeprefix("layers.")] = t
            else:
                params[name] = t
    return cfg, params


def convert_hf(model_dir: str, out_dir: str, dtype="bfloat16",
               rope_on_slots: bool = False, shardings=None, device=None,
               ) -> Tuple[ModelConfig, dict]:
    """HF -> native in one go: load the HF checkpoint (streamed from
    safetensors, or read eagerly from .bin files), save it natively and
    return what was loaded, so conversion doubles as a load."""
    kw = dict(dtype=dtype, rope_on_slots=rope_on_slots, device=device)
    try:
        cfg, params = hf.load_params_streaming(
            model_dir, shardings=shardings, **kw)
    except FileNotFoundError as e:
        if "no safetensors shards" not in str(e):
            raise
        cfg, params = hf.load_params(model_dir, **kw)
    save_checkpoint(out_dir, cfg, params)
    return cfg, params
