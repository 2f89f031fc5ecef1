"""HF checkpoint ingestion — the port of ``triforce_tpu/models/hf.py``:
config translation and weight conversion into the stacked params dict of
``models/llama.py``.

Weights are read with the port's own safetensors reader
(``safetensors_io``; the card's machine has neither ``safetensors`` nor
``transformers``), or with ``torch.load(weights_only=True)`` for ``.bin``
shards, transposed once from HF's ``[out, in]`` to the ``[in, out]`` layout
the forwards use (``x @ w``), and stacked ``[L, ...]`` per layer: the dict
that ``llama.init_params`` and ``llama.params_from_numpy`` build.

Every loader runs on the card unless the caller passes ``device="cpu"``.
``load_params_streaming(shardings=)`` (a tree from
``parallel.sharding.param_shardings``, made from ``read_config``) keeps
only this rank's slice of each tensor: cut on the host as it is read, so
the device holds the rank's shards alone and the host one tensor at a
time.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import torch

from ..config import ModelConfig, RopeConfig, resolve_device
from ..parallel.sharding import lookup
from .safetensors_io import SafeFile, save_file

_LAYER = "model.layers.{}."
# params key -> (HF name pattern, transposed from [out, in])
_LAYER_SPECS = {
    "wq": (_LAYER + "self_attn.q_proj.weight", True),
    "wk": (_LAYER + "self_attn.k_proj.weight", True),
    "wv": (_LAYER + "self_attn.v_proj.weight", True),
    "wo": (_LAYER + "self_attn.o_proj.weight", True),
    "w_gate": (_LAYER + "mlp.gate_proj.weight", True),
    "w_up": (_LAYER + "mlp.up_proj.weight", True),
    "w_down": (_LAYER + "mlp.down_proj.weight", True),
    "ln_attn": (_LAYER + "input_layernorm.weight", False),
    "ln_mlp": (_LAYER + "post_attention_layernorm.weight", False),
}


def torch_dtype(dtype) -> torch.dtype:
    """A dtype given as a torch dtype or by name ("bfloat16")."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out


def config_from_hf(cfg: dict, rope_on_slots: bool = False) -> ModelConfig:
    """Translate an HF Llama ``config.json`` dict, its ``rope_scaling``
    included (the kind under ``rope_type`` or, in older configs, ``type``).

    ``rope_on_slots``: set for DRAFTER checkpoints — it selects the
    StreamingLLM whole-window re-rotation (un-rotated key storage), a
    choice made at load time that no HF config field encodes."""
    rs = cfg.get("rope_scaling") or {}
    kind = rs.get("rope_type", rs.get("type", "llama"))
    if kind in ("yarn", "dynamic-yarn", "ntk-by-parts", "linear", "dynamic"):
        rope = RopeConfig(
            kind=kind,
            theta=float(cfg.get("rope_theta", 10000.0)),
            scaling_factor=float(rs.get("factor", 1.0)),
            original_max_position_embeddings=int(
                rs.get("original_max_position_embeddings", 4096)),
            beta_fast=float(rs.get("beta_fast", 32.0)),
            beta_slow=float(rs.get("beta_slow", 1.0)),
            extrapolation_factor=float(rs.get("extrapolation_factor", 1.0)),
            attn_factor=float(rs.get("attn_factor", 1.0)),
        )
    else:
        rope = RopeConfig(kind="llama",
                          theta=float(cfg.get("rope_theta", 10000.0)))
    num_heads = int(cfg["num_attention_heads"])
    return ModelConfig(
        vocab_size=int(cfg["vocab_size"]),
        hidden_size=int(cfg["hidden_size"]),
        intermediate_size=int(cfg["intermediate_size"]),
        num_layers=int(cfg["num_hidden_layers"]),
        num_heads=num_heads,
        num_kv_heads=int(cfg.get("num_key_value_heads", num_heads)),
        head_dim=int(cfg["hidden_size"]) // num_heads,
        max_position_embeddings=int(cfg.get("max_position_embeddings", 4096)),
        rms_norm_eps=float(cfg.get("rms_norm_eps", 1e-5)),
        rope=rope,
        rope_on_slots=rope_on_slots,
        tie_word_embeddings=bool(cfg.get("tie_word_embeddings", False)),
    )


def _read_config(model_dir: str, cfg: Optional[ModelConfig],
                 rope_on_slots: bool) -> ModelConfig:
    if cfg is not None:
        return cfg
    return read_config(model_dir, rope_on_slots)


def read_config(model_dir: str, rope_on_slots: bool = False) -> ModelConfig:
    """The ModelConfig of an HF checkpoint directory (``config.json``)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        return config_from_hf(json.load(f), rope_on_slots=rope_on_slots)


def _read_state_dict(model_dir: str) -> dict:
    """Every tensor of a local HF checkpoint directory on the CPU:
    safetensors shards preferred, torch ``.bin`` shards otherwise."""
    st_files = sorted(f for f in os.listdir(model_dir)
                      if f.endswith(".safetensors"))
    out = {}
    if st_files:
        for name in st_files:
            with SafeFile(os.path.join(model_dir, name)) as sf:
                for k in sf.keys():
                    out[k] = sf.get(k)
        return out
    bin_files = sorted(f for f in os.listdir(model_dir)
                       if f.endswith(".bin") and "pytorch_model" in f)
    if not bin_files:
        raise FileNotFoundError(
            f"no safetensors/bin checkpoint shards in {model_dir}")
    for name in bin_files:
        out.update(torch.load(os.path.join(model_dir, name),
                              map_location="cpu", weights_only=True))
    return out


def _lookup(names, name: str) -> str:
    """``name`` as the checkpoint spells it: some exports drop the
    ``model.`` prefix."""
    if name in names:
        return name
    alt = name.removeprefix("model.")
    if alt in names:
        return alt
    raise KeyError(f"tensor {name!r} is not in the checkpoint")


def load_params(model_dir: str, dtype="bfloat16",
                cfg: Optional[ModelConfig] = None,
                rope_on_slots: bool = False, device=None,
                ) -> Tuple[ModelConfig, dict]:
    """Load a local HF Llama checkpoint into (ModelConfig, params), reading
    the whole state dict on the host first (``load_params_streaming``
    holds one tensor at a time)."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    cfg = _read_config(model_dir, cfg, rope_on_slots)
    sd = _read_state_dict(model_dir)

    def get(name: str) -> torch.Tensor:
        return sd[_lookup(sd, name)]

    def put(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=dev, dtype=dt).contiguous()

    layers = {}
    for key, (fmt, tr) in _LAYER_SPECS.items():
        rows = [get(fmt.format(i)) for i in range(cfg.num_layers)]
        layers[key] = put(torch.stack([r.T if tr else r for r in rows]))
    params = {"embed": put(get("model.embed_tokens.weight")),
              "layers": layers,
              "final_norm": put(get("model.norm.weight"))}
    if cfg.tie_word_embeddings or "lm_head.weight" not in sd:
        params["lm_head"] = params["embed"].T
    else:
        params["lm_head"] = put(get("lm_head.weight").T)
    return cfg, params


def _tensor_file_map(model_dir: str) -> dict:
    """Tensor name -> safetensors shard path: through
    ``model.safetensors.index.json``'s weight map where there is one, else
    from each shard's header (the payload is not read)."""
    idx = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.isfile(idx):
        with open(idx) as f:
            wm = json.load(f)["weight_map"]
        return {k: os.path.join(model_dir, v) for k, v in wm.items()}
    out = {}
    for name in sorted(os.listdir(model_dir)):
        if not name.endswith(".safetensors"):
            continue
        p = os.path.join(model_dir, name)
        with SafeFile(p) as sf:
            for k in sf.keys():
                out[k] = p
    if not out:
        raise FileNotFoundError(
            f"no safetensors shards in {model_dir} (streaming load needs "
            f"safetensors; for torch .bin checkpoints use load_params)")
    return out


def load_params_streaming(model_dir: str, dtype="bfloat16",
                          cfg: Optional[ModelConfig] = None,
                          rope_on_slots: bool = False, shardings=None,
                          device=None) -> Tuple[ModelConfig, dict]:
    """Stream a (sharded) HF safetensors checkpoint into the stacked params
    without the whole state dict on the host: each stacked leaf is
    allocated once on the device and filled one layer at a time, each
    tensor read, moved to the device, then transposed and converted there.
    The host holds one tensor at a time. ``shardings``: each tensor is cut
    to this rank's slice on the host before it moves (module docstring)."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    cfg = _read_config(model_dir, cfg, rope_on_slots)
    fmap = _tensor_file_map(model_dir)
    files = {}

    def read(name: str, tr: bool = False, key=None,
             layer: bool = False) -> torch.Tensor:
        name = _lookup(fmap, name)
        path = fmap[name]
        if path not in files:
            files[path] = SafeFile(path)
        t = files[path].get(name)
        t = t.T if tr else t
        if shardings is not None:
            sh = lookup(shardings, "layers." + key if layer else key)
            t = (sh.row() if layer else sh).take(t).contiguous()
        return t.to(dev)

    def put(t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(t.shape, dtype=dt, device=dev)
        out.copy_(t)
        return out

    def stream_stack(key: str, fmt: str, tr: bool) -> torch.Tensor:
        buf = None
        for i in range(cfg.num_layers):
            row = read(fmt.format(i), tr, key, True)
            if buf is None:
                buf = torch.empty((cfg.num_layers,) + tuple(row.shape),
                                  dtype=dt, device=dev)
            buf[i].copy_(row)
            del row
        return buf

    try:
        params = {
            "embed": put(read("model.embed_tokens.weight", key="embed")),
            "layers": {k: stream_stack(k, fmt, tr)
                       for k, (fmt, tr) in _LAYER_SPECS.items()},
            "final_norm": put(read("model.norm.weight", key="final_norm")),
        }
        if cfg.tie_word_embeddings or "lm_head.weight" not in fmap:
            params["lm_head"] = params["embed"].T
            if shardings is not None:
                params["lm_head"] = lookup(shardings, "lm_head").take(
                    params["lm_head"]).contiguous()
        else:
            params["lm_head"] = put(read("lm_head.weight", True, "lm_head"))
    finally:
        for f in files.values():
            f.close()
    return cfg, params


def config_to_hf(cfg: ModelConfig) -> dict:
    """The inverse of ``config_from_hf``: an HF Llama ``config.json`` dict
    (``rope_scaling`` under the older ``type`` key, with the YaRN knobs
    that differ from their defaults)."""
    out = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
           "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
           "intermediate_size": cfg.intermediate_size,
           "num_hidden_layers": cfg.num_layers,
           "num_attention_heads": cfg.num_heads,
           "num_key_value_heads": cfg.num_kv_heads,
           "max_position_embeddings": cfg.max_position_embeddings,
           "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope.theta,
           "tie_word_embeddings": cfg.tie_word_embeddings,
           "rope_scaling": None}
    if cfg.head_dim * cfg.num_heads != cfg.hidden_size:
        raise ValueError("HF Llama configs imply head_dim = hidden / heads")
    if cfg.rope.kind != "llama":
        rs = {"type": cfg.rope.kind, "factor": cfg.rope.scaling_factor,
              "original_max_position_embeddings":
                  cfg.rope.original_max_position_embeddings}
        default = RopeConfig()
        for key in ("beta_fast", "beta_slow", "extrapolation_factor",
                    "attn_factor"):
            if getattr(cfg.rope, key) != getattr(default, key):
                rs[key] = getattr(cfg.rope, key)
        out["rope_scaling"] = rs
    return out


def save_params(model_dir: str, cfg: ModelConfig, params,
                shards: int = 1) -> None:
    """Write params as an HF-layout checkpoint: ``config.json`` and
    ``[out, in]`` tensors under HF names, in ``shards`` safetensors files
    (with ``model.safetensors.index.json`` when more than one). The inverse
    of ``load_params``; the weights must not be int8 codes."""
    if params["lm_head"].dtype == torch.int8:
        raise ValueError("int8 codes have no HF layout; save the weights "
                         "before quantize_weights")
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config_to_hf(cfg), f, indent=1)
    groups = [[("model.embed_tokens.weight", params["embed"])]]
    for i in range(cfg.num_layers):
        groups.append([(fmt.format(i), params["layers"][k][i].T
                        if tr else params["layers"][k][i])
                       for k, (fmt, tr) in _LAYER_SPECS.items()])
    groups.append([("model.norm.weight", params["final_norm"])])
    if not cfg.tie_word_embeddings:
        groups[-1].append(("lm_head.weight", params["lm_head"].T))
    # whole layers per shard, as HF exports cut them
    per = -(-len(groups) // shards)
    weight_map = {}
    for s in range(shards):
        name = "model.safetensors" if shards == 1 else \
            f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
        tensors = {n: t.contiguous() for g in groups[s * per:(s + 1) * per]
                   for n, t in g}
        save_file(tensors, os.path.join(model_dir, name),
                  metadata={"format": "pt"})
        weight_map.update(dict.fromkeys(tensors, name))
    if shards > 1:
        with open(os.path.join(model_dir, "model.safetensors.index.json"),
                  "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f,
                      indent=1)


# The reference's model zoo: name -> HF repo id.
MODEL_ZOO = {
    "llama-7b-128k": "NousResearch/Yarn-Llama-2-7b-128k",
    "llama-13b-128k": "NousResearch/Yarn-Llama-2-13b-128k",
    "lwm-128k": "LargeWorldModel/LWM-Text-128K",
    "lwm-chat-128k": "LargeWorldModel/LWM-Text-Chat-128K",
    "llama-68m": "JackFram/llama-68m",
    "tinyllama-1.1b-128k": "NousResearch/Yarn-Llama-2-7b-128k",  # arch proxy
}


def resolve_checkpoint(name_or_dir: str) -> str:
    """A zoo name or a path -> a local checkpoint directory, looked up in
    the HF cache layout. Never downloads: raises with a clear message when
    the checkpoint is not on this machine."""
    if os.path.isdir(name_or_dir):
        return name_or_dir
    repo = MODEL_ZOO.get(name_or_dir, name_or_dir)
    cache = os.environ.get(
        "HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    repo_root = os.path.join(cache, "hub",
                             "models--" + repo.replace("/", "--"))
    snap_root = os.path.join(repo_root, "snapshots")
    if os.path.isdir(snap_root):
        # the revision refs/main points at, else the newest snapshot
        ref = os.path.join(repo_root, "refs", "main")
        if os.path.isfile(ref):
            with open(ref) as f:
                rev = f.read().strip()
            cand = os.path.join(snap_root, rev)
            if os.path.isdir(cand):
                return cand
        snaps = sorted(os.listdir(snap_root),
                       key=lambda s: os.path.getmtime(
                           os.path.join(snap_root, s)))
        if snaps:
            return os.path.join(snap_root, snaps[-1])
    raise FileNotFoundError(
        f"checkpoint {name_or_dir!r} (repo {repo!r}) not found locally; "
        f"download it to the HF cache or pass a directory path")
