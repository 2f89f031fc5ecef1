"""The port's checkpoint loading (``models/safetensors_io.py``,
``models/hf.py``, ``models/ckpt.py``) against ``transformers``, the
``safetensors`` package and the JAX package's loader, offline: a tiny
randomly initialised HF Llama is saved to disk, as in
``tests/test_hf_parity.py``, and read back by both packages.

Tolerances: against transformers 2e-3 (fp32, another attention and RoPE
implementation, as the JAX test allows); against the JAX package on the
same weights 1e-4 (fp32, summation order only); params bit-equal.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triforce_tpu import cache as jcache
from triforce_tpu.models import hf as jhf
from triforce_tpu.models import llama as jl
from triforce_tpu_torch import cache as tcache
from triforce_tpu_torch import config as tcfg
from triforce_tpu_torch.models import ckpt as tckpt
from triforce_tpu_torch.models import hf as thf
from triforce_tpu_torch.models import llama as tl
from triforce_tpu_torch.models import safetensors_io as sio

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

torch.set_num_threads(1)

LEAVES = ("embed", "final_norm", "lm_head")


@pytest.fixture(scope="module")
def hf_checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("hf_tiny")
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg).eval().float()
    model.save_pretrained(str(d))
    return str(d), model


def _leaves(params):
    out = {k: params[k] for k in LEAVES}
    out.update({f"layers.{k}": v for k, v in params["layers"].items()})
    return out


def _assert_params_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert torch.equal(la[k], lb[k]), k


def _logits(cfg, params, ids, max_len=32):
    kv = tcache.init_kv(cfg, max_len, dtype=torch.float32, device="cpu")
    out, _, _ = tl.forward_append(cfg, params, torch.from_numpy(ids), kv)
    return out.numpy()


# --- config translation ---------------------------------------------------

def test_config_translation(hf_checkpoint):
    path, _ = hf_checkpoint
    cfg, params = thf.load_params(path, dtype="float32", device="cpu")
    assert (cfg.vocab_size, cfg.num_layers, cfg.num_kv_heads,
            cfg.head_dim) == (128, 2, 2, 8)
    assert tuple(params["layers"]["wq"].shape) == (2, 32, 32)
    assert tuple(params["layers"]["wk"].shape) == (2, 32, 16)
    assert tuple(params["lm_head"].shape) == (32, 128)
    assert params["embed"].dtype == torch.float32


@pytest.mark.parametrize("key", ["type", "rope_type"])
def test_yarn_config_translation_matches_jax(key):
    hf_cfg = {
        "vocab_size": 32000, "hidden_size": 2048,
        "intermediate_size": 5632, "num_hidden_layers": 22,
        "num_attention_heads": 32, "num_key_value_heads": 4,
        "max_position_embeddings": 131072, "rms_norm_eps": 1e-5,
        "rope_theta": 10000.0,
        "rope_scaling": {key: "yarn", "factor": 64.0,
                         "original_max_position_embeddings": 2048},
    }
    cfg = thf.config_from_hf(hf_cfg)
    assert cfg.rope.kind == "yarn"
    assert cfg.rope.scaling_factor == 64.0
    assert cfg.rope.original_max_position_embeddings == 2048
    # the TinyLlama-1.1B-128K preset is exactly this config
    assert cfg == tcfg.TINYLLAMA_1_1B_128K
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jhf.config_from_hf(hf_cfg))
    drafter = thf.config_from_hf(hf_cfg, rope_on_slots=True)
    assert drafter.rope_on_slots and drafter == cfg.with_(rope_on_slots=True)


# --- against transformers -------------------------------------------------

def test_logits_parity_with_transformers(hf_checkpoint):
    path, model = hf_checkpoint
    cfg, params = thf.load_params_streaming(path, dtype="float32",
                                            device="cpu")
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 24))
    with torch.no_grad():
        want = model(torch.tensor(ids)).logits.numpy()
    np.testing.assert_allclose(_logits(cfg, params, ids), want, atol=2e-3,
                               rtol=2e-3)


def test_incremental_decode_matches_hf(hf_checkpoint):
    """Chunked prefill + 1-token appends equal HF's full forward."""
    path, model = hf_checkpoint
    cfg, params = thf.load_params(path, dtype="float32", device="cpu")
    ids = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 20))
    with torch.no_grad():
        want = model(torch.tensor(ids)).logits.numpy()
    kv = tcache.init_kv(cfg, 32, dtype=torch.float32, device="cpu")
    x = torch.from_numpy(ids)
    _, kv, _ = tl.forward_append(cfg, params, x[:, :9], kv)
    _, kv, _ = tl.forward_append(cfg, params, x[:, 9:16], kv)
    outs = []
    for i in range(16, 20):
        lg, kv, _ = tl.forward_append(cfg, params, x[:, i:i + 1], kv)
        outs.append(lg[0, -1].numpy())
    np.testing.assert_allclose(np.stack(outs), want[0, 16:20], atol=2e-3,
                               rtol=2e-3)


# --- against the JAX package's loader ---------------------------------------

@pytest.mark.parametrize("loader", ["eager", "streaming"])
def test_params_equal_jax_loader(hf_checkpoint, loader):
    path, _ = hf_checkpoint
    jcfg_, jp = jhf.load_params(path, dtype="float32")
    fn = thf.load_params if loader == "eager" else thf.load_params_streaming
    cfg, tp = fn(path, dtype="float32", device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg_)
    jl_ = _leaves(jax.tree.map(np.asarray, jp))
    for k, v in _leaves(tp).items():
        np.testing.assert_array_equal(v.numpy(), jl_[k], err_msg=k)


def test_bf16_params_equal_jax_loader(hf_checkpoint):
    """The fp32 checkpoint rounded to bf16 by both loaders: bit-equal."""
    path, _ = hf_checkpoint
    _, jp = jhf.load_params(path, dtype="bfloat16")
    _, tp = thf.load_params_streaming(path, dtype="bfloat16", device="cpu")
    jl_ = _leaves(jax.tree.map(lambda x: np.asarray(x, np.float32), jp))
    for k, v in _leaves(tp).items():
        assert v.dtype == torch.bfloat16
        np.testing.assert_array_equal(v.float().numpy(), jl_[k], err_msg=k)


def test_logits_equal_jax_forward(hf_checkpoint):
    path, _ = hf_checkpoint
    jcfg_, jp = jhf.load_params(path, dtype="float32")
    cfg, tp = thf.load_params_streaming(path, dtype="float32", device="cpu")
    ids = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, 24))
    kv = jcache.init_kv(jcfg_, max_len=32, dtype=jnp.float32)
    want, _, _ = jl.forward_append(jcfg_, jp, jnp.asarray(ids), kv)
    np.testing.assert_allclose(_logits(cfg, tp, ids), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


# --- loader variants ---------------------------------------------------------

def test_streaming_load_matches_eager(hf_checkpoint):
    path, _ = hf_checkpoint
    cfg_e, eager = thf.load_params(path, dtype="float32", device="cpu")
    cfg_s, streamed = thf.load_params_streaming(path, dtype="float32",
                                                device="cpu")
    assert cfg_s == cfg_e
    _assert_params_equal(eager, streamed)


def _reshard(path, dst, prefix=""):
    """Re-export a one-file checkpoint as two indexed shards (the port's
    writer), optionally renaming every tensor with ``prefix`` dropped."""
    src = [f for f in os.listdir(path) if f.endswith(".safetensors")][0]
    with sio.SafeFile(os.path.join(path, src)) as f:
        tensors = {k: f.get(k) for k in f.keys()}
    names = sorted(tensors)
    half = len(names) // 2
    os.makedirs(dst)
    wm = {}
    for fname, ks in (("model-00001-of-00002.safetensors", names[:half]),
                      ("model-00002-of-00002.safetensors", names[half:])):
        sio.save_file({k.removeprefix(prefix): tensors[k] for k in ks},
                      os.path.join(dst, fname))
        wm.update({k.removeprefix(prefix): fname for k in ks})
    with open(os.path.join(dst, "model.safetensors.index.json"), "w") as f:
        json.dump({"weight_map": wm}, f)
    with open(os.path.join(path, "config.json")) as f:
        cfg = f.read()
    with open(os.path.join(dst, "config.json"), "w") as f:
        f.write(cfg)


@pytest.mark.parametrize("prefix", ["", "model."], ids=["names",
                                                        "no_model_prefix"])
def test_streaming_load_indexed_shards(hf_checkpoint, tmp_path, prefix):
    """Tensors split across two shard files resolve through the weight map
    (with or without the ``model.`` prefix) and load identically."""
    path, _ = hf_checkpoint
    _, ref = thf.load_params(path, dtype="float32", device="cpu")
    d = str(tmp_path / "sharded")
    _reshard(path, d, prefix)
    _, streamed = thf.load_params_streaming(d, dtype="float32", device="cpu")
    _assert_params_equal(ref, streamed)
    _, eager = thf.load_params(d, dtype="float32", device="cpu")
    _assert_params_equal(ref, eager)


def test_bin_fallback_and_tied_head(hf_checkpoint, tmp_path):
    """A torch ``.bin`` checkpoint loads through ``torch.load``; without an
    ``lm_head.weight`` the head is the transposed embedding."""
    path, model = hf_checkpoint
    sd = {k: v for k, v in model.state_dict().items()
          if k != "lm_head.weight"}
    d = tmp_path / "bin"
    d.mkdir()
    torch.save(sd, str(d / "pytorch_model.bin"))
    with open(os.path.join(path, "config.json")) as f:
        (d / "config.json").write_text(f.read())
    with pytest.raises(FileNotFoundError, match="no safetensors shards"):
        thf.load_params_streaming(str(d), dtype="float32", device="cpu")
    cfg, params = thf.load_params(str(d), dtype="float32", device="cpu")
    assert torch.equal(params["lm_head"], params["embed"].T)
    _, ref = thf.load_params(path, dtype="float32", device="cpu")
    assert torch.equal(params["layers"]["w_down"], ref["layers"]["w_down"])
    # convert_hf falls back to the eager reader for .bin checkpoints
    cfg2, p2 = tckpt.convert_hf(str(d), str(tmp_path / "native"),
                                dtype="float32", device="cpu")
    assert cfg2 == cfg
    _assert_params_equal(p2, params)


def test_unported_and_missing_raise(hf_checkpoint, tmp_path, monkeypatch):
    path, _ = hf_checkpoint
    # a shardings tree without the checkpoint's leaves (sharded loading
    # itself: test_torch_sharding.py)
    with pytest.raises(ValueError, match="no entry"):
        thf.load_params_streaming(path, device="cpu", shardings={})
    native = str(tmp_path / "native")
    tckpt.save_checkpoint(native, *thf.load_params(path, dtype="float32",
                                                   device="cpu"))
    with pytest.raises(ValueError, match="no entry"):
        tckpt.load_checkpoint(native, device="cpu", shardings={})
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="not found locally"):
        thf.resolve_checkpoint("llama-68m")
    # with no device and no card, the loader raises instead of using the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thf.load_params_streaming(path)


def test_resolve_checkpoint_hub_layout(tmp_path, monkeypatch):
    snap = tmp_path / "hub" / "models--JackFram--llama-68m" / "snapshots"
    (snap / "abc").mkdir(parents=True)
    (snap / "def").mkdir()
    refs = tmp_path / "hub" / "models--JackFram--llama-68m" / "refs"
    refs.mkdir()
    (refs / "main").write_text("abc\n")
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    assert thf.resolve_checkpoint("llama-68m") == str(snap / "abc")
    assert thf.resolve_checkpoint(str(snap)) == str(snap)


# --- the native checkpoint ---------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_native_checkpoint_round_trip(tmp_path, quant):
    cfg = tcfg.TINY_TARGET
    params = tl.init_params(cfg, device="cpu", dtype=torch.float32, seed=3)
    if quant:
        params = tl.quantize_weights(params)
    d = str(tmp_path / "native")
    tckpt.save_checkpoint(d, cfg, params)
    assert tckpt.is_native_checkpoint(d)
    cfg2, p2 = tckpt.load_checkpoint(d, device="cpu")
    assert cfg2 == cfg
    _assert_params_equal(params, p2)
    if quant:
        for k in ("wq_scale", "w_down_scale"):
            assert torch.equal(p2["layers"][k], params["layers"][k])
        assert torch.equal(p2["lm_head_scale"], params["lm_head_scale"])
        # int8 codes are not quantized again
        assert tl.quantize_weights(p2) is p2
        # a compute dtype converts the floating leaves, never the codes or
        # the fp32 scales
        _, p3 = tckpt.load_checkpoint(d, dtype="bfloat16", device="cpu")
        assert p3["layers"]["wq"].dtype == torch.int8
        assert p3["layers"]["wq_scale"].dtype == torch.float32
        assert p3["embed"].dtype == torch.bfloat16


def test_convert_hf_then_load(hf_checkpoint, tmp_path):
    path, _ = hf_checkpoint
    out = str(tmp_path / "native")
    cfg, params = tckpt.convert_hf(path, out, dtype="float32", device="cpu")
    cfg2, p2 = tckpt.load_checkpoint(out, device="cpu")
    assert cfg2 == cfg
    _assert_params_equal(params, p2)
    _, jp = jhf.load_params(path, dtype="float32")
    np.testing.assert_array_equal(p2["layers"]["wq"].numpy(),
                                  np.asarray(jp["layers"]["wq"]))
    _, p3 = tckpt.load_checkpoint(out, dtype=torch.bfloat16, device="cpu")
    assert torch.equal(p3["layers"]["wo"], params["layers"]["wo"].bfloat16())


# --- the safetensors format against the safetensors package ----------------

def _tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "bf16": torch.randn((3, 5), generator=g).to(torch.bfloat16),
        "f16": torch.randn((4,), generator=g).half(),
        "f32": torch.randn((2, 3, 4), generator=g),
        "i8": torch.randint(-128, 127, (7, 3), generator=g,
                            dtype=torch.int8),
        "i32": torch.randint(-2**31, 2**31 - 1, (5,), generator=g,
                             dtype=torch.int32),
        "i64": torch.arange(6, dtype=torch.int64).reshape(2, 3),
        "scalar": torch.tensor(2.5),
        "empty": torch.empty((0, 4)),
    }


def test_writer_reads_back_through_safetensors(tmp_path):
    t = _tensors()
    p = str(tmp_path / "a.safetensors")
    sio.save_file(t, p, metadata={"format": "pt"})
    got = safetensors_torch.load_file(p)
    for k, v in t.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_reader_reads_safetensors_files(tmp_path):
    t = _tensors()
    p = str(tmp_path / "b.safetensors")
    safetensors_torch.save_file(t, p, metadata={"format": "pt"})
    with sio.SafeFile(p) as f:
        assert sorted(f.keys()) == sorted(t)
        assert f.metadata == {"format": "pt"}
        for k, v in t.items():
            assert f.dtype_shape(k) == (v.dtype, tuple(v.shape))
            got = f.get(k)
            assert got.dtype == v.dtype and torch.equal(got, v), k


def _corrupt(path, out, edit):
    with open(path, "rb") as f:
        raw = f.read()
    n = int.from_bytes(raw[:8], "little")
    header = json.loads(raw[8:8 + n])
    raw_header, payload = edit(header, raw[8 + n:])
    with open(out, "wb") as f:
        f.write(len(raw_header).to_bytes(8, "little") + raw_header + payload)


@pytest.mark.parametrize("fault", ["offset_past_end", "short_payload",
                                   "wrong_byte_count", "header_too_long",
                                   "unknown_dtype"])
def test_reader_refuses_malformed_files(tmp_path, fault):
    p = str(tmp_path / "ok.safetensors")
    sio.save_file({"a": torch.ones(4), "b": torch.zeros(2, 2)}, p)
    bad = str(tmp_path / "bad.safetensors")

    def edit(h, payload):
        if fault == "offset_past_end":
            h["b"]["data_offsets"] = [16, 48]
            h["b"]["shape"] = [8]
        elif fault == "short_payload":
            payload = payload[:-4]
        elif fault == "wrong_byte_count":
            h["a"]["shape"] = [5]
        elif fault == "unknown_dtype":
            h["a"]["dtype"] = "C64"
        return json.dumps(h).encode(), payload

    if fault == "header_too_long":
        with open(p, "rb") as f:
            raw = f.read()
        with open(bad, "wb") as f:
            f.write((len(raw) * 2).to_bytes(8, "little") + raw[8:])
    else:
        _corrupt(p, bad, edit)
    # refused when the header is read, before any tensor is
    with pytest.raises(ValueError):
        sio.SafeFile(bad).close()


# --- the HF-layout writer ----------------------------------------------------

@pytest.mark.parametrize("name", ["tinyllama-1.1b-128k", "llama2-7b-128k",
                                  "llama-68m", "tiny-target"])
def test_config_to_hf_round_trips(name):
    cfg = tcfg.PRESETS[name]
    hf_cfg = json.loads(json.dumps(thf.config_to_hf(cfg)))
    back = thf.config_from_hf(hf_cfg, rope_on_slots=cfg.rope_on_slots)
    assert back == cfg
    assert dataclasses.asdict(jhf.config_from_hf(
        hf_cfg, rope_on_slots=cfg.rope_on_slots)) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("shards", [1, 2])
def test_save_params_loads_in_transformers_and_back(tmp_path, shards):
    """Port params written in HF layout: transformers reads them and gives
    the port's logits, and both loaders read them back bit-equal."""
    cfg = tcfg.TINY_TARGET.with_(rope=tcfg.RopeConfig(), vocab_size=128)
    params = tl.init_params(cfg, device="cpu", dtype=torch.float32, seed=4)
    d = str(tmp_path / "ckpt")
    thf.save_params(d, cfg, params, shards=shards)
    assert os.path.isfile(os.path.join(d, "model.safetensors.index.json")) \
        == (shards > 1)
    for fn in (thf.load_params, thf.load_params_streaming):
        cfg2, p2 = fn(d, dtype="float32", device="cpu")
        assert cfg2 == cfg
        _assert_params_equal(params, p2)
    model = transformers.LlamaForCausalLM.from_pretrained(d).eval().float()
    ids = np.random.default_rng(1).integers(0, 128, (1, 20))
    with torch.no_grad():
        want = model(torch.tensor(ids)).logits.numpy()
    np.testing.assert_allclose(_logits(cfg, params, ids), want, atol=2e-3,
                               rtol=2e-3)
    with pytest.raises(ValueError, match="int8"):
        thf.save_params(d, cfg, tl.quantize_weights(params))
