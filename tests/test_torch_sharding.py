"""The port's sharding rules (``triforce_tpu_torch/parallel/sharding.py``)
against the JAX package's, and the tensor-parallel forward they feed
(``models/llama.py`` over a mesh) against the single-device forwards of
both packages, on JAX's tiny sharding config (8 KV heads, head dim 8,
hidden 64, vocab 199: a vocabulary that no tp > 1 divides, so the
lm_head falls back to whole on every rank).

The ranks are threads (``torch_mesh_worker.run_threads``). Tolerances as
``tests/test_sharding.py``: logits 1e-3, cache 1e-4 (fp32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_mesh_worker import ThreadMesh, _Hub, run_threads
from triforce_tpu import cache as jcache
from triforce_tpu import config as jcfg
from triforce_tpu.models import llama as jl
from triforce_tpu.parallel import mesh as jmesh
from triforce_tpu.parallel import sharding as jsh
from triforce_tpu_torch import cache as tcache
from triforce_tpu_torch import config as tcfg
from triforce_tpu_torch.models import ckpt as tckpt
from triforce_tpu_torch.models import hf as thf
from triforce_tpu_torch.models import llama as tl
from triforce_tpu_torch.parallel import sharding as tsh

torch.set_num_threads(1)

TP8 = dict(vocab_size=199, hidden_size=64, intermediate_size=128,
           num_layers=2, num_heads=8, num_kv_heads=8, head_dim=8,
           max_position_embeddings=4096, rms_norm_eps=1e-5)
J_TP8 = jcfg.ModelConfig(rope=jcfg.RopeConfig(kind="llama"), **TP8)
T_TP8 = tcfg.ModelConfig(rope=tcfg.RopeConfig(kind="llama"), **TP8)


def _mesh(tp=1, sp=1, ti=0, si=0):
    """One rank's view of a mesh, for the rules alone (no collective)."""
    return ThreadMesh(_Hub(dict(dp=1, tp=tp, sp=sp)),
                      dict(dp=0, tp=ti, sp=si))


def _specs(tree):
    return {k: (_specs(v) if isinstance(v, dict) else tuple(v.spec))
            for k, v in tree.items()}


def _jspecs(tree):
    return {k: (_jspecs(v) if isinstance(v, dict) else tuple(v.spec))
            for k, v in tree.items()}


def _pad(spec, n):
    return tuple(spec) + (None,) * (n - len(spec))


def _assert_same_specs(mine, theirs):
    assert mine.keys() == theirs.keys()
    for k in mine:
        if isinstance(mine[k], dict):
            _assert_same_specs(mine[k], theirs[k])
        else:
            n = max(len(mine[k]), len(theirs[k]))
            assert _pad(mine[k], n) == _pad(theirs[k], n), k


@pytest.mark.parametrize("tp", [2, 8])
@pytest.mark.parametrize("quant", [False, True], ids=["bf", "int8"])
def test_param_shardings_match_jax(tp, quant):
    """Leaf by leaf, including the whole lm_head of a 199-word vocabulary
    and the int8 scale planes."""
    mine = _specs(tsh.param_shardings(_mesh(tp), T_TP8, weight_quant=quant))
    theirs = _jspecs(jsh.param_shardings(jmesh.make_mesh(tp=tp), J_TP8,
                                         weight_quant=quant))
    _assert_same_specs(mine, theirs)
    assert mine["lm_head"] == (None, None)         # 199 % tp != 0


@pytest.mark.parametrize("tp,sp,shard_seq", [(2, 4, True), (4, 2, False),
                                              (8, 1, False)])
def test_state_shardings_match_jax(tp, sp, shard_seq):
    mine = tsh.state_shardings(_mesh(tp, sp), T_TP8, None,
                               shard_seq=shard_seq, quant=True)
    theirs = jsh.state_shardings(jmesh.make_mesh(tp=tp, sp=sp), J_TP8, None,
                                 shard_seq=shard_seq, quant=True)
    for cache in ("kv", "rkv"):
        for plane in ("k", "v", "k_scale", "v_scale"):
            a = tuple(getattr(mine, cache)[plane].spec)
            b = tuple(getattr(getattr(theirs, cache), plane).spec)
            assert _pad(a, 5) == _pad(b, 5), (cache, plane)
    assert tuple(mine.dkv["k"].spec) == tuple(theirs.dkv.k.spec) == ()


def test_kv_shardings_refuse_tp_not_dividing_heads():
    with pytest.raises(ValueError, match="num_kv_heads"):
        tsh.kv_shardings(_mesh(3), T_TP8)


def test_take_and_local_shape():
    sh = tsh.Sharding(_mesh(2, 4, ti=1, si=2),
                      tsh.Spec(None, None, "tp", "sp", None))
    x = torch.arange(2 * 1 * 8 * 16 * 3).reshape(2, 1, 8, 16, 3)
    assert sh.local_shape(x.shape) == (2, 1, 4, 4, 3)
    assert torch.equal(sh.take(x), x[:, :, 4:8, 8:12])


@pytest.fixture(scope="module")
def weights():
    pj = jl.init_params(jax.random.PRNGKey(0), J_TP8, dtype=jnp.float32)
    return pj, tl.params_from_numpy(jax.tree.map(np.asarray, pj), T_TP8,
                                    "cpu")


def _rank_params(pt, mesh, cfg=T_TP8):
    return tsh.shard_params(pt, mesh, cfg)


def test_tp_forward_matches_single_device(weights):
    """A tp=2 forward's logits and cache against the single-device port
    and JAX (``test_sharding.py:31-54``)."""
    pj, pt = weights
    ids = np.random.default_rng(1).integers(0, 199, (1, 16))
    kv_j = jcache.init_kv(J_TP8, max_len=32, dtype=jnp.float32)
    want_logits, want_kv, _ = jl.forward_append(J_TP8, pj, jnp.asarray(ids),
                                                kv_j)
    single, kv1, _ = tl.forward_append(
        T_TP8, pt, torch.from_numpy(ids),
        tcache.init_kv(T_TP8, 32, dtype=torch.float32, device="cpu"))

    def rank(mesh):
        kv = tcache.init_kv(T_TP8.with_(num_kv_heads=4), 32,
                            dtype=torch.float32, device="cpu")
        logits, kv, _ = tl.forward_append(T_TP8, _rank_params(pt, mesh),
                                          torch.from_numpy(ids), kv,
                                          mesh=mesh)
        return logits, kv.k

    outs = run_threads(rank, tp=2)
    assert torch.equal(outs[0][0], outs[1][0])   # every rank, the same bits
    k = torch.cat([o[1] for o in outs], dim=2)
    for ref_logits, ref_k in ((np.asarray(want_logits), np.asarray(want_kv.k)),
                              (single.numpy(), kv1.k.numpy())):
        np.testing.assert_allclose(outs[0][0].numpy(), ref_logits,
                                   atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(k.numpy(), ref_k, atol=1e-4, rtol=1e-4)


def test_sequence_shards_hold_the_global_cache(weights):
    """tp=2 x sp=2 with the slots split: prefill chunks whose windows
    straddle the shards land in the slots each rank owns, and the shards
    put together are the single-device cache; a window that runs past
    the end slides back as JAX's clamp does."""
    _, pt = weights
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 199, (1, 30)))
    kv1 = tcache.init_kv(T_TP8, 32, dtype=torch.float32, device="cpu")
    for s in (0, 10, 20):
        _, kv1, _ = tl.forward_append(T_TP8, pt, ids[:, s:s + 10], kv1)
    _, kv1, _ = tl.forward_append(T_TP8, pt, ids[:, :6], kv1)   # clamped

    def rank(mesh):
        kv = tcache.init_kv(T_TP8.with_(num_kv_heads=4), 16,
                            dtype=torch.float32, device="cpu")
        p = _rank_params(pt, mesh)
        for s in (0, 10, 20):
            _, kv, _ = tl.forward_append(T_TP8, p, ids[:, s:s + 10], kv,
                                         mesh=mesh, shard_seq=True)
        logits, kv, _ = tl.forward_append(T_TP8, p, ids[:, :6], kv,
                                          mesh=mesh, shard_seq=True)
        return logits, kv.k

    outs = run_threads(rank, tp=2, sp=2)
    k = torch.cat([torch.cat([outs[t * 2 + s][1] for s in range(2)], dim=3)
                   for t in range(2)], dim=2)
    np.testing.assert_allclose(k.numpy(), kv1.k.numpy(), atol=1e-5,
                               rtol=1e-5)
    assert int(kv1.seq_len) == 36


def test_sharded_forward_uses_stacked_zero_copy_path(weights, monkeypatch):
    """The mesh'd target and middle forwards hand the WHOLE stacked cache
    and a layer index to the sharded attention (``test_sharding.py:150-191``),
    so no layer slab is copied."""
    _, pt = weights
    from triforce_tpu_torch.ops import sp_attention
    calls = []
    real = sp_attention.append_attention_sharded

    def spy(mesh, q, k_cache, v_cache, k_new, v_new, **kw):
        calls.append((k_cache.dim(), kw.get("layer") is not None))
        return real(mesh, q, k_cache, v_cache, k_new, v_new, **kw)

    monkeypatch.setattr(tl, "append_attention_sharded", spy)
    spec = tcfg.SpecConfig(gamma=2, budget=16, chunk_size=4)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 199, (1, 8)))

    def rank(mesh):
        p = _rank_params(pt, mesh)
        local = T_TP8.with_(num_kv_heads=4)
        kv = tcache.init_kv(local, 16, dtype=torch.float32, device="cpu")
        _, kv, _ = tl.forward_append(T_TP8, p, ids, kv, mesh=mesh,
                                     shard_seq=True)
        rkv = tcache.init_retrieval(local, spec, dtype=torch.float32,
                                    device="cpu")
        tl.forward_spec(T_TP8, p, torch.zeros((1, 3), dtype=torch.int64),
                        rkv, kv.seq_len, spec.budget, commit=False,
                        mesh=mesh)

    run_threads(rank, tp=2, sp=4)
    assert len(calls) == 8 * 2 * 2
    assert all(ndim == 5 and layer for ndim, layer in calls), calls


def test_mesh_free_forward_issues_no_collective(weights, monkeypatch):
    """``mesh=None`` never reaches the sharded path: its tokens are the
    meshless engine's (held against JAX by ``test_torch_engine.py``)."""
    _, pt = weights
    monkeypatch.setattr(tl, "append_attention_sharded", None)
    kv = tcache.init_kv(T_TP8, 16, dtype=torch.float32, device="cpu")
    logits, _, _ = tl.forward_append(T_TP8, pt, torch.zeros(
        (1, 4), dtype=torch.int64), kv)
    assert logits.shape == (1, 4, 199)


def test_init_params_shardings_are_slices_of_the_full_init():
    cfg = T_TP8.with_(vocab_size=200)          # a vocabulary tp divides
    full = tl.init_params(cfg, device="cpu", dtype=torch.float32, seed=3)
    for ti in range(2):
        mesh = _mesh(2, ti=ti)
        sh = tsh.param_shardings(mesh, cfg)
        part = tl.init_params(cfg, device="cpu", dtype=torch.float32, seed=3,
                              shardings=sh)
        want = tsh.shard_tree(full, sh)
        for name in ("embed", "lm_head", "final_norm"):
            assert torch.equal(part[name], want[name]), name
        for name, x in part["layers"].items():
            assert torch.equal(x, want["layers"][name]), name
        assert part["lm_head"].shape == (64, 100)


def test_quantize_weights_over_a_mesh_matches_the_whole():
    """The row-parallel weights' channel maxima are taken over tp, so each
    rank's codes and scales are its slice of quantizing the whole."""
    cfg = T_TP8.with_(vocab_size=200)
    full = tl.init_params(cfg, device="cpu", dtype=torch.float32, seed=4)
    whole = tl.quantize_weights(full)

    def rank(mesh):
        return tl.quantize_weights(tsh.shard_params(full, mesh, cfg), mesh,
                                   cfg)

    for ti, got in enumerate(run_threads(rank, tp=2)):
        want = tsh.shard_tree(whole, tsh.param_shardings(
            _mesh(2, ti=ti), cfg, weight_quant=True))
        for name, x in got["layers"].items():
            assert torch.equal(x, want["layers"][name]), name
        assert torch.equal(got["lm_head"], want["lm_head"])
        assert torch.equal(got["lm_head_scale"], want["lm_head_scale"])


@pytest.mark.parametrize("fmt", ["hf", "native", "native-int8"])
def test_sharded_loading_is_the_slice_of_the_whole(weights, tmp_path, fmt):
    """``shardings=`` loads each rank's slice straight away: every leaf
    equals the same slice of the whole load."""
    _, pt = weights
    cfg = T_TP8.with_(vocab_size=200)
    full = tl.init_params(cfg, device="cpu", dtype=torch.float32, seed=5)
    if fmt == "hf":
        thf.save_params(str(tmp_path), cfg, full)

        def load(**kw):
            return thf.load_params_streaming(str(tmp_path), dtype="float32",
                                             device="cpu", **kw)[1]
    else:
        tckpt.save_checkpoint(str(tmp_path), cfg, tl.quantize_weights(full)
                              if fmt == "native-int8" else full)

        def load(**kw):
            return tckpt.load_checkpoint(str(tmp_path), device="cpu",
                                         **kw)[1]
    whole = load()
    for ti in range(2):
        sh = tsh.param_shardings(_mesh(2, ti=ti), cfg, weight_quant=True)
        got, want = load(shardings=sh), tsh.shard_tree(whole, sh)
        assert got.keys() == want.keys()
        for name in got:
            if name != "layers":
                assert torch.equal(got[name], want[name]), name
        for name, x in got["layers"].items():
            assert torch.equal(x, want["layers"][name]), name


def test_sharded_loading_needs_every_leaf(tmp_path):
    cfg = T_TP8.with_(vocab_size=200)
    thf.save_params(str(tmp_path), cfg,
                    tl.init_params(cfg, device="cpu", dtype=torch.float32))
    with pytest.raises(ValueError, match="no entry"):
        thf.load_params_streaming(str(tmp_path), device="cpu", shardings={})


def test_shard_tree_names_a_missing_leaf():
    with pytest.raises(ValueError, match="no sharding"):
        tsh.shard_tree({"embed": torch.zeros(2)}, {})


def test_state_shardings_local_shapes():
    sh = tsh.state_shardings(_mesh(2, 4), T_TP8, None, shard_seq=True)
    assert sh.kv["k"].local_shape((2, 1, 8, 64, 8)) == (2, 1, 4, 16, 8)
    assert sh.rkv["k"].local_shape((2, 1, 8, 20, 8)) == (2, 1, 4, 20, 8)
    assert dataclasses.fields(sh)
