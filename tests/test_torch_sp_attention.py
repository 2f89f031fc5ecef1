"""The port's sharded attention (``triforce_tpu_torch/ops/sp_attention.py``)
against the JAX package's ``sp_append_attention`` on the 8-virtual-device
mesh: the cache split over heads (tp) and slots (sp), each rank's partials
merged by the max / sum pair, must give the single-device attention.

The ranks run two ways: as threads of this process (``run_threads``: the
module functions themselves, with a stack-max-sum standing in for the
collective), and as gloo processes (``launch``) for sp = 4 and sp = 2.
Tolerance 2e-5 (fp32), as ``tests/test_sp_attention.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_mesh_worker import launch, run_threads, shared
from triforce_tpu.ops.sp_attention import (append_attention_sharded as
                                           j_sharded, sp_append_attention)
from triforce_tpu.parallel import mesh as jmesh
from triforce_tpu_torch.ops import attention as tatt
from triforce_tpu_torch.ops import sp_attention as tsp

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)
S, D = 512, 16
CASES = [(1, 8, 4, 4, 1, 300), (2, 4, 4, 2, 7, 413), (4, 2, 8, 4, 3, 512)]


def _inputs(hq, hkv, t, seed, quant=False, zero_cache=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    out = dict(q=f(1, hq, t, D), k=f(1, hkv, S, D), v=f(1, hkv, S, D),
               kn=f(1, hkv, t, D), vn=f(1, hkv, t, D))
    if zero_cache:
        out["k"][:] = 0
        out["v"][:] = 0
    if quant:
        for name in ("k", "v"):
            x = out[name]
            scale = np.maximum(np.abs(x).max(-1) / 127.0, 1e-8)
            out[name] = np.clip(np.round(x / scale[..., None]), -127,
                                127).astype(np.int8)
            out[name + "_scale"] = scale.astype(np.float32)
    return out


def _jax_ref(x, tp, sp, k_len, mask_fn=None):
    m = jmesh.make_mesh(tp=tp, sp=sp)
    kw = {}
    if "k_scale" in x:
        kw = dict(k_scale=jnp.asarray(x["k_scale"]),
                  v_scale=jnp.asarray(x["v_scale"]))
    fn = jax.jit(lambda *a: j_sharded(
        m, *a, k_len=jnp.asarray(k_len), shard_seq=True,
        cache_mask_fn=mask_fn, **kw))
    return np.asarray(fn(*(jnp.asarray(x[n])
                           for n in ("q", "k", "v", "kn", "vn"))))


def _port_threads(x, tp, sp, k_len, mask_fn=None, layers=None):
    """The port's sharded attention on a tp x sp mesh of threads; returns
    the [1, Hq, T, D] output assembled from the tp ranks' heads, after
    checking that the sp ranks of each tp rank agree bit for bit."""
    def rank(mesh):
        ti, si = mesh.index("tp"), mesh.index("sp")

        def heads(a):
            n = a.shape[1] // tp
            return torch.from_numpy(a[:, ti * n:(ti + 1) * n].copy())

        def shard(a):
            h = heads(a)
            n = h.shape[2] // sp
            return h[:, :, si * n:(si + 1) * n].contiguous()

        kw = dict(k_len=k_len, shard_seq=True, cache_mask_fn=mask_fn)
        k, v = shard(x["k"]), shard(x["v"])
        ks = shard(x["k_scale"]) if "k_scale" in x else None
        vs = shard(x["v_scale"]) if "k_scale" in x else None
        if layers is not None:      # the whole stacked local cache + index
            li, n = layers

            def stack(a):
                return None if a is None else torch.stack(
                    [torch.zeros_like(a)] * li + [a]
                    + [torch.ones_like(a)] * (n - li - 1))
            k, v, ks, vs = stack(k), stack(v), stack(ks), stack(vs)
            kw["layer"] = li
        return tsp.append_attention_sharded(
            mesh, heads(x["q"]), k, v, heads(x["kn"]), heads(x["vn"]),
            k_scale=ks, v_scale=vs, **kw).numpy()

    outs = run_threads(rank, tp=tp, sp=sp)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o, outs[(r // sp) * sp])
    return np.concatenate([outs[ti * sp] for ti in range(tp)], axis=1)


@pytest.mark.parametrize("tp,sp,hq,hkv,t,k_len", CASES)
def test_sp_matches_jax_sharded(tp, sp, hq, hkv, t, k_len):
    x = _inputs(hq, hkv, t, k_len + t)
    m = jmesh.make_mesh(tp=tp, sp=sp)
    want = np.asarray(jax.jit(lambda *a: sp_append_attention(
        m, *a, k_len=jnp.asarray(k_len)))(
        *(jnp.asarray(x[n]) for n in ("q", "k", "v", "kn", "vn"))))
    got = _port_threads(x, tp, sp, k_len)
    np.testing.assert_allclose(got, want, **TOL)
    # and the port's single-device attention
    single = tatt.append_attention(
        *(torch.from_numpy(x[n]) for n in ("q", "k", "v", "kn", "vn")),
        k_len=k_len).numpy()
    np.testing.assert_allclose(got, single, **TOL)


def test_sp_empty_prefix():
    """k_len 0: only the new block counts; all-empty shards give no NaN."""
    x = _inputs(2, 2, 2, 0, zero_cache=True)
    want = _jax_ref(x, 1, 8, 0)
    got = _port_threads(x, 1, 8, 0)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("tp,sp,k_len", [(2, 4, 413), (1, 8, 77)])
def test_int8_scale_planes(tp, sp, k_len):
    """An int8 cache's scale planes split with its codes."""
    x = _inputs(4, 2, 3, 11, quant=True)
    np.testing.assert_allclose(_port_threads(x, tp, sp, k_len),
                               _jax_ref(x, tp, sp, k_len), **TOL)


def test_device_k_len_and_stacked_layer():
    """A 0-d device ``k_len`` clamps into each shard's frame as a host one
    does, and the stacked [L, ...] cache read at a layer index gives the
    layer's result."""
    x = _inputs(4, 2, 3, 5)
    want = _port_threads(x, 2, 4, 300)
    got = _port_threads(x, 2, 4, torch.tensor(300, dtype=torch.int32),
                        layers=(1, 3))
    np.testing.assert_array_equal(got, want)


def test_cache_mask_columns_are_global():
    """``cache_mask_fn`` sees global columns on every shard."""
    x = _inputs(4, 4, 2, 9)

    def mask(rows, cols):           # jax and torch arrays alike
        return (cols % 3) != 0

    np.testing.assert_allclose(_port_threads(x, 1, 4, 400, mask_fn=mask),
                               _jax_ref(x, 1, 4, 400, mask_fn=mask), **TOL)


def test_merge_partials_psum_is_exact_at_one_rank():
    """Over one rank the merge returns the partials it was given."""
    rng = np.random.default_rng(0)
    p = tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in ((1, 2, 2, 3), (1, 2, 2, 3), (1, 2, 2, 3, 8)))
    got = run_threads(lambda mesh: tsp.merge_partials_psum(p, mesh))[0]
    for a, b in zip(got, p):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the same attention across gloo processes
# ---------------------------------------------------------------------------

GLOO_CASES = [("sp4", 1, 4, 4, 4, 1, 300, False),
              ("sp2 tp2", 2, 2, 4, 2, 7, 413, False),
              ("sp2 tp2 int8", 2, 2, 4, 2, 3, 200, True)]


def _gloo_runs(tmp):
    cases = []
    for name, tp, sp, hq, hkv, t, k_len, quant in GLOO_CASES:
        path = str(tmp / (name.replace(" ", "_") + ".npz"))
        np.savez(path, **_inputs(hq, hkv, t, k_len, quant=quant))
        cases.append(dict(kind="attention", name=name, tp=tp, sp=sp,
                          k_len=k_len, inputs=path))
    return launch(dict(kind="cases", cases=cases), 4, tmp)


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    return shared(tmp_path_factory, "sp_gloo", _gloo_runs)


@pytest.mark.parametrize("case", GLOO_CASES, ids=[c[0] for c in GLOO_CASES])
def test_gloo_processes_match_jax(gloo_runs, case):
    name, tp, sp, hq, hkv, t, k_len, quant = case
    res = gloo_runs
    outs = [np.asarray(r[name], np.float32) for r in res]
    for r, o in enumerate(outs):        # the sp ranks of a tp rank agree
        np.testing.assert_array_equal(o, outs[(r // sp) * sp])
    got = np.concatenate([outs[ti * sp] for ti in range(tp)], axis=1)
    x = _inputs(hq, hkv, t, k_len, quant=quant)
    np.testing.assert_allclose(got, _jax_ref(x, tp, sp, k_len), **TOL)
    # one max and one sum over sp; nothing over tp
    assert res[0][name + " collectives"] == {"sp": 2}
