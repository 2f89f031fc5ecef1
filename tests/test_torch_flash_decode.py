"""Kernel B1 (fused decode attention): the port's plain version — what a
CPU tensor runs — against the JAX Pallas kernel in interpret mode (run as
tests/test_flash_decode.py runs it) and against the JAX XLA attention path,
in fp32 and bf16. The CUDA kernel itself is checked on the card by
chip_smoke.py and tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triforce_tpu.ops import attention as jatt
from triforce_tpu.ops.flash_decode import (append_attention_pallas,
                                           flash_decode_append as j_fda)
from triforce_tpu_torch.ops import attention as tatt
from triforce_tpu_torch.ops import flash_decode as tfd

torch.set_num_threads(1)

HKV, S, D, BLOCK = 2, 512, 32, 128
K_LENS = [0, 300, 256, 512]          # empty, inside a block, boundary, S

# fp32: identical arithmetic up to summation order. bf16: the plain version
# rounds p to bf16 against the global max, the blockwise kernel against a
# running max, so single p values differ by one bf16 ulp (2^-8 relative).
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _mk(hq, t, seed, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            [(1, hq, t, D), (1, HKV, S, D), (1, HKV, S, D), (1, HKV, t, D),
             (1, HKV, t, D)]]
    if dtype == "bfloat16":   # round once, then hand both sides the same
        arrs = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in arrs]
    return arrs


def _j(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _t(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,t", [(1, 1), (1, 7), (1, 8), (1, 256), (2, 4),
                                 (2, 128)])
def test_plain_matches_pallas_interpret_and_xla(g, t, dtype):
    """GT = g*t in {1, 7, 8, 256} (256 is the q-tiled Pallas path), with
    every k_len case; one Pallas trace per shape (k_len is traced)."""
    q, k, v, kn, vn = _mk(HKV * g, t, seed=g * 1000 + t, dtype=dtype)
    for k_len in K_LENS:
        want = append_attention_pallas(
            _j(q, dtype), _j(k, dtype), _j(v, dtype), _j(kn, dtype),
            _j(vn, dtype), k_len=jnp.asarray(k_len), block=BLOCK,
            interpret=True)
        xla = jatt.append_attention(
            _j(q, dtype), _j(k, dtype), _j(v, dtype), _j(kn, dtype),
            _j(vn, dtype), k_len=jnp.asarray(k_len))
        got = tfd.append_attention_kernel(
            _t(q, dtype), _t(k, dtype), _t(v, dtype), _t(kn, dtype),
            _t(vn, dtype), k_len=torch.tensor(k_len, dtype=torch.int32))
        assert got.dtype == getattr(torch, dtype)
        got = got.float().numpy()
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **TOL[dtype], err_msg=f"k_len={k_len}")
        np.testing.assert_allclose(got, np.asarray(xla, np.float32),
                                   **TOL[dtype], err_msg=f"k_len={k_len}")


@pytest.mark.parametrize("gt,tn,k_len", [(8, 5, 200), (48, 40, 300)])
def test_plain_kernel_layout_matches_jax_kernel(gt, tn, k_len):
    """The raw kernel contract (q [Hkv, GT, D], fp32 output, bias mask)
    on a random non-causal mask, against the JAX kernel called the same
    way: a decode shape, and a wide one (GT > 16: the CUDA kernel's wide
    path)."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((HKV, gt, D)).astype(np.float32)
    k = rng.standard_normal((HKV, S, D)).astype(np.float32)
    v = rng.standard_normal((HKV, S, D)).astype(np.float32)
    kn = rng.standard_normal((HKV, tn, D)).astype(np.float32)
    vn = rng.standard_normal((HKV, tn, D)).astype(np.float32)
    mask = rng.random((gt, tn)) < 0.6
    mask[:, 0] = True
    want = j_fda(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(k_len),
                 jnp.asarray(mask), block=BLOCK, interpret=True)
    got = tfd.flash_decode_append(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(kn), torch.from_numpy(vn),
        torch.tensor(k_len, dtype=torch.int32), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (HKV, gt, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


def test_stale_tail_never_read():
    """Slots at or past k_len must not contribute (rollback semantics)."""
    q, k, v, kn, vn = [torch.from_numpy(a) for a in _mk(HKV, 1, 3,
                                                         "float32")]
    poisoned_k, poisoned_v = k.clone(), v.clone()
    poisoned_k[:, :, 120:] = 1e4
    poisoned_v[:, :, 120:] = 1e4
    kl = torch.tensor(120, dtype=torch.int32)
    clean = tfd.append_attention_kernel(q, k, v, kn, vn, k_len=kl)
    dirty = tfd.append_attention_kernel(q, poisoned_k, poisoned_v, kn, vn,
                                        k_len=kl)
    torch.testing.assert_close(clean, dirty, rtol=0, atol=0)


def test_auto_dispatch_on_cpu_is_partials_path():
    """append_attention_auto on a CPU tensor runs append_attention, which
    matches the JAX XLA path (fp32)."""
    q, k, v, kn, vn = _mk(4, 3, 11, "float32")
    want = jatt.append_attention(*[jnp.asarray(a) for a in
                                   (q, k, v, kn, vn)],
                                 k_len=jnp.asarray(100))
    got = tatt.append_attention_auto(*[torch.from_numpy(a) for a in
                                       (q, k, v, kn, vn)],
                                     k_len=torch.tensor(100))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])


def test_merge_partials_and_finalize_match():
    q, k, v, kn, vn = _mk(2, 2, 5, "float32")
    jp = jatt.attention_partials(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), k_len=jnp.asarray(77),
                                 block=128)
    tp = tatt.attention_partials(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), k_len=77, block=128)
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-5,
                                   atol=2e-5)
    mask = np.tril(np.ones((2, 2), bool))
    jn = jatt.new_block_partials(jnp.asarray(q), jnp.asarray(kn),
                                 jnp.asarray(vn), jnp.asarray(mask))
    tn = tatt.new_block_partials(torch.from_numpy(q), torch.from_numpy(kn),
                                 torch.from_numpy(vn), torch.from_numpy(mask))
    want = jatt.finalize(jatt.merge_partials(jp, jn), jnp.float32)
    got = tatt.finalize(tatt.merge_partials(tp, tn), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_non_cpu_tensor_never_takes_the_plain_path():
    """Only a CPU tensor runs the plain version: any other device goes to
    the kernel route, which raises for what it cannot launch (here a meta
    tensor) instead of falling back."""
    q = torch.empty((HKV, 1, D), device="meta")
    mask = torch.ones((1, 1), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        tfd.flash_decode_append(q, q, q, q, q, 0, mask)
