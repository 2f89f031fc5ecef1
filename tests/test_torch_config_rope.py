"""The port's config presets and RoPE tables against the JAX package's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triforce_tpu import config as jcfg
from triforce_tpu.models import rope as jrope
from triforce_tpu_torch import config as tcfg
from triforce_tpu_torch.models import rope as trope
from triforce_tpu_torch.ops import layer_glue

torch.set_num_threads(1)


def test_presets_equal_field_by_field():
    assert set(tcfg.PRESETS) == set(jcfg.PRESETS)
    for name, jc in jcfg.PRESETS.items():
        tc = tcfg.PRESETS[name]
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), name
        assert tc.num_kv_groups == jc.num_kv_groups
    assert dataclasses.asdict(tcfg.SpecConfig()) == \
        dataclasses.asdict(jcfg.SpecConfig())
    assert tcfg.DEFAULT_DTYPE == torch.bfloat16


@pytest.mark.parametrize("name", ["tiny-target", "llama2-7b-128k"])
def test_cos_sin_tables_match(name):
    """cos/sin rows (YaRN mscale folded in) at positions 0, 4096 and
    131071 of a 131072-long table. Both packages build the tables with the
    same numpy arithmetic, so they agree exactly."""
    max_len = 131072
    jc, tc = jcfg.PRESETS[name], tcfg.PRESETS[name]
    jcos, jsin = jrope.cos_sin_tables(jc, max_len=max_len)
    tcos, tsin = trope.cos_sin_tables(tc, max_len=max_len, device="cpu")
    pos = [0, 4096, 131071]
    np.testing.assert_array_equal(tcos.numpy()[pos], np.asarray(jcos)[pos])
    np.testing.assert_array_equal(tsin.numpy()[pos], np.asarray(jsin)[pos])
    assert trope.mscale_for(tc.rope, max_len) == \
        jrope.mscale_for(jc.rope, max_len)
    np.testing.assert_array_equal(
        trope.inv_freq_for(tc.rope, tc.head_dim, max_len),
        jrope.inv_freq_for(jc.rope, jc.head_dim, max_len))


def test_apply_rope_matches():
    """Rotation of random [B, H, T, D] rows at mixed positions; fp32
    elementwise arithmetic in the same order, so equal to fp32 rounding."""
    cfg_j, cfg_t = jcfg.LLAMA2_7B_128K, tcfg.LLAMA2_7B_128K
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 4, 5, cfg_t.head_dim)).astype(np.float32)
    pos = np.array([0, 17, 4096, 99999, 131071])
    jcos, jsin = jrope.cos_sin_tables(cfg_j)
    tcos, tsin = trope.cos_sin_tables(cfg_t, device="cpu")
    want = jrope.apply_rope(jnp.asarray(x), jcos, jsin, jnp.asarray(pos))
    (got,) = layer_glue.rope((torch.from_numpy(x),), tcos, tsin,
                             torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
