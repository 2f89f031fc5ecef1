"""Sequence-level losslessness of the port, on the port alone (mirrors
tests/test_lossless_stats.py):

  * over N seeds, the first K emitted tokens of TriForce and retrieval
    speculation must be indistinguishable (two-sample chi-square, per
    position) from the port's own autoregressive sampling of the same
    target;
  * a power control: forced acceptance 1.0 emits raw drafter proposals, a
    stream that is provably not target-distributed, and the same statistic
    must flag it — so a pass is not vacuous.

Seeds are fixed, so outcomes are deterministic.
"""

import numpy as np
import pytest
import torch
from scipy import stats as sstats

from triforce_tpu_torch import config as tcfg
from triforce_tpu_torch.engine import Engine
from triforce_tpu_torch.models import llama

torch.set_num_threads(1)

TCFG, DCFG = tcfg.TINY_TARGET, tcfg.TINY_DRAFT
# temperature 0.05: tiny random-init logits are nearly flat, so moderate
# temperatures leave every conditional near-uniform over V=199 and a
# histogram test has no power; 0.05 concentrates top-p mass on a few tokens
SPEC = tcfg.SpecConfig(gamma=3, budget=16, chunk_size=4, draft_start_size=4,
                       draft_recent_size=12, temperature=0.05, top_p=0.9)
PREFILL = 32
K = 4          # emitted-token positions compared
N = 512        # seeds per sample


@pytest.fixture(scope="module")
def eng():
    t_params = llama.init_params(TCFG, device="cpu", dtype=torch.float32,
                                 seed=0)
    d_params = llama.init_params(DCFG, device="cpu", dtype=torch.float32,
                                 seed=1)
    engine = Engine(TCFG, SPEC, t_params, draft_cfg=DCFG,
                    draft_params=d_params, prefill=PREFILL,
                    max_cache_len=PREFILL + 64, dtype=torch.float32,
                    prefill_chunk=16, draft_prefill_chunk=8, device="cpu")
    ids = torch.randint(0, TCFG.vocab_size, (1, PREFILL),
                        generator=torch.Generator().manual_seed(2))
    state = engine.init_state(100)
    state = engine.prefill_draft(engine.prefill_target(state, ids), ids)
    return engine, state


def _chi2_two_sample(a: np.ndarray, b: np.ndarray):
    """Two-sample chi-square on token histograms, rare tokens pooled so
    every expected count is >= 5. Returns (statistic, dof)."""
    tokens = np.union1d(a, b)
    ca = np.array([(a == t).sum() for t in tokens], float)
    cb = np.array([(b == t).sum() for t in tokens], float)
    tot = ca + cb
    order = np.argsort(-tot)
    ca, cb, tot = ca[order], cb[order], tot[order]
    na, nb = ca.sum(), cb.sum()
    keep = tot * min(na, nb) / (na + nb) >= 5.0
    k = max(int(keep.sum()), 1)
    ca = np.concatenate([ca[:k], [ca[k:].sum()]])
    cb = np.concatenate([cb[:k], [cb[k:].sum()]])
    if ca[-1] + cb[-1] < 5.0:                       # drop a thin tail bucket
        ca, cb = ca[:-1], cb[:-1]
    pooled = (ca + cb) / (na + nb)
    ea, eb = pooled * na, pooled * nb
    stat = float((((ca - ea) ** 2) / np.maximum(ea, 1e-9)).sum()
                 + (((cb - eb) ** 2) / np.maximum(eb, 1e-9)).sum())
    return stat, max(len(ca) - 1, 1)


def _positionwise_pvalue(sample_a: np.ndarray, sample_b: np.ndarray):
    """sample_*: [N, K] token streams; chi-square per position, summed."""
    stat = dof = 0
    for j in range(sample_a.shape[1]):
        s, d = _chi2_two_sample(sample_a[:, j], sample_b[:, j])
        stat, dof = stat + s, dof + d
    return float(sstats.chi2.sf(stat, dof)), stat, dof


def _ar_sample(engine, state, seed0: int) -> np.ndarray:
    """[N, K] AR tokens from the shared prefilled state, one seed per row."""
    rows = []
    for i in range(N):
        st = state.clone(seed=seed0 + i)
        _, _, _, buf = engine.generate_ar(st.kv, st.next_token, st.gen, K)
        rows.append(buf.tolist())
    return np.array(rows)


def _spec_sample(engine, state, mode: str, seed0: int,
                 forced: float | None = None) -> np.ndarray:
    """[N, K] first K emitted tokens of speculative generations (buf[0] is
    the prefill's token, the same for every row)."""
    rows = []
    for i in range(N):
        st = state.clone(seed=seed0 + i)
        if forced is None:
            _, buf, _, _ = engine.generate(st, K, mode=mode)
        else:
            _, buf, _, _ = engine.generate_forced(st, K, forced, mode=mode)
        rows.append(buf[1:K + 1].tolist())
    return np.array(rows)


@pytest.fixture(scope="module")
def ar_tokens(eng):
    """One AR sample shared by the three comparisons."""
    engine, state = eng
    return _ar_sample(engine, state, seed0=50_000)


@pytest.mark.parametrize("mode", ["retrieval", "triforce"])
def test_sequence_distribution_matches_ar(eng, ar_tokens, mode):
    engine, state = eng
    sp = _spec_sample(engine, state, mode, seed0=90_000)
    p, stat, dof = _positionwise_pvalue(ar_tokens, sp)
    print(f"{mode}: p={p:.3e}")
    assert p > 1e-3, (
        f"{mode} K={K}-token stream differs from AR: chi2 {stat:.1f} "
        f"(dof {dof}, p={p:.2e}) — speculation is not lossless")


def test_statistic_has_power(eng, ar_tokens):
    """Forced acceptance 1.0 emits raw drafter-chain proposals — a
    non-target stream the statistic must flag."""
    engine, state = eng
    forced = _spec_sample(engine, state, "triforce", seed0=190_000,
                          forced=1.0)
    p, stat, dof = _positionwise_pvalue(ar_tokens, forced)
    print(f"control: p={p:.3e}")
    assert p < 1e-6, (
        f"control not detected (p={p:.2e}): the two-sample test has no "
        "power at this N")
