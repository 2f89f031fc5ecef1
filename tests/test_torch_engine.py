"""The port's Engine and decoding drivers against the JAX Engine.

Oracle: near-greedy token identity. At temperature 1e-4 the top-p nucleus
collapses to the single top token (tiny-model logit gaps are far above
fp32 drift), so every sampled distribution is one-hot: the drafter and
middle samples, the accept tests (ratio 1 or 0), the residual and the bonus
are all deterministic, and the two packages must emit the same tokens and
step counters although their random streams differ.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triforce_tpu import config as jcfg
from triforce_tpu import decoding as jdec
from triforce_tpu.engine import Engine as JEngine
from triforce_tpu.models import llama as jl
from triforce_tpu_torch import cache as tcache
from triforce_tpu_torch import config as tcfg
from triforce_tpu_torch import decoding as tdec
from triforce_tpu_torch.engine import Engine as TEngine
from triforce_tpu_torch.models import llama as tl
from triforce_tpu_torch.models import rope as trope

torch.set_num_threads(1)

SPEC_KW = dict(gamma=3, budget=16, chunk_size=4, draft_start_size=4,
               draft_recent_size=12, temperature=1e-4, top_p=0.9)
PREFILL = 32
GEN = 20


def _engines(spec_kw=SPEC_KW, eos=2, **engine_kw):
    pj = jl.init_params(jax.random.PRNGKey(0), jcfg.TINY_TARGET,
                        dtype=jnp.float32)
    dj = jl.init_params(jax.random.PRNGKey(1), jcfg.TINY_DRAFT,
                        dtype=jnp.float32)
    pt = tl.params_from_numpy(jax.tree.map(np.asarray, pj),
                              tcfg.TINY_TARGET, "cpu")
    dt = tl.params_from_numpy(jax.tree.map(np.asarray, dj),
                              tcfg.TINY_DRAFT, "cpu")
    common = dict(prefill=PREFILL, max_cache_len=PREFILL + 64,
                  prefill_chunk=16, draft_prefill_chunk=8, eos_token_id=eos,
                  **engine_kw)
    je = JEngine(jcfg.TINY_TARGET, jcfg.SpecConfig(**spec_kw), pj,
                 draft_cfg=jcfg.TINY_DRAFT, draft_params=dj,
                 dtype=jnp.float32, donate=False, **common)
    te = TEngine(tcfg.TINY_TARGET, tcfg.SpecConfig(**spec_kw), pt,
                 draft_cfg=tcfg.TINY_DRAFT, draft_params=dt,
                 dtype=torch.float32, device="cpu", **common)
    return je, te


def _prefilled(je, te, ids):
    js = je.init_state(jax.random.PRNGKey(100))
    js = je.prefill_draft(je.prefill_target(js, jnp.asarray(ids)),
                          jnp.asarray(ids))
    ts = te.init_state(100)
    ts = te.prefill_draft(te.prefill_target(ts, torch.from_numpy(ids)),
                          torch.from_numpy(ids))
    return js, ts


@pytest.fixture(scope="module")
def pair():
    je, te = _engines()
    ids = np.random.default_rng(2).integers(0, 199, (1, PREFILL))
    js, ts = _prefilled(je, te, ids)
    return je, te, js, ts, ids


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_prefill_states_match(pair):
    _, _, js, ts, _ = pair
    assert int(js.next_token[0]) == int(ts.next_token[0])
    assert int(js.kv.seq_len) == int(ts.kv.seq_len) == PREFILL
    _close(js.kv.k, ts.kv.k)
    _close(js.rkv.k, ts.rkv.k)
    _close(js.rkv.v, ts.rkv.v)
    _close(js.dkv.k, ts.dkv.k)
    assert int(js.dkv.seq_len) == int(ts.dkv.seq_len)


@pytest.mark.parametrize("mode", ["retrieval", "triforce"])
def test_spec_generation_token_identity_and_state(pair, mode):
    je, te, js, ts, _ = pair
    jst, jbuf, jn, jcnt, _ = je.generate(js, GEN, mode=mode)
    tst, tbuf, tn, tcnt = te.generate(ts.clone(seed=5), GEN, mode=mode)
    assert int(jn) == tn
    assert np.asarray(jbuf)[:tn].tolist() == tbuf[:tn].tolist()
    assert np.asarray(jcnt).tolist() == tcnt.tolist()
    # caches after several steps: live prefix, retrieval cache, drafter
    n_live = int(jst.kv.seq_len)
    assert int(tst.kv.seq_len) == n_live
    _close(jst.kv.k[:, :, :, :n_live], tst.kv.k[:, :, :, :n_live])
    _close(jst.rkv.k[:, :, :, :SPEC_KW["budget"]],
           tst.rkv.k[:, :, :, :SPEC_KW["budget"]])
    _close(jst.rkv.v[:, :, :, :SPEC_KW["budget"]],
           tst.rkv.v[:, :, :, :SPEC_KW["budget"]])
    if mode == "triforce":
        _close(jst.dkv.k, tst.dkv.k)
    assert int(jst.next_token[0]) == int(tst.next_token[0])


def test_ar_token_identity(pair):
    je, te, js, ts, _ = pair
    _, _, _, jbuf = je.generate_ar(js.kv, js.next_token,
                                   jax.random.PRNGKey(3), GEN)
    st = ts.clone(seed=3)
    kv, _, _, tbuf = te.generate_ar(st.kv, st.next_token, st.gen, GEN)
    assert np.asarray(jbuf).tolist() == tbuf.tolist()
    assert int(kv.seq_len) == PREFILL + GEN


def test_decoding_drivers_match(pair):
    je, te, _, _, ids = pair
    for jfn, tfn in ((jdec.autoregressive, tdec.autoregressive),
                     (jdec.triforce, tdec.triforce),
                     (jdec.retrieval_spec, tdec.retrieval_spec)):
        jr = jfn(je, jnp.asarray(ids), max_len=GEN, seed=9)
        tr = tfn(te, torch.from_numpy(ids), max_len=GEN, seed=9,
                 device="cpu")
        assert jr.tokens == tr.tokens
        assert jr.steps == tr.steps


def test_forced_acceptance_one_matches():
    """Forced acceptance 1.0 accepts every proposal at both levels: with
    one-hot distributions the whole run is deterministic. The prompt is
    seed 3's: seed 2's run meets a near tie in the middle bonus of its
    fourth step (0.629 against 0.371), where each package's random stream
    picks either token."""
    je, te = _engines()
    js, ts = _prefilled(je, te, np.random.default_rng(3).integers(
        0, 199, (1, PREFILL)))
    _, jbuf, jn, jcnt, _ = je.generate_forced(js, GEN, 1.0, mode="triforce")
    _, tbuf, tn, tcnt = te.generate_forced(ts.clone(seed=1), GEN, 1.0,
                                           mode="triforce")
    assert int(jn) == tn
    assert np.asarray(jbuf)[:tn].tolist() == tbuf[:tn].tolist()
    assert np.asarray(jcnt).tolist() == tcnt.tolist()


def test_middle_chain_and_fixed_trips_match():
    kw = dict(SPEC_KW, gamma=4, middle_chain=2, middle_trips=4)
    je, te = _engines(kw)
    ids = np.random.default_rng(8).integers(0, 199, (1, PREFILL))
    js, ts = _prefilled(je, te, ids)
    _, jbuf, jn, jcnt, _ = je.generate(js, 16, mode="triforce")
    _, tbuf, tn, tcnt = te.generate(ts, 16, mode="triforce")
    assert int(jn) == tn
    assert np.asarray(jbuf)[:tn].tolist() == tbuf[:tn].tolist()
    assert np.asarray(jcnt).tolist() == tcnt.tolist()


def test_accepted_eos_stop_matches(pair):
    """An EOS id that the stream emits mid-step: the stop, the emitted
    count and the extra rollback (next_token never in kv) match JAX."""
    je0, te0, js, ts, ids = pair
    _, jbuf, jn, _, _ = je0.generate(js, GEN, mode="retrieval")
    eos = int(np.asarray(jbuf)[4])
    je, te = _engines(eos=eos)
    js2, ts2 = _prefilled(je, te, ids)
    jst, jbuf, jn, jcnt, _ = je.generate(js2, GEN, mode="retrieval",
                                         stop_on_eos=True)
    tst, tbuf, tn, tcnt = te.generate(ts2, GEN, mode="retrieval",
                                      stop_on_eos=True)
    assert int(jn) == tn
    assert np.asarray(jbuf)[:tn].tolist() == tbuf[:tn].tolist()
    assert np.asarray(jcnt).tolist() == tcnt.tolist()
    assert int(jst.kv.seq_len) == int(tst.kv.seq_len)
    assert int(jst.next_token[0]) == int(tst.next_token[0])


def test_no_device_without_cuda_raises(pair, monkeypatch):
    """With no device given and no CUDA card, building an Engine or calling
    a decoding driver raises instead of running on the CPU."""
    _, te, _, _, ids = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine(tcfg.TINY_TARGET, tcfg.SpecConfig(**SPEC_KW), te.t_params,
                prefill=PREFILL, max_cache_len=PREFILL + 64)
    for fn in (tdec.autoregressive, tdec.triforce, tdec.retrieval_spec):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(te, torch.from_numpy(ids), max_len=4)


@pytest.mark.parametrize("build", [
    lambda spec: tcache.init_kv(tcfg.TINY_TARGET, 8),
    lambda spec: tcache.init_retrieval(tcfg.TINY_TARGET, spec),
    lambda spec: tcache.init_streaming(tcfg.TINY_DRAFT, spec),
    lambda spec: trope.cos_sin_tables(tcfg.TINY_TARGET, max_len=8),
], ids=["init_kv", "init_retrieval", "init_streaming", "cos_sin_tables"])
def test_constructors_without_device_raise(build, monkeypatch):
    """The cache constructors and the rope tables follow the same rule:
    no device and no CUDA card raises; ``device="cpu"`` is never implied."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(tcfg.SpecConfig(**SPEC_KW))


@pytest.mark.parametrize("option,spec_kw,ported", [
    (dict(mesh=object()), {}, False),
    (dict(weight_quant=True), dict(mid_act_quant=True), True),
], ids=["mesh", "mid_act_quant"])
def test_unported_options_raise(pair, option, spec_kw, ported):
    """A mesh that is not a ``parallel.mesh.Mesh`` is refused rather than
    quietly run as something else (the mesh itself is ported:
    ``test_torch_sharded_engine.py``). Int8 activations in the middle
    verify are ported: the Engine takes the option and quantizes its
    weights for it (``test_mid_act_quant_token_identity`` holds what it
    then computes)."""
    _, te, _, _, _ = pair

    def build():
        return TEngine(tcfg.TINY_TARGET,
                       tcfg.SpecConfig(**SPEC_KW, **spec_kw), te.t_params,
                       prefill=PREFILL, max_cache_len=PREFILL + 64,
                       device="cpu", **option)

    if ported:
        eng = build()
        assert eng.spec.mid_act_quant
        assert eng.t_params["lm_head"].dtype == torch.int8
    else:
        with pytest.raises(TypeError, match="Mesh"):
            build()


@pytest.fixture(scope="module")
def aq_pair():
    """int8 weights with int8 activations in the middle verify
    (``mid_act_quant``), both packages, on a prompt without near ties."""
    je, te = _engines(dict(SPEC_KW, mid_act_quant=True), weight_quant=True)
    ids = np.random.default_rng(2).integers(0, 199, (1, PREFILL))
    js, ts = _prefilled(je, te, ids)
    return je, te, js, ts


@pytest.mark.parametrize("mode", ["retrieval", "triforce"])
def test_mid_act_quant_token_identity(aq_pair, mode):
    """``mid_act_quant`` near-greedy: the middle verify's integer products
    are exact on both sides, so the port emits the JAX Engine's tokens and
    step counters."""
    je, te, js, ts = aq_pair
    _, jbuf, jn, jcnt, _ = je.generate(js, GEN, mode=mode)
    _, tbuf, tn, tcnt = te.generate(ts.clone(seed=5), GEN, mode=mode)
    assert int(jn) == tn
    assert np.asarray(jbuf)[:tn].tolist() == tbuf[:tn].tolist()
    assert np.asarray(jcnt).tolist() == tcnt.tolist()


def test_mid_act_quant_changes_the_middle_logits_and_rows_agree(aq_pair):
    """The option is live (the middle logits move by the activation
    rounding, not to zero) and the row-batched middle verify computes each
    row's batch-1 logits under it."""
    _, te, _, ts = aq_pair
    cfg, sp = tcfg.TINY_TARGET, te.spec
    ids = torch.from_numpy(np.random.default_rng(6).integers(
        0, 199, (2, sp.gamma + 1)))
    one = [tl.forward_spec(cfg, te.t_params, ids[b:b + 1], ts.rkv,
                           ts.kv.seq_len, sp.budget, commit=False,
                           act_quant=aq)[0] for b in range(2)
           for aq in (True, False)]
    gap = (one[0] - one[1]).abs().max().item()
    assert 0 < gap < 0.05 * one[1].abs().max().item()
    pool = tcache.stack_rows([ts.rkv, ts.rkv])
    rows = tl.forward_spec_rows(cfg, te.t_params, ids, pool,
                                torch.stack([ts.kv.seq_len] * 2), sp.budget,
                                act_quant=True)
    torch.testing.assert_close(rows[0], one[0][0], rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(rows[1], one[2][0], rtol=2e-5, atol=2e-5)


def test_state_clone_is_independent(pair):
    _, te, _, ts, _ = pair
    a = ts.clone(seed=4)
    before = ts.kv.k.clone()
    te.generate(a, 8, mode="retrieval")
    assert torch.equal(ts.kv.k, before)
    assert dataclasses.is_dataclass(a)
