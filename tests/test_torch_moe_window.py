"""The port's hybrid path (sliding-window layers on a ring beside full
ones, expert MLPs; ``config.HybridConfig``) against the plain float32
reference ``tests/plain_moe_window.py``, on the CPU, at Mellum2's shape
cut to test size: 4 layers (3 sliding + 1 full), window 16, ring 24, 8
experts top 2, vocabulary 199, every draw seeded.

The port runs in float32 here, so every comparison with the reference
allows float32 rounding only: the two sum the same products in other
orders (the reference over whole sequences, the port chunk by chunk, in
online-softmax blocks), which moves a value by a few ulps of the largest
term it sums; 1e-4 absolute on values of order 1 covers that with room
and fails on any wrong key, position, mask or expert.
"""

import dataclasses

import pytest
import torch

import plain_moe_window as ref
from triforce_tpu_torch import batching
from triforce_tpu_torch.batched_spec import BatchedSpecEngine, SpecScheduler
from triforce_tpu_torch.cache import init_kv
from triforce_tpu_torch.config import (SLIDING, TINY_DRAFT, TINY_MOE_WINDOW,
                                       SpecConfig)
from triforce_tpu_torch.engine import MOE_KINDS, Engine
from triforce_tpu_torch.models import llama
from triforce_tpu_torch.ops import flash_decode, moe
from triforce_tpu_torch.ops import retrieval as retrieval_ops
from triforce_tpu_torch.ops.flash_decode import causal_mask

torch.set_num_threads(1)
CFG = TINY_MOE_WINDOW
TOL = dict(atol=1e-4, rtol=1e-4)     # float32 summation order (docstring)
RING = CFG.sliding_window + 8        # the window + an 8-token forward
SPEC = SpecConfig(gamma=6, budget=16, chunk_size=4, draft_start_size=4,
                  draft_recent_size=24)
PREFILL = 64
REF = dict(vocab=CFG.vocab_size, hidden=CFG.hidden_size,
           heads=CFG.num_heads, kv_heads=CFG.num_kv_heads,
           head_dim=CFG.head_dim, eps=CFG.rms_norm_eps,
           layer_types=CFG.layer_types, window=CFG.sliding_window,
           theta_full=CFG.rope.theta,
           yarn=(CFG.rope.scaling_factor,
                 CFG.rope.original_max_position_embeddings),
           theta_local=CFG.rope_local.theta,
           top_k=CFG.num_experts_per_tok, norm_topk=CFG.norm_topk_prob)


def _weights(seed: int) -> dict:
    """float32 weights in the port's layout, each matrix N(0, 1 / fan_in)
    so attention and routing are decisive (the init's 0.02 leaves them
    near uniform, where a wrong mask barely shows)."""
    g = torch.Generator().manual_seed(seed)
    h, d, e, i = CFG.hidden_size, CFG.head_dim, CFG.num_experts, \
        CFG.moe_intermediate_size
    n = CFG.num_layers

    def mat(*shape, fan):
        return torch.randn(shape, generator=g) / fan ** 0.5

    return {"embed": torch.randn((CFG.vocab_size, h), generator=g),
            "layers": {
                "wq": mat(n, h, CFG.num_heads * d, fan=h),
                "wk": mat(n, h, CFG.num_kv_heads * d, fan=h),
                "wv": mat(n, h, CFG.num_kv_heads * d, fan=h),
                "wo": mat(n, CFG.num_heads * d, h, fan=4 * h),
                "ln_attn": 1 + 0.1 * torch.randn((n, h), generator=g),
                "ln_mlp": 1 + 0.1 * torch.randn((n, h), generator=g),
                "w_router": mat(n, e, h, fan=h / 9),
                "w_gate_e": mat(n, e, i, h, fan=h),
                "w_up_e": mat(n, e, i, h, fan=h),
                "w_down_e": mat(n, e, h, i, fan=4 * i)},
            "final_norm": 1 + 0.1 * torch.randn((h,), generator=g),
            "lm_head": mat(h, CFG.vocab_size, fan=h)}


def _ids(n: int, seed: int) -> torch.Tensor:
    return torch.randint(3, CFG.vocab_size, (n,),
                         generator=torch.Generator().manual_seed(seed))


def _check_cache(kv, kvs, length: int):
    """The full layer's cache and every sliding layer's ring against the
    reference's K/V of the first ``length`` positions: all of them in the
    full cache, the last ``window`` at their ring slots."""
    plan = CFG.plan
    assert int(kv.seq_len) == length
    lo = max(0, length - CFG.sliding_window)
    pos = torch.arange(lo, length)
    for li, (k, v) in enumerate(kvs):
        si = plan.slot[li]
        if plan.attn[li] == SLIDING:
            got_k = kv.ring_k[si, 0][:, pos % kv.ring_slots]
            got_v = kv.ring_v[si, 0][:, pos % kv.ring_slots]
            want_k, want_v = k[lo:length], v[lo:length]
        else:
            got_k, got_v = kv.k[si, 0, :, :length], kv.v[si, 0, :, :length]
            want_k, want_v = k[:length], v[:length]
        torch.testing.assert_close(got_k, want_k.transpose(0, 1), **TOL)
        torch.testing.assert_close(got_v, want_v.transpose(0, 1), **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_then_decode_through_the_ring_with_rollbacks(seed):
    """Chunked prefill, then forwards of 1-8 tokens, each followed by a
    rollback of 1..gamma+1 of them, well past the ring's wrap: every
    forward's logits equal the reference's full forward at its positions,
    and after each rollback the caches hold what the reference does (the
    ring invariant)."""
    w = _weights(seed)
    kv = init_kv(CFG, 160, dtype=torch.float32, device="cpu", ring_slack=8)
    assert kv.ring_slots == RING and kv.k.shape[0] == CFG.num_full_layers
    g = torch.Generator().manual_seed(100 + seed)
    seq = _ids(40, seed)
    for s in range(0, 40, 8):
        logits, kv, _ = llama.forward_append(CFG, w, seq[None, s:s + 8], kv)
        want, _ = ref.forward(REF, w, seq[:s + 8])
        torch.testing.assert_close(logits[0], want[s:s + 8], **TOL)
    for step in range(14):
        t = [1, 7, 8][step % 3]
        new = torch.randint(3, CFG.vocab_size, (t,), generator=g)
        full = torch.cat([seq, new])
        logits, kv, _ = llama.forward_append(CFG, w, new[None], kv)
        want, _ = ref.forward(REF, w, full)
        torch.testing.assert_close(logits[0], want[-t:], **TOL)
        back = int(torch.randint(1, min(t, SPEC.gamma + 1) + 1, (1,),
                                 generator=g))
        kv = kv.rollback(back)
        seq = full[:full.shape[0] - back]
        _check_cache(kv, ref.forward(REF, w, seq)[1], seq.shape[0])
    assert seq.shape[0] > 2 * RING


@pytest.mark.parametrize("length", [5, 15, 16, 23, 24, 25, 40, 97])
@pytest.mark.parametrize("tokens", [1, 8])
def test_window_attention_over_a_ring_matches_plain_attention(length,
                                                              tokens):
    """B1's plain version with a window (``flash_decode_append_plain``,
    what the window kernel is held to on the card) over a ring of 24
    slots holding a sequence of ``length`` tokens: equal to attention over
    the sequence itself, each query seeing its last 16 positions."""
    g = torch.Generator().manual_seed(length * 10 + tokens)
    hkv, grp, d, win = 2, 2, 16, CFG.sliding_window
    keys = torch.randn((hkv, length + tokens, d), generator=g)
    vals = torch.randn((hkv, length + tokens, d), generator=g)
    q = torch.randn((hkv, grp * tokens, d), generator=g)
    ring_k = torch.randn((hkv, RING, d), generator=g)      # stale slots
    ring_v = torch.randn((hkv, RING, d), generator=g)
    for p in range(max(0, length - RING), length):
        ring_k[:, p % RING], ring_v[:, p % RING] = keys[:, p], vals[:, p]
    got = flash_decode.flash_decode_append_plain(
        q, ring_k, ring_v, keys[:, length:], vals[:, length:],
        torch.tensor(length, dtype=torch.int32),
        causal_mask(tokens, tokens, grp, "cpu"), window=win)
    # the same attention written over positions
    want = torch.empty_like(got)
    for r in range(grp * tokens):
        p = length + r % tokens
        lo = max(0, p - win + 1)
        sc = keys[:, lo:p + 1] @ q[:, r, :, None] / d ** 0.5
        pr = torch.softmax(sc[..., 0], -1)
        want[:, r] = (pr[..., None] * vals[:, lo:p + 1]).sum(1)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_matches_the_reference(seed):
    """The port's router: the reference's top-k experts in order and its
    renormalised weights."""
    w = _weights(seed)["layers"]["w_router"][0]
    h = torch.randn((32, CFG.hidden_size),
                    generator=torch.Generator().manual_seed(seed))
    idx, wt = moe.route_plain(h, w, CFG.num_experts_per_tok)
    want_e, want_w = ref.route(h, w, CFG.num_experts_per_tok)
    assert torch.equal(idx.long(), want_e)
    torch.testing.assert_close(wt, want_w, **TOL)
    torch.testing.assert_close(wt.sum(-1), torch.ones(32), **TOL)


def test_experts_match_the_reference_per_token():
    lw = _weights(3)["layers"]
    h = torch.randn((20, CFG.hidden_size),
                    generator=torch.Generator().manual_seed(3))
    got = moe.moe_mlp(h, {k: v[1] for k, v in lw.items()},
                      CFG.num_experts_per_tok)
    want = ref.moe(h, lw["w_router"][1], lw["w_gate_e"][1], lw["w_up_e"][1],
                   lw["w_down_e"][1], CFG.num_experts_per_tok)
    torch.testing.assert_close(got, want, **TOL)


def _engine(w, seed: int = 5, **kw):
    draft = llama.init_params(TINY_DRAFT, device="cpu", dtype=torch.float32,
                              seed=seed)
    return Engine(CFG, SPEC, w, draft_cfg=TINY_DRAFT, draft_params=draft,
                  prefill=PREFILL, max_cache_len=256, dtype=torch.float32,
                  prefill_chunk=8, device="cpu", **kw)


def test_retrieval_build_covers_the_full_layer_only():
    """The build reads the full layer's cache with the last prompt
    token's query and fills a retrieval cache of one plane (the full
    layer); the sliding layers keep only their rings."""
    w = _weights(4)
    eng = _engine(w)
    ids = _ids(PREFILL, 4)
    st = eng.prefill_target(eng.init_state(4), ids[None])
    assert st.rkv.k.shape[0] == CFG.num_full_layers == 1
    assert st.kv.ring_k.shape[0] == 3 and st.kv.ring_slots == RING
    qs = []
    _, kvs = ref.forward(REF, w, ids, queries=qs)
    _check_cache(st.kv, kvs, PREFILL)
    # the build of the full layer from the reference's last query
    q = qs[CFG.plan.full[0]][-1:].transpose(0, 1)[None]   # [1, Hq, 1, D]
    k_sel, v_sel = retrieval_ops.build_layer(
        q, st.kv.k[0], st.kv.v[0], PREFILL, SPEC.chunk_size, SPEC.budget)
    torch.testing.assert_close(st.rkv.k[0, :, :, :SPEC.budget], k_sel, **TOL)
    torch.testing.assert_close(st.rkv.v[0, :, :, :SPEC.budget], v_sel, **TOL)


def _sequence(prompt, buf, n):
    """What the full cache holds after a call: the prompt and every token
    the call emitted but its last (the pending next token)."""
    return torch.cat([prompt, torch.as_tensor(buf[:n - 1])])


@pytest.mark.parametrize("mode", ["triforce", "retrieval"])
def test_generate_forced_leaves_the_reference_caches(mode):
    """``generate_forced`` (every accept a coin at 0.9, all real forwards
    run: drafter, middle verifies over the retrieval cache and the rings,
    the target verify, rollback, tail refresh) in two calls: the caches
    then hold exactly the reference's K/V of the tokens it reports, the
    ring's window included, and the engine's expert counters count every
    sparse layer call of each forward kind."""
    w = _weights(6)
    eng = _engine(w)
    prompt = _ids(PREFILL, 6)
    st = eng.prefill_target(eng.init_state(6), prompt[None])
    st = eng.prefill_draft(st, prompt[None])
    seq = prompt
    counters = 0
    for _ in range(2):
        st, buf, n, c = eng.generate_forced(st, 20, 0.9, mode=mode)
        seq = _sequence(seq, buf, n)
        counters = counters + c
    _check_cache(st.kv, ref.forward(REF, w, seq)[1], seq.shape[0])
    assert seq.shape[0] > PREFILL + RING
    steps, mid_verify = int(counters[0]), int(counters[7])
    layers, k = CFG.num_layers, CFG.num_experts_per_tok
    named = eng.moe_counters()
    got = {kind: [named[f"moe.{n}.{kind}"] for n in
                  ("experts_read", "tokens_routed", "layer_calls")]
           for kind in MOE_KINDS}
    assert got["target"][2] == steps * layers
    assert got["target"][1] == steps * (SPEC.gamma + 2) * k * layers
    assert got["middle"][2] == mid_verify * layers
    assert got["prefill"][2] == (-(-(PREFILL - 1) // 8) + 1) * layers
    assert got["prefill"][1] == PREFILL * k * layers
    for kind, (read, routed, calls) in got.items():
        assert calls <= read <= min(routed, calls * CFG.num_experts), kind


def test_generate_ar_leaves_the_reference_caches():
    w = _weights(7)
    eng = _engine(w)
    prompt = _ids(PREFILL, 7)
    st = eng.prefill_target(eng.init_state(7), prompt[None])
    kv, tok, _, buf = eng.generate_ar(st.kv, st.next_token, st.gen, 30)
    seq = torch.cat([prompt, st.next_token, buf[:-1]])
    _check_cache(kv, ref.forward(REF, w, seq)[1], seq.shape[0])
    # greedy-free check of the last token's distribution is the target's:
    # the logits of the last forward equal the reference's
    logits, _, _ = llama.forward_append(CFG, w, buf[-1:][None],
                                        dataclasses.replace(kv))
    torch.testing.assert_close(logits[0, -1],
                               ref.forward(REF, w, torch.cat(
                                   [seq, buf[-1:]]))[0][-1], **TOL)


def _refusals():
    from triforce_tpu_torch.tree import planner
    from triforce_tpu_torch.tree.spectree import TreeEngine

    def tree(eng, w):
        p = planner.modeled_acceptance_vector(0.8, max_branch=3)
        t, choice = planner.plan_tree(p, max_budget=8, max_depth=4)
        TreeEngine(CFG, planner.build_grow_map(t, choice, 8, 4), w,
                   prefill=PREFILL, max_cache_len=128, device="cpu")

    def rows(eng, w):
        kv = init_kv(CFG, 32, dtype=torch.float32, device="cpu")
        llama.forward_append_rows(CFG, w, torch.zeros((2, 1), dtype=torch.long),
                                  dataclasses.replace(kv, seq_len=torch.zeros(
                                      2, dtype=torch.int32)))

    return {
        "batched rows": lambda eng, w: BatchedSpecEngine(eng, "triforce"),
        "spec serving": lambda eng, w: SpecScheduler(eng, "triforce"),
        "ar serving": lambda eng, w: batching.Scheduler(
            CFG, SPEC, w, device="cpu"),
        "tree": tree,
        "rows forward": rows,
        "mesh": lambda eng, w: _engine(w, mesh=object()),
        "int8 kv": lambda eng, w: _engine(w, kv_quant=True),
        "int8 weights": lambda eng, w: _engine(w, weight_quant=True),
        "dense beside sparse MLPs": lambda eng, w: CFG.with_(
            mlp_layer_types=("dense",) + ("sparse",) * 3).plan,
    }


@pytest.mark.parametrize("path", sorted(_refusals()))
def test_unported_paths_refuse_a_hybrid_model(path):
    w = _weights(8)
    eng = _engine(w)
    with pytest.raises(NotImplementedError,
                       match="sliding-window or expert|expert layers"):
        _refusals()[path](eng, w)


def test_trace_regions_split_the_step_by_layer_kind():
    """Under the tracer each forward stamps a ``moe`` region a sparse
    layer and a ``window_attn`` region a sliding layer (what
    ``probes/torch_trace_cells.py`` splits a step into)."""
    from triforce_tpu_torch import profiling
    w = _weights(9)
    eng = _engine(w)
    prompt = _ids(PREFILL, 9)
    st = eng.prefill_target(eng.init_state(9), prompt[None])
    st = eng.prefill_draft(st, prompt[None])
    with profiling.tracing(torch.device("cpu")) as tr:
        st, _, _, c = eng.generate_forced(st, 12, 0.9, mode="triforce")
    regions = tr.summary()["regions"]
    forwards = int(c[0]) + int(c[7])        # target and middle verifies
    assert regions["moe"]["count"] == forwards * CFG.num_layers
    assert regions["window_attn"]["count"] == \
        forwards * len(CFG.plan.sliding)
