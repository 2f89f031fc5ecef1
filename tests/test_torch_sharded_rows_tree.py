"""The rest of the mesh in the port: the tree engine over tp and sp, the
batched rows and ``SpecScheduler`` over dp, the composed dp x tp x sp
mesh, and the command line over all of them (``TreeEngine(mesh=,
shard_seq=)``, ``forward_tree_spec(mesh=)``, ``BatchedSpecEngine(mesh=)``,
``SpecScheduler(mesh=)``, ``cli --dp / --batch / --mode tree / serve``).

Module functions run with their ranks as threads of this process
(``run_threads``), the engines and the command line as gloo processes of
``torch_mesh_worker.py``; the JAX references are made here, on the
8-virtual-device mesh where the JAX package shards.

Tolerances: the module functions in fp32 hold 2e-5 against JAX's sharded
functions and the port's meshless ones (split sums move the last bits
only); every rank must hold the same bits. The engines' tokens must equal
the port's one-process run at the same seed (fp32, temperature 0.2 or 0.3:
splitting the work moves the logits by float rounding alone), and the JAX
package's near-greedy (temperature 1e-3 for the tree, 1e-4 for the rows:
every sampled distribution one-hot, on prompts with no near tie).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_mesh_worker import (launch, run_rows_case, run_serve_case,
                               run_threads, run_tree_case, save_params,
                               shared, tree_grow_map)
from triforce_tpu import batched_spec as jbs
from triforce_tpu import batching as jbatching
from triforce_tpu import cache as jcache
from triforce_tpu import config as jcfg
from triforce_tpu.engine import Engine as JEngine
from triforce_tpu.models import llama as jl
from triforce_tpu.parallel import mesh as jmesh
from triforce_tpu.parallel import sharding as jsh
from triforce_tpu.tree import planner as jplan
from triforce_tpu.tree import spectree as jtree
from triforce_tpu_torch import cache as tcache
from triforce_tpu_torch import config as tcfg
from triforce_tpu_torch.models import llama as tl
from triforce_tpu_torch.ops import attention as tatt
from triforce_tpu_torch.ops import sp_attention as tsp
from triforce_tpu_torch.parallel import sharding as tsh

torch.set_num_threads(1)

JC, TC = jcfg.TINY_TARGET, tcfg.TINY_TARGET
TOL = dict(rtol=2e-5, atol=2e-5)
SPEC = dict(gamma=3, budget=16, chunk_size=4, draft_start_size=4,
            draft_recent_size=12, top_p=0.9)
PREFILL = 32


def _np(x):
    return np.array(x)


def _same_on_every_rank(outs):
    for o in outs[1:]:
        np.testing.assert_array_equal(np.asarray(o), np.asarray(outs[0]))
    return outs[0]


# ---------------------------------------------------------------------------
# module functions, ranks as threads
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def target():
    pj = jl.init_params(jax.random.PRNGKey(0), JC, dtype=jnp.float32)
    pt = tl.params_from_numpy(jax.tree.map(np.asarray, pj), TC, "cpu")
    return pj, pt


def _heads(x, mesh, axis=2):
    n = x.shape[axis] // mesh.shape["tp"]
    return x.narrow(axis, mesh.index("tp") * n, n)


def _slots(x, mesh, axis=3):
    n = x.shape[axis] // mesh.shape["sp"]
    return x.narrow(axis, mesh.index("sp") * n, n)


def _local_kv(kv, mesh):
    """This rank's shard of a full [L, 1, Hkv, S, D] cache (heads over
    tp, slots over sp)."""
    def cut(x, sdim):
        return None if x is None else \
            _slots(_heads(x, mesh), mesh, sdim).clone()
    return tcache.KVCache(cut(kv.k, 3), cut(kv.v, 3), kv.seq_len.clone(),
                          cut(kv.k_scale, 3), cut(kv.v_scale, 3))


def _local_rkv(rkv, mesh):
    def cut(x):
        return None if x is None else _heads(x, mesh).clone()
    return tcache.RetrievalCache(cut(rkv.k), cut(rkv.v), cut(rkv.k_scale),
                                 cut(rkv.v_scale))


def _assemble(parts, tp, sp, sdim=3):
    """Rank-ordered shards of a [L, 1, Hkv, S(, D)] plane -> the whole."""
    rows = [torch.cat([parts[t * sp + s] for s in range(sp)], sdim)
            for t in range(tp)]
    return torch.cat(rows, 2)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_forward_tree_spec_sharded_matches_jax(target, quant):
    """One root forward and one grow level with ``ssl = 1`` at tp 2 x sp 2,
    the tree's staged slots straddling the two sp shards (prefill 30 of 64
    slots): logits equal JAX's sharded grow (``forward_tree_spec(mesh=,
    shard_seq=True)`` on its 4-device mesh) and the meshless port, on
    every rank; the full cache's staged slots and the tree retrieval cache
    assemble to JAX's."""
    pj, pt = target
    gm = tree_grow_map()
    s, budget, seq = 64, 16, 30
    kv = tcache.init_kv(TC, s, dtype=torch.float32, device="cpu",
                        quant=quant)
    rkv = tcache.init_tree_retrieval(TC, budget, gm.size,
                                     dtype=torch.float32, device="cpu",
                                     quant=quant, pad=4)
    ids = torch.from_numpy(np.random.default_rng(5).integers(3, 199,
                                                             (1, seq)))
    _, kv, _ = tl.forward_append(TC, pt, ids[:, :-1], kv)
    _, kv, _ = tl.forward_append(TC, pt, ids[:, -1:], kv, build_rkv=rkv,
                                 prefill=seq, chunk_size=2, budget=budget)
    w = 4
    level = [dict(toks=[[17]], depths=gm.depth[0:1], mask=gm.mask[0:1],
                  start=0, staged=0),
             dict(toks=[[40, 41, 42, 43]], depths=gm.depth[1:1 + w],
                  mask=gm.mask[1:1 + w], start=1, staged=gm.size)]

    def jax_run():
        m = jmesh.make_mesh(tp=2, sp=2)

        def cache(c):
            names = ("k", "v", "k_scale", "v_scale")
            return {n: jnp.asarray(getattr(c, n).numpy()) for n in names
                    if getattr(c, n, None) is not None}
        kvj = jcache.KVCache(seq_len=jnp.asarray(seq, jnp.int32),
                             **cache(kv))
        rj = jcache.RetrievalCache(**cache(rkv))
        outs = []
        for lv in level:
            fn = jax.jit(lambda p, r, k, lv=lv: jl.forward_tree_spec(
                JC, p, jnp.asarray(lv["toks"]), r, jnp.asarray(seq,
                                                              jnp.int32),
                budget, depths=lv["depths"], ancestor_mask=lv["mask"],
                slot_start=lv["start"], kv=k, ssl=1, mesh=m,
                shard_seq=True, staged_len=lv["staged"]))
            lg, rj, kvj = fn(pj, rj, kvj)
            outs.append(_np(lg))
        return outs, _np(kvj.k), _np(rj.k)

    def port(mesh):
        p = pt if mesh is None else tsh.shard_params(pt, mesh, TC)
        k = kv.clone() if mesh is None else _local_kv(kv, mesh)
        r = rkv.clone() if mesh is None else _local_rkv(rkv, mesh)
        outs = []
        for lv in level:
            lg, r, k = tl.forward_tree_spec(
                TC, p, torch.tensor(lv["toks"]), r, k.seq_len, budget,
                depths=lv["depths"], ancestor_mask=lv["mask"],
                slot_start=lv["start"], kv=k, ssl=1, mesh=mesh,
                shard_seq=mesh is not None, staged_len=lv["staged"])
            outs.append(lg.numpy())
        return outs, k.k, r.k

    want, jk, jr = jax_run()
    single, sk, sr = port(None)
    ranks = run_threads(port, tp=2, sp=2)
    for i in range(len(level)):
        got = _same_on_every_rank([r[0][i] for r in ranks])
        np.testing.assert_allclose(got, want[i], **TOL)
        np.testing.assert_allclose(got, single[i], **TOL)
    full_k = _assemble([r[1] for r in ranks], 2, 2).numpy()
    rk = torch.cat([ranks[0][2], ranks[2][2]], 2).numpy()
    tol = dict(rtol=0, atol=0) if quant else TOL
    np.testing.assert_allclose(full_k[:, :, :, seq:seq + 1 + w],
                               jk[:, :, :, seq:seq + 1 + w], **tol)
    np.testing.assert_allclose(full_k, sk.numpy(), **tol)
    np.testing.assert_allclose(rk, jr, **tol)
    np.testing.assert_allclose(rk, sr.numpy(), **tol)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_gather_kv_incremental_straddles_two_shards(quant):
    """The accepted tree path's compaction over sp 2, the span [6, 12)
    straddling the shards' boundary at 8, both the read and the
    write-back: the assembled cache equals the meshless port's and JAX's."""
    rng = np.random.default_rng(0)
    shape = (2, 1, 2, 16, 4)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    if quant:
        k = np.round(k * 40).clip(-127, 127).astype(np.int8)
        v = np.round(v * 40).clip(-127, 127).astype(np.int8)
    scales = [rng.random(shape[:4]).astype(np.float32) + 0.5
              for _ in range(2)] if quant else [None, None]
    accept = np.array([0, 3, 5, 2, 0, 0])
    offset, n_acc, max_span = 6, 4, 6

    def cache():
        sc = [None if x is None else torch.from_numpy(x.copy())
              for x in scales]
        return tcache.KVCache(torch.from_numpy(k.copy()),
                              torch.from_numpy(v.copy()),
                              torch.tensor(12, dtype=torch.int32), *sc)

    def run(mesh):
        kv = cache() if mesh is None else _local_kv(cache(), mesh)
        out = tcache.gather_kv_incremental(
            kv, torch.from_numpy(accept), n_acc, offset, len(accept),
            max_span, mesh=mesh)
        return out.k, out.v, out.k_scale, int(out.seq_len)

    single = run(None)
    ranks = run_threads(run, sp=2)
    assert all(r[3] == offset + n_acc for r in ranks)
    for i in range(3 if quant else 2):
        got = _assemble([r[i] for r in ranks], 1, 2)
        assert torch.equal(got, single[i])
    jkv = jcache.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                         seq_len=jnp.asarray(12, jnp.int32),
                         **({} if not quant else dict(
                             k_scale=jnp.asarray(scales[0]),
                             v_scale=jnp.asarray(scales[1]))))
    jout = jcache.gather_kv_incremental(
        jkv, jnp.asarray(accept, jnp.int32), jnp.asarray(n_acc, jnp.int32),
        jnp.asarray(offset, jnp.int32), len(accept), max_span)
    np.testing.assert_array_equal(single[0].numpy(), _np(jout.k))
    np.testing.assert_array_equal(single[1].numpy(), _np(jout.v))


def test_batched_commit_straddles_two_shards():
    """The rows' commit into a full cache split over sp 2: windows at 5 and
    7 straddle the boundary at 8, one at 0 misses the second shard, one
    clamps at the end; the assembled cache and the retrieval refresh
    equal the meshless port's, bit for bit."""
    rng = np.random.default_rng(1)
    rows, t_new, s = 4, 4, 16
    spec = tcfg.SpecConfig(gamma=2, budget=8, chunk_size=4)
    old = torch.tensor([5, 7, 0, 15], dtype=torch.int32)
    new_len = old + torch.tensor([3, 4, 1, 1], dtype=torch.int32)
    nk = torch.from_numpy(rng.standard_normal(
        (rows, 2, 2, t_new, 4)).astype(np.float32))
    nv = nk * 2 + 1

    def run(mesh):
        kv = tcache.init_kv_rows(TC.with_(num_kv_heads=2, head_dim=4), s,
                                 rows, torch.float32, device="cpu")
        kv = dataclasses.replace(kv, seq_len=new_len.clone())
        kv.k.copy_(torch.arange(kv.k.numel(), dtype=torch.float32)
                   .reshape(kv.k.shape))
        if mesh is not None:
            kv = dataclasses.replace(kv, k=_slots(kv.k, mesh).clone(),
                                     v=_slots(kv.v, mesh).clone())
        rkv = tcache.init_retrieval_rows(
            TC.with_(num_kv_heads=2, head_dim=4), spec, rows,
            torch.float32, device="cpu")
        kv, rkv = tcache.batched_commit_and_refresh(
            kv, rkv, nk, nv, old, spec, prefill=4, mesh=mesh)
        return kv.k, kv.v, rkv.k

    single = run(None)
    ranks = run_threads(run, sp=2)
    for i in range(2):
        assert torch.equal(torch.cat([r[i] for r in ranks], 3), single[i])
    assert all(torch.equal(r[2], single[2]) for r in ranks)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_rows_attention_sharded_matches_rows(quant):
    """``append_attention_rows_sharded`` at tp 2 x sp 2, three rows at
    lengths 10, 0 (a dead row) and 25 over 32 slots (the second shard
    empty for the first row): the rows' output on every rank of a tp
    index equals the meshless ``append_attention_rows``."""
    rng = np.random.default_rng(2)
    b, hq, hkv, t, s, d = 3, 4, 2, 3, 32, 8
    q = torch.from_numpy(rng.standard_normal((b, hq, t, d)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((b, hkv, s, d)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((b, hkv, s, d)).astype(
        np.float32))
    kn, vn = k[:, :, :t] * 0.5, v[:, :, :t] * 0.5
    ks = vs = None
    if quant:
        k, ks = tcache.quantize_tokens(k)
        v, vs = tcache.quantize_tokens(v)
    k_len = torch.tensor([10, 0, 25], dtype=torch.int32)
    want = tatt.append_attention_rows(q, k, v, kn, vn, k_len=k_len,
                                      k_scale=ks, v_scale=vs)

    def run(mesh):
        def cut(x, sdim=2):
            return None if x is None else _slots(_heads(x, mesh, 1), mesh,
                                                 sdim).contiguous()
        return tsp.append_attention_rows_sharded(
            mesh, _heads(q, mesh, 1), cut(k), cut(v), _heads(kn, mesh, 1),
            _heads(vn, mesh, 1), k_len=k_len, k_scale=cut(ks),
            v_scale=cut(vs))

    ranks = run_threads(run, tp=2, sp=2)
    for ti in range(2):
        got = _same_on_every_rank([ranks[ti * 2 + si].numpy()
                                   for si in range(2)])
        np.testing.assert_allclose(got, want[:, 2 * ti:2 * ti + 2].numpy(),
                                   **TOL)


def test_row_block_and_batched_shardings():
    """Rows split in contiguous blocks over dp (JAX's ``P("dp")``); a
    row-stacked cache's spec puts dp first; rows that do not divide
    raise."""
    def run(mesh):
        sh = tsh.batched_state_shardings(mesh, TC, tcfg.TINY_DRAFT,
                                         shard_seq=True)
        return (list(tsh.row_block(mesh, 8)),
                sh.kv["k"].local_shape((8, 2, 2, 64, 16)),
                sh.rkv["k"].local_shape((8, 2, 2, 20, 16)),
                sh.dkv["k"].local_shape((8, 2, 2, 20, 16)),
                tuple(sh.kv["k"].spec))

    outs = run_threads(run, tp=2, sp=2, dp=2)
    assert outs[0][0] == [0, 1, 2, 3] and outs[7][0] == [4, 5, 6, 7]
    assert outs[0][1] == (4, 2, 1, 32, 16)
    assert outs[0][2] == (4, 2, 1, 20, 16)
    assert outs[0][3] == (4, 2, 2, 20, 16)
    # JAX's P("dp", None, None, "tp", "sp", None) over [B, L, 1, Hkv, S, D]
    jspec = jsh.batched_state_shardings(jmesh.make_mesh(dp=2, tp=2, sp=2),
                                        JC, jcfg.TINY_DRAFT,
                                        shard_seq=True).kv.k.spec
    assert outs[0][4] == tuple(jspec)[:2] + tuple(jspec)[3:]
    with pytest.raises(ValueError, match="divide"):
        run_threads(lambda m: tsh.row_block(m, 3), dp=2)


# ---------------------------------------------------------------------------
# the engines over gloo processes
# ---------------------------------------------------------------------------

def _job(tmp, tree_seed=5):
    pj = jl.init_params(jax.random.PRNGKey(0), JC, dtype=jnp.float32)
    dj = jl.init_params(jax.random.PRNGKey(1), jcfg.TINY_DRAFT,
                        dtype=jnp.float32)
    path = str(tmp / "params.npz")
    save_params(path, t=jax.tree.map(np.asarray, pj),
                d=jax.tree.map(np.asarray, dj))
    rng = np.random.default_rng(2)
    rows = [rng.integers(0, 199, (PREFILL,)).tolist() for _ in range(4)]
    reqs = [np.random.default_rng(90 + i).integers(0, 199, (PREFILL,))
            .tolist() for i in range(4)]
    tree_ids = np.random.default_rng(tree_seed).integers(3, 199,
                                                         (1, PREFILL))
    return pj, dj, dict(
        kind="cases", params=path, target_cfg=dataclasses.asdict(TC),
        spec=SPEC, prefill=PREFILL, rows=rows, seeds=[11, 22, 33, 44],
        requests=reqs, tree_ids=tree_ids.tolist())


TREE_CASES = {"plain": {}, "kv_quant": dict(kv_quant=True),
              "ssl1": dict(ssl=1)}
NEAR_GREEDY_TREE = 1e-3
NEAR_GREEDY = 1e-4


def _jax_tree(pj, job, case):
    eng = jtree.TreeEngine(
        JC, tree_grow_map_jax(), pj, prefill=PREFILL,
        max_cache_len=PREFILL + 64, budget=SPEC["budget"],
        chunk_size=SPEC["chunk_size"], temperature=NEAR_GREEDY_TREE,
        top_p=0.9, dtype=jnp.float32, prefill_chunk=16, donate=False,
        **TREE_CASES[case])
    st = eng.prefill_target(eng.init_state(jax.random.PRNGKey(7)),
                            jnp.asarray(job["tree_ids"]))
    out = []
    for _ in range(4):
        st, s = eng.step(st)
        out.append([int(s.n_nodes), int(s.n_emitted),
                    _np(s.tokens).tolist(), int(st.kv.seq_len)])
        if bool(s.terminal):
            break
    return out


def tree_grow_map_jax(size=8, depth=4, branch=3):
    p = jplan.modeled_acceptance_vector(0.8, max_branch=branch)
    tree, choice = jplan.plan_tree(p, max_budget=size, max_depth=depth)
    return jplan.build_grow_map(tree, choice, size, depth)


def _tree_world(tmp):
    pj, _, job = _job(tmp)
    cases = []
    for name, kw in TREE_CASES.items():
        for temp in (0.3, NEAR_GREEDY_TREE):
            cases.append(dict(kind="tree", tp=2, sp=2, temperature=temp,
                              name=f"tree {name} t{temp}", **kw))
    # dp 4 rows ride the same 4-rank process group
    for mode in ("retrieval", "triforce"):
        cases.append(dict(kind="rows", dp=4, tp=1, sp=1, mode=mode,
                          temperature=0.2, name=f"rows dp4 {mode}"))
    res = launch(dict(job, cases=cases), 4, tmp)
    single = {c["name"]: (run_tree_case if c["kind"] == "tree"
                          else run_rows_case)(None, job, c) for c in cases}
    jax_ref = {name: _jax_tree(pj, job, name) for name in TREE_CASES}
    return res, single, jax_ref


@pytest.fixture(scope="module")
def tree_world(tmp_path_factory):
    return shared(tmp_path_factory, "sharded_tree_world", _tree_world)


def _ranks(res, name):
    outs = [r[name] for r in res]
    assert all(o == outs[0] for o in outs), "the ranks differ"
    return outs[0]


@pytest.mark.parametrize("case", list(TREE_CASES))
def test_tree_engine_tp2_sp2(tree_world, case):
    """``TreeEngine(mesh=, shard_seq=True)`` at tp 2 x sp 2 (JAX
    ``test_tree_sharded_matches_single_device``): every rank takes the
    port's one-process steps (n_nodes, n_emitted, tokens, kv length), and
    near-greedy the JAX single-device TreeEngine's."""
    res, single, jax_ref = tree_world
    name = f"tree {case} t0.3"
    got = _ranks(res, name)
    assert len(got) >= 1 and got == single[name]
    greedy = _ranks(res, f"tree {case} t{NEAR_GREEDY_TREE}")
    assert greedy == single[f"tree {case} t{NEAR_GREEDY_TREE}"]
    assert greedy == jax_ref[case]


@pytest.mark.parametrize("mode", ["retrieval", "triforce"])
def test_rows_over_dp4_equal_unsharded(tree_world, mode):
    """Rows over a dp 4 mesh beside a meshless engine (JAX
    ``test_dp_sharded_rows_equal_unsharded``): each rank holds one row, and
    every rank returns the meshless batched run's tokens, counts and
    counters for all four."""
    res, single, _ = tree_world
    name = f"rows dp4 {mode}"
    got = _ranks(res, name)
    want = single[name]
    assert got["rows"] == 1 and want["rows"] == 4
    for key in ("tokens", "n_emitted", "counters"):
        assert got[key] == want[key], key


def _jax_rows(pj, dj, job, mode):
    eng = JEngine(JC, jcfg.SpecConfig(**SPEC, temperature=NEAR_GREEDY), pj,
                  draft_cfg=jcfg.TINY_DRAFT, draft_params=dj,
                  prefill=PREFILL, max_cache_len=PREFILL + 32,
                  dtype=jnp.float32, prefill_chunk=16, draft_prefill_chunk=8,
                  donate=False)
    bat = jbs.BatchedSpecEngine(eng, mode=mode, donate=False)
    st = bat.prefill_rows([jnp.asarray([p]) for p in job["rows"]],
                          job["seeds"])
    _, toks, ns, c, _ = bat.decode(st, steps=3)
    return dict(tokens=_np(toks).tolist(), n_emitted=_np(ns).tolist(),
                counters=_np(c).tolist())


def _rows_world(tmp):
    pj, dj, job = _job(tmp)
    cases = []
    for mode in ("retrieval", "triforce"):
        for temp in (0.2, NEAR_GREEDY):
            cases.append(dict(kind="rows", dp=2, tp=2, sp=2, mode=mode,
                              temperature=temp,
                              name=f"composed {mode} t{temp}"))
    cases.append(dict(kind="rows", dp=2, tp=2, sp=2, mode="triforce",
                      temperature=0.2, kv_quant=True,
                      name="composed triforce int8"))
    res = launch(dict(job, cases=cases), 8, tmp)
    single = {c["name"]: run_rows_case(None, job, c) for c in cases}
    jax_ref = {mode: _jax_rows(pj, dj, job, mode)
               for mode in ("retrieval", "triforce")}
    return res, single, jax_ref


@pytest.fixture(scope="module")
def rows_world(tmp_path_factory):
    return shared(tmp_path_factory, "sharded_rows_world", _rows_world)


@pytest.mark.parametrize("mode", ["retrieval", "triforce"])
def test_dpxtpxsp_composed_rows_equal_unsharded(rows_world, mode):
    """The composed mesh, dp 2 x tp 2 x sp 2 on 8 ranks (JAX
    ``test_dpxtp_composed_rows_equal_unsharded``): the engine carries the
    mesh, each dp index's (tp, sp) group runs its two rows; tokens, counts
    and counters equal the meshless batched run's and, near-greedy, the
    JAX package's."""
    res, single, jax_ref = rows_world
    name = f"composed {mode} t0.2"
    got = _ranks(res, name)
    assert got["rows"] == 2
    for key in ("tokens", "n_emitted", "counters"):
        assert got[key] == single[name][key], key
    greedy = _ranks(res, f"composed {mode} t{NEAR_GREEDY}")
    for key in ("tokens", "n_emitted", "counters"):
        assert greedy[key] == jax_ref[mode][key], key


def test_dpxtpxsp_composed_int8_cache(rows_world):
    """The composed mesh over int8 caches (the rows' sharded commit
    stores codes and scales) emits the meshless int8 run's tokens."""
    res, single, _ = rows_world
    got = _ranks(res, "composed triforce int8")
    for key in ("tokens", "n_emitted", "counters"):
        assert got[key] == single["composed triforce int8"][key], key


def _jax_serve(pj, job, max_new):
    eng = JEngine(JC, jcfg.SpecConfig(**SPEC, temperature=NEAR_GREEDY), pj,
                  prefill=PREFILL, max_cache_len=PREFILL + 256,
                  dtype=jnp.float32, prefill_chunk=16, donate=True)
    sched = jbs.SpecScheduler(eng, mode="retrieval", slots=2, segment=2)
    for i, p in enumerate(job["requests"]):
        sched.submit(jbatching.Request(rid=i, prompt=np.asarray(p),
                                       max_new_tokens=max_new))
    return sorted([r.rid, list(map(int, r.out))] for r in sched.run())


def _dp2_world(tmp):
    pj, _, job = _job(tmp)
    cases = [dict(kind="serve", dp=2, tp=1, sp=1, mode="retrieval",
                  slots=2, max_new=8, temperature=t, name=f"serve t{t}")
             for t in (0.6, NEAR_GREEDY)]
    cases += [dict(kind="rows", dp=2, tp=1, sp=1, mode=mode,
                   temperature=0.2, name=f"rows dp2 {mode}")
              for mode in ("retrieval", "triforce")]
    res = launch(dict(job, cases=cases), 2, tmp)
    single = {c["name"]: (run_serve_case if c["kind"] == "serve"
                          else run_rows_case)(None, job, c) for c in cases}
    return res, single, _jax_serve(pj, job, 8)


@pytest.fixture(scope="module")
def dp2_world(tmp_path_factory):
    return shared(tmp_path_factory, "sharded_dp2_world", _dp2_world)


@pytest.mark.parametrize("mode", ["retrieval", "triforce"])
def test_rows_over_dp2_equal_unsharded(dp2_world, mode):
    res, single, _ = dp2_world
    name = f"rows dp2 {mode}"
    got = _ranks(res, name)
    assert got["rows"] == 2
    for key in ("tokens", "n_emitted", "counters"):
        assert got[key] == single[name][key], key


def test_spec_scheduler_over_dp2(dp2_world):
    """``SpecScheduler`` with its 2 slots over dp 2 (JAX
    ``test_spec_scheduler_dp_mesh``): 4 requests, each slot on its own
    rank; every rank holds every request's output, equal to the meshless
    scheduler's and, near-greedy, to the JAX scheduler's."""
    res, single, jax_ref = dp2_world
    got = _ranks(res, "serve t0.6")
    assert [rid for rid, _ in got] == [0, 1, 2, 3]
    assert all(1 <= len(out) <= 8 for _, out in got)
    assert got == single["serve t0.6"]
    assert _ranks(res, f"serve t{NEAR_GREEDY}") == jax_ref


# ---------------------------------------------------------------------------
# the command line over the mesh
# ---------------------------------------------------------------------------

CLI = ["--model", "tiny-target", "--prefill", "64", "--gen_len", "12",
       "--gamma", "3", "--budget", "16", "--chunk_size", "4",
       "--dataset", "synthetic", "--device", "cpu"]

# --batch runs --gen_len steps into a cache sized for --gen_len tokens
# (JAX cli.py's headroom): at 4 steps no row can reach the cache's end,
# where the meshless and the sp-padded cache would clamp apart
CLI_RUNS = {
    "batch dp2xtp2xsp2": (["--mode", "retrieval", *CLI, "--batch", "4",
                           "--gen_len", "4"],
                          ["--dp", "2", "--tp", "2", "--sp", "2"], 8),
    "tree tp2xsp2": (["--mode", "tree", *CLI, "--tree_size", "8",
                      "--tree_depth", "4", "--temp", "0.3"],
                     ["--tp", "2", "--sp", "2"], 4),
    "serve dp2": (["--mode", "serve", *CLI, "--batch", "2",
                   "--num_prompts", "3", "--gen_len", "6"],
                  ["--dp", "2"], 2),
}


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_cli_over_the_mesh(name, tmp_path):
    """``cli.main`` under torchrun's environment: 8 ranks with ``--batch 4
    --dp 2 --tp 2 --sp 2`` (JAX ``test_cli_batched_dpxtpxsp``), 4 with
    ``--mode tree --tp 2 --sp 2``, 2 with ``--mode serve --dp 2``. Every
    rank returns the one-process run's tokens (row 0's, the tree's, every
    request's) and only rank 0 prints."""
    from triforce_tpu_torch import cli as tcli
    argv, mesh_flags, n = CLI_RUNS[name]
    want = tcli.main(argv)
    want = sorted([r.rid, r.out] for r in want) if isinstance(want, list) \
        else want.tokens
    res = launch(dict(kind="cli", argv=argv + mesh_flags), n, tmp_path)
    assert all(r["tokens"] == want for r in res)
    assert "[" in res[0]["stdout"] and all(r["stdout"] == ""
                                           for r in res[1:])
