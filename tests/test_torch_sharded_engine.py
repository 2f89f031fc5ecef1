"""The batch-1 ``Engine`` over a mesh of gloo processes (``Engine(mesh=,
shard_seq=)``, ``parallel/``): heads over tp, the full cache's slots over
sp, as ``tests/test_sharding.py`` runs the JAX engine on its 8-device mesh.

Every rank must emit the same tokens; those tokens must equal the port's
single-process run (fp32, temperature 0.2: splitting the work moves the
logits by float rounding alone) and, at temperature 1e-4, the JAX engine's
(the near-greedy rule of ``test_torch_engine.py``). The ranks are
processes of ``torch_mesh_worker.py`` (4 for the tp x sp cases, 2 for the
two-process decode launched torchrun's way); the JAX references are made
here. In-process, a one-rank mesh must match the meshless engine bit for
bit, and so must the batched rows, the scheduler and the tree engine over
it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_mesh_worker import launch, run_engine_case, save_params, shared
from triforce_tpu import config as jcfg
from triforce_tpu.engine import Engine as JEngine
from triforce_tpu.models import llama as jl
from triforce_tpu_torch import batched_spec as tbs
from triforce_tpu_torch import batching as tbatching
from triforce_tpu_torch import config as tcfg
from triforce_tpu_torch import profiling as tprof
from triforce_tpu_torch.engine import Engine as TEngine
from triforce_tpu_torch.models import llama as tl
from triforce_tpu_torch.parallel import mesh as tmesh
from triforce_tpu_torch.tree import planner
from triforce_tpu_torch.tree.spectree import TreeEngine

torch.set_num_threads(1)

# the JAX sharding tests' tiny config: 8 KV heads, so tp up to 8 divides
TP8 = dict(vocab_size=199, hidden_size=64, intermediate_size=128,
           num_layers=2, num_heads=8, num_kv_heads=8, head_dim=8,
           max_position_embeddings=4096, rms_norm_eps=1e-5)
J_TP8 = jcfg.ModelConfig(rope=jcfg.RopeConfig(kind="llama"), **TP8)
T_TP8 = tcfg.ModelConfig(rope=tcfg.RopeConfig(kind="llama"), **TP8)
SPEC = dict(gamma=3, budget=16, chunk_size=4, draft_start_size=4,
            draft_recent_size=12, top_p=0.9)
PREFILL = 32
NEAR_GREEDY = 1e-4

STEP_CASES = [(1, 4, False), (2, 2, False), (2, 2, True), (4, 1, False)]
MODES = ["ar", "forced", "triforce", "retrieval"]


def _step_name(tp, sp, quant, temp):
    return f"steps {tp}x{sp}{' int8' if quant else ''} t{temp}"


def _cases():
    out = []
    for tp, sp, quant in STEP_CASES:
        for temp in (0.2, NEAR_GREEDY):
            out.append(dict(kind="engine", tp=tp, sp=sp, kv_quant=quant,
                            temperature=temp,
                            name=_step_name(tp, sp, quant, temp)))
    for quant in (False, True):
        for mode in MODES:
            out.append(dict(kind="engine", tp=2, sp=2, kv_quant=quant,
                            temperature=0.2, mode=mode, n=8,
                            name=f"{mode} 2x2{' int8' if quant else ''}"))
    out.append(dict(kind="engine", name="retrieval 2x2 t0.6", tp=2, sp=2,
                    temperature=0.6, mode="retrieval", n=8))
    return out


def _job(tmp):
    pj = jl.init_params(jax.random.PRNGKey(0), J_TP8, dtype=jnp.float32)
    dj = jl.init_params(jax.random.PRNGKey(1), jcfg.TINY_DRAFT,
                        dtype=jnp.float32)
    path = str(tmp / "params.npz")
    save_params(path, t=jax.tree.map(np.asarray, pj),
                d=jax.tree.map(np.asarray, dj))
    ids = np.random.default_rng(2).integers(0, 199, (1, PREFILL))
    return pj, dj, dict(kind="cases", params=path, ids=ids.tolist(),
                        target_cfg=dataclasses.asdict(T_TP8), spec=SPEC,
                        prefill=PREFILL)


def _jax_steps(pj, dj, ids, quant):
    """The JAX engine's tokens over 3 TriForce steps, near-greedy."""
    eng = JEngine(J_TP8, jcfg.SpecConfig(**SPEC, temperature=NEAR_GREEDY),
                  pj, draft_cfg=jcfg.TINY_DRAFT, draft_params=dj,
                  prefill=PREFILL, max_cache_len=PREFILL + 32,
                  dtype=jnp.float32, prefill_chunk=16, draft_prefill_chunk=8,
                  donate=False, kv_quant=quant)
    st = eng.init_state(jax.random.PRNGKey(7))
    st = eng.prefill_draft(eng.prefill_target(st, jnp.asarray(ids)),
                           jnp.asarray(ids))
    toks = []
    for _ in range(3):
        st, stats = eng.triforce_step(st)
        toks += np.asarray(stats.tokens)[:int(stats.n_emitted)].tolist()
    return toks


def _world(tmp):
    pj, dj, job = _job(tmp)
    cases = _cases()
    res = launch(dict(job, cases=cases), 4, tmp)
    single = {c["name"]: run_engine_case(None, job, c) for c in cases}
    ids = np.asarray(job["ids"])
    jax_ref = {str(q): _jax_steps(pj, dj, ids, q) for q in (False, True)}
    return res, single, jax_ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return shared(tmp_path_factory, "sharded_engine", _world)


def _same_on_every_rank(res, name):
    toks = [r[name] for r in res]
    assert all(t == toks[0] for t in toks), toks
    return toks[0]


@pytest.mark.parametrize("tp,sp,quant", STEP_CASES,
                         ids=[f"{t}x{s}{'-int8' if q else ''}"
                              for t, s, q in STEP_CASES])
def test_sharded_triforce_steps(world, tp, sp, quant):
    res, single, jax_ref = world
    name = _step_name(tp, sp, quant, 0.2)
    got = _same_on_every_rank(res, name)
    assert len(got) >= 3
    assert got == single[name]
    greedy = _same_on_every_rank(res, _step_name(tp, sp, quant, NEAR_GREEDY))
    assert greedy == single[_step_name(tp, sp, quant, NEAR_GREEDY)]
    assert greedy == jax_ref[str(quant)]


@pytest.mark.parametrize("quant", [False, True], ids=["bf", "int8"])
@pytest.mark.parametrize("mode", MODES)
def test_sharded_modes_match_single_process(world, mode, quant):
    """ar, forced, triforce and retrieval generations under tp=2 x sp=2."""
    res, single, _ = world
    name = f"{mode} 2x2{' int8' if quant else ''}"
    got = _same_on_every_rank(res, name)
    assert len(got) >= 8
    assert got == single[name]


def test_sharded_generate_retrieval_runs(world):
    """The whole-generation loop under tp=2 x sp=2 (JAX
    ``test_sharded_generate_retrieval_runs``), held to the single process."""
    res, single, _ = world
    got = _same_on_every_rank(res, "retrieval 2x2 t0.6")
    assert len(got) >= 8 and all(0 <= t < 199 for t in got)
    assert got == single["retrieval 2x2 t0.6"]


def test_collectives_follow_the_mesh(world):
    """tp reduces the row-parallel products and gathers the logits; sp
    merges the attention partials; a forward issues no sp collective when
    the cache is not split (4x1)."""
    res, _, _ = world
    c22 = res[0][_step_name(2, 2, False, 0.2) + " collectives"]
    c41 = res[0][_step_name(4, 1, False, 0.2) + " collectives"]
    assert c22["tp"] > 0 and c22["sp"] > 0
    assert c41["tp"] > 0 and "sp" not in c41


def _two_process(tmp):
    _, _, job = _job(tmp)
    cases = [dict(kind="engine", name=f"{tp}x{sp}", tp=tp, sp=sp,
                  temperature=0.2) for tp, sp in ((2, 1), (1, 2))]
    res = launch(dict(job, cases=cases), 2, tmp)
    return res, {c["name"]: run_engine_case(None, job, c) for c in cases}


@pytest.fixture(scope="module")
def two_process(tmp_path_factory):
    return shared(tmp_path_factory, "two_process", _two_process)


@pytest.mark.parametrize("name", ["2x1", "1x2"])
def test_two_process_decode(two_process, name):
    """Two processes joined from torchrun's environment (the reference's
    ``torchrun --nproc_per_node=2`` shape, ``tests/test_multihost.py``)
    decode the single-process tokens."""
    res, single = two_process
    assert _same_on_every_rank(res, name) == single[name]


# ---------------------------------------------------------------------------
# in-process: a one-rank mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank():
    return tmesh.single_device_mesh(device="cpu")


def _tiny(mesh=None, **kw):
    pt = tl.init_params(tcfg.TINY_TARGET, device="cpu", dtype=torch.float32,
                        seed=0)
    pd = tl.init_params(tcfg.TINY_DRAFT, device="cpu", dtype=torch.float32,
                        seed=1)
    return TEngine(tcfg.TINY_TARGET,
                   tcfg.SpecConfig(**SPEC, temperature=0.6), pt,
                   draft_cfg=tcfg.TINY_DRAFT, draft_params=pd,
                   prefill=PREFILL, max_cache_len=PREFILL + 32,
                   dtype=torch.float32, prefill_chunk=16,
                   draft_prefill_chunk=8, device="cpu", mesh=mesh, **kw)


@pytest.mark.parametrize("quant", [False, True], ids=["bf", "int8"])
def test_one_rank_mesh_is_bit_equal_to_meshless(one_rank, quant):
    """Over a one-rank mesh every collective is issued and adds nothing:
    tokens, counters and caches equal the meshless engine's bit for bit."""
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 199,
                                                             (1, PREFILL)))
    outs = []
    for mesh in (None, one_rank):
        eng = _tiny(mesh, shard_seq=mesh is not None, kv_quant=quant)
        st = eng.init_state(5)
        st = eng.prefill_draft(eng.prefill_target(st, ids), ids)
        st, buf, n, cnt = eng.generate(st, 12, mode="triforce")
        outs.append((buf[:n].tolist(), cnt.tolist(), st.kv.k.clone(),
                     st.rkv.k.clone(), int(st.kv.seq_len)))
    (t0, c0, k0, r0, n0), (t1, c1, k1, r1, n1) = outs
    assert (t0, c0, n0) == (t1, c1, n1)
    assert torch.equal(k0, k1) and torch.equal(r0, r1)
    assert one_rank.collectives["tp"] > 0 and one_rank.collectives["sp"] > 0


def test_measure_phase_times_over_a_mesh(one_rank):
    """``measure_phase_times`` times a meshed engine's forwards and leaves
    its state as it was (the slots of its own shard restored)."""
    eng = _tiny(one_rank, shard_seq=True)
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 199,
                                                             (1, PREFILL)))
    st = eng.prefill_draft(eng.prefill_target(eng.init_state(6), ids), ids)
    before = (st.kv.k.clone(), st.rkv.k.clone(), int(st.kv.seq_len))
    out = tprof.measure_phase_times(eng, st, iters=2)
    assert set(out) == {"target_verify", "middle_step", "ar_step",
                        "retrieval_build", "draft_step"}
    assert all(v > 0 for v in out.values())
    assert torch.equal(st.kv.k, before[0]) and torch.equal(st.rkv.k,
                                                           before[1])
    assert int(st.kv.seq_len) == before[2]


def test_engine_takes_only_a_mesh():
    with pytest.raises(TypeError, match="Mesh"):
        _tiny(object())


def test_a11b_paths_refuse_a_mesh(one_rank):
    """What once refused a mesh now runs over one: on a one-rank
    mesh (every collective issued, adding nothing) batched rows of the
    composed engine, ``SpecScheduler`` over it and ``TreeEngine(mesh=,
    shard_seq=True)`` each equal their meshless runs bit for bit (tokens,
    counts, served outputs); a second mesh beside a meshed engine is
    refused."""
    ids = [torch.from_numpy(np.random.default_rng(10 + i).integers(
        0, 199, (1, PREFILL))) for i in range(2)]
    pvec = planner.modeled_acceptance_vector(0.8, 4)
    tree, choice = planner.plan_tree(pvec, 8, 4)
    gm = planner.build_grow_map(tree, choice, 8, 4)
    outs = []
    for mesh in (None, one_rank):
        eng = _tiny(mesh, shard_seq=mesh is not None)
        bat = tbs.BatchedSpecEngine(eng, mode="triforce")
        st = bat.prefill_rows(ids, [11, 22])
        _, toks, ns, cnt, _ = bat.decode(st, 2)
        sched = tbs.SpecScheduler(eng, slots=2, segment=2)
        for i in range(2):
            sched.submit(tbatching.Request(rid=i, prompt=ids[i][0].numpy(),
                                           max_new_tokens=4))
        served = sorted((r.rid, r.out) for r in sched.run())
        te = TreeEngine(tcfg.TINY_TARGET, gm, eng.t_params, prefill=PREFILL,
                        max_cache_len=PREFILL + 32, budget=16, chunk_size=4,
                        dtype=torch.float32, prefill_chunk=16, device="cpu",
                        mesh=mesh, shard_seq=mesh is not None, ssl=1)
        tst = te.prefill_target(te.init_state(3), ids[0])
        _, buf, n, c, _ = te.generate(tst, 8)
        outs.append((toks.tolist(), ns.tolist(), cnt.tolist(), served,
                     buf[:n].tolist(), c.tolist()))
    assert outs[0] == outs[1]
    with pytest.raises(ValueError, match="second mesh"):
        tbs.BatchedSpecEngine(eng, mesh=one_rank)
