"""Command line of the PyTorch port — the port of ``triforce_tpu/cli.py``,
with the same flags, defaults, result lines and CSV columns:

    python -m triforce_tpu_torch.cli --mode triforce  ...   # 3-level
    python -m triforce_tpu_torch.cli --mode retrieval ...   # self-spec
    python -m triforce_tpu_torch.cli --mode ar        ...   # AR baseline
    python -m triforce_tpu_torch.cli --mode tree      ...   # Sequoia tree
    python -m triforce_tpu_torch.cli --mode serve     ...   # continuous
        batching: --num_prompts requests through --batch speculative slots

It runs on the first CUDA card; ``--device cpu`` runs it on the CPU, and
nothing else does (without a card and without ``--device cpu`` it exits
with an error). Models are preset names (random weights from
``llama.init_params(seed=0)``, which differ from the JAX package's), local
HF checkpoint directories (read by the port's own safetensors reader), or
native checkpoint directories (``models/ckpt.py``).

``--dp`` / ``--tp`` / ``--sp`` run one process per rank, dp x tp x sp of
them, launched as the reference launches its tensor parallelism::

    torchrun --nproc-per-node=4 -m triforce_tpu_torch.cli --tp 2 --sp 2 ...
    torchrun --nproc-per-node=8 -m triforce_tpu_torch.cli --batch 4 \
        --dp 2 --tp 2 --sp 2 ...

Each rank joins the process group from ``torchrun``'s environment (NCCL on
the cards, rank r on ``cuda:<LOCAL_RANK>``; gloo with ``--device cpu``)
and loads its own shards of the target (``parallel/sharding.py``). Every
mode runs over the mesh: the batch-1 and tree engines over (tp, sp)
(``Engine`` / ``TreeEngine(mesh=, shard_seq=--sp > 1)``); ``--batch`` rows
and the ``serve`` slots split over ``dp`` as well, which counts only there
(JAX ``cli.py:260-264``): with ``--tp`` / ``--sp`` the composed mesh, with
``--dp`` alone a dp mesh beside a meshless engine. Rank 0 prints, totals
over every row.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import time

import numpy as np
import torch

from . import data as data_mod
from . import decoding
from .config import PRESETS, SpecConfig, resolve_device
from .engine import Engine
from .models import ckpt as ckpt_mod
from .models import hf, llama
from .parallel import mesh as mesh_mod
from .parallel import sharding
from .utils.misc import log_csv, print_config

_CSV_HEADER = ("mode,model,prefill,gen_len,gamma,budget,chunk_size,temp,"
               "top_p,dataset,seed,tokens_per_sec,acceptance_rate,"
               "avg_tokens_per_step\n")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="triforce_tpu_torch",
        description="TriForce hierarchical speculative decoding on a "
                    "CUDA card (PyTorch port)")
    p.add_argument("--mode", default="triforce",
                   choices=["triforce", "retrieval", "ar", "tree", "serve"])
    p.add_argument("--serve_spec", "--serve-spec", default="retrieval",
                   choices=["retrieval", "triforce"], dest="serve_spec",
                   help="speculation hierarchy the serve slots run "
                        "(triforce adds the drafter level)")
    p.add_argument("--segment", type=int, default=4,
                   help="spec steps per scheduler poll (mode=serve): "
                        "admission/retire happen between segments")
    p.add_argument("--model", default="tiny-target",
                   help="config preset, HF checkpoint dir, or zoo name")
    p.add_argument("--draft", default="tiny-draft",
                   help="drafter preset / checkpoint (mode=triforce)")
    p.add_argument("--prefill", type=int, default=4096)
    p.add_argument("--gen_len", "--gen-len", type=int, default=256,
                   dest="gen_len")
    p.add_argument("--gamma", type=int, default=6)
    p.add_argument("--middle_chain", "--middle-chain", type=int, default=1,
                   dest="middle_chain",
                   help="drafter tokens per middle verify (triforce mode): "
                        "1 = one draft per verify; 0 = auto (gamma); k>1 "
                        "verifies a k-token drafter chain with one middle "
                        "forward (lossless either way)")
    p.add_argument("--middle_trips", "--middle-trips", type=int, default=0,
                   dest="middle_trips",
                   help="fixed middle-loop trip count (0 = loop until "
                        "gamma proposals)")
    p.add_argument("--budget", type=int, default=4096)
    p.add_argument("--chunk_size", "--chunk-size", type=int, default=8,
                   dest="chunk_size")
    p.add_argument("--draft_cache_budget", type=int, default=266)
    p.add_argument("--start_size", type=int, default=16)
    p.add_argument("--temp", type=float, default=0.6)
    p.add_argument("--top_p", type=float, default=0.9)
    p.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "128k", "gs", "one-shot", "demo",
                            "lwm"])
    p.add_argument("--data_dir", "--data-dir", default="data/pg19",
                   dest="data_dir",
                   help="local PG-19-format corpus dir for "
                        "--dataset 128k/gs/one-shot")
    p.add_argument("--num_prompts", "--num-prompts", type=int, default=1,
                   dest="num_prompts",
                   help="evaluate N prompts and report the average; "
                        "prompts cycle if the dataset has fewer")
    p.add_argument("--eos", default="2",
                   help="comma-separated EOS token ids")
    p.add_argument("--stop_on_eos", "--stop-on-eos", action="store_true",
                   dest="stop_on_eos",
                   help="stop generation at the first emitted EOS")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--file", default="", help="CSV log path (misc.log_csv)")
    p.add_argument("--dtype", default=None,
                   help="bfloat16|float32 (default: bfloat16 on a card, "
                        "float32 on the CPU)")
    p.add_argument("--kv_dtype", "--kv-dtype", default="bf16",
                   choices=["bf16", "int8"], dest="kv_dtype",
                   help="KV-cache storage precision")
    p.add_argument("--weight_dtype", "--weight-dtype", default="bf16",
                   choices=["bf16", "int8"], dest="weight_dtype",
                   help="weight precision (int8 = per-channel weight-only "
                        "quantization)")
    p.add_argument("--batch", type=int, default=1,
                   help="batched speculation: N prompts decode together "
                        "(retrieval/triforce modes); slots in mode=serve")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel size: splits the --batch rows or "
                        "the serve slots (one torchrun process per rank)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel size (one torchrun process per "
                        "rank)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel size: shards the KV cache's "
                        "slots (one torchrun process per rank)")
    p.add_argument("--tree_size", type=int, default=64,
                   help="speculation-tree nodes (mode=tree)")
    p.add_argument("--tree_depth", type=int, default=8)
    p.add_argument("--tree_accept", type=float, default=0.8,
                   help="modeled acceptance rate for the tree planner")
    p.add_argument("--ssl", type=int, default=0,
                   help="self-speculation layers: during tree grow, layers "
                        "< ssl attend the FULL cache")
    p.add_argument("--grow_map", default="",
                   help="planned grow-map JSON (tree/planner.py); overrides "
                        "--tree_size/--tree_depth/--tree_accept")
    p.add_argument("--save_ckpt", "--save-ckpt", default="",
                   dest="save_ckpt",
                   help="after loading --model, save it as a native "
                        "checkpoint (models/ckpt.py) at this dir; later "
                        "runs pass the dir as --model")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default: the first card) or cpu")
    return p.parse_args(argv)


_TOKENIZER_FILES = ("tokenizer.json", "tokenizer.model",
                    "tokenizer_config.json")


def _tokenizer(path: str):
    """The checkpoint's HF tokenizer where ``transformers`` and the
    tokenizer files are present, else None (never downloads)."""
    if not any(os.path.isfile(os.path.join(path, f))
               for f in _TOKENIZER_FILES):
        return None
    try:
        from transformers import AutoTokenizer
        return AutoTokenizer.from_pretrained(path, local_files_only=True)
    except Exception:   # no transformers, or files it cannot read
        return None


def load_model(spec: str, dtype, drafter: bool = False, device=None,
               mesh=None):
    """A preset name -> random params (seed 0); a native checkpoint or an
    HF checkpoint directory (or zoo name) -> its params. Returns (cfg,
    params, tokenizer or None). ``mesh``: only this rank's shards are
    made or loaded (``parallel.sharding.param_shardings``)."""
    dev = resolve_device(device)

    def shardings(cfg):
        if mesh is None:
            return None
        if cfg.num_kv_heads % mesh.shape["tp"]:
            raise SystemExit(f"--tp {mesh.shape['tp']} does not divide "
                             f"num_kv_heads {cfg.num_kv_heads}; put the "
                             f"surplus on --sp instead")
        return sharding.param_shardings(mesh, cfg, weight_quant=True)

    if spec in PRESETS:
        cfg = PRESETS[spec]
        return cfg, llama.init_params(cfg, device=dev, dtype=dtype, seed=0,
                                      shardings=shardings(cfg)), None
    path = hf.resolve_checkpoint(spec)
    if ckpt_mod.is_native_checkpoint(path):
        cfg, params = ckpt_mod.load_checkpoint(
            path, dtype=dtype, device=dev,
            shardings=shardings(ckpt_mod.read_config(path)))
        # drafter semantics (StreamingLLM un-rotated key storage) are a
        # load-time choice, as on the HF path: --draft sets rope_on_slots
        if cfg.rope_on_slots != drafter:
            cfg = cfg.with_(rope_on_slots=drafter)
        return cfg, params, _tokenizer(path)
    try:
        # safetensors checkpoints stream tensor by tensor; torch .bin
        # checkpoints fall back to the whole read
        cfg, params = hf.load_params_streaming(
            path, dtype=dtype, rope_on_slots=drafter, device=dev,
            shardings=shardings(hf.read_config(path, drafter)))
    except FileNotFoundError as e:
        if "no safetensors shards" not in str(e):
            raise
        # the whole read; the engine cuts the full params to the shards
        cfg, params = hf.load_params(path, dtype=dtype,
                                     rope_on_slots=drafter, device=dev)
    return cfg, params, _tokenizer(path)


def _dp(args) -> int:
    """The dp size that counts: rows split over dp with ``--batch`` above
    1 or in ``serve`` alone (JAX ``cli.py:260-264``)."""
    return args.dp if args.batch > 1 or args.mode == "serve" else 1


def _mesh(args):
    """The (dp, tp, sp) mesh of a multi-rank run (None for one process):
    this process joins the process group from ``torchrun``'s
    environment."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    dp = _dp(args)
    n = dp * args.tp * args.sp
    if n == 1 and world == 1:
        return None
    if args.save_ckpt:
        raise SystemExit("--save_ckpt writes the whole model: run it "
                         "without --dp / --tp / --sp")
    if world != n:
        raise SystemExit(f"--dp {dp} --tp {args.tp} --sp {args.sp} runs "
                         f"{n} ranks, one process each: launch it as "
                         f"torchrun --nproc-per-node={n} -m "
                         f"triforce_tpu_torch.cli ... (this process group "
                         f"has {world})")
    dev = mesh_mod.init_distributed(
        device="cpu" if args.device == "cpu" else None)
    return mesh_mod.make_mesh(tp=args.tp, sp=args.sp, dp=dp, device=dev)


def main(argv=None):
    args = parse_args(argv)
    mesh = _mesh(args)
    try:
        with contextlib.ExitStack() as stack:
            if mesh is not None and torch.distributed.get_rank() != 0:
                # every rank computes the same tokens: rank 0 prints them
                devnull = stack.enter_context(open(os.devnull, "w"))
                stack.enter_context(contextlib.redirect_stdout(devnull))
            return _main(args, mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def _main(args, mesh):
    # the default raises without a card: nothing falls back to the CPU
    dev = mesh.device if mesh is not None else \
        resolve_device(None if args.device == "cuda" else args.device)
    # the engines run over (tp, sp); rows over dp alone take the mesh
    # beside a meshless engine (JAX cli.py:413-420, :460-467)
    eng_mesh = mesh if mesh is not None and args.tp * args.sp > 1 else None
    dp_mesh = mesh if mesh is not None and eng_mesh is None else None
    if args.dtype is None:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    else:
        dtype = hf.torch_dtype(args.dtype)

    recent = max(args.draft_cache_budget - args.start_size - args.gamma, 16)
    spec = SpecConfig(gamma=args.gamma, budget=args.budget,
                      chunk_size=args.chunk_size,
                      draft_start_size=args.start_size,
                      draft_recent_size=recent,
                      temperature=args.temp, top_p=args.top_p,
                      max_len=args.gen_len,
                      middle_chain=args.middle_chain,
                      middle_trips=args.middle_trips)

    if args.mode in ("triforce", "retrieval", "serve") and \
            args.gen_len > args.budget:
        print(f"[warn] gen_len {args.gen_len} exceeds budget "
              f"{args.budget}: the retrieval tail is a rolling window of "
              f"the most recent `budget` generated tokens, so older "
              f"generated tokens (and eventually the selected chunks) "
              f"rotate out of the middle model's view (losslessness "
              f"unaffected — the full-cache verify sees everything)")

    # the target's shards alone over a mesh (the drafter is whole)
    t_cfg, t_params, tokenizer = load_model(
        args.model, dtype, device=dev, **({} if eng_mesh is None
                                          else {"mesh": eng_mesh}))
    if args.save_ckpt:
        ckpt_mod.save_checkpoint(args.save_ckpt, t_cfg, t_params)
        print(f"[ckpt] saved native checkpoint to {args.save_ckpt}")
    weight_quant = args.weight_dtype == "int8"

    print_config(mode=args.mode, model=args.model, prefill=args.prefill,
                 gen_len=args.gen_len, gamma=args.gamma, budget=args.budget,
                 chunk_size=args.chunk_size, temp=args.temp,
                 top_p=args.top_p, dataset=args.dataset, seed=args.seed,
                 backend=dev.type, tp=args.tp, sp=args.sp)

    prompts = data_mod.get_dataset(args.dataset, tokenizer,
                                   datalen=args.prefill,
                                   vocab_size=t_cfg.vocab_size,
                                   seed=args.seed, data_dir=args.data_dir)
    if args.dataset == "synthetic" and args.num_prompts > 1:
        prompts = data_mod.synthetic_prompts(
            args.num_prompts, args.prefill, t_cfg.vocab_size, args.seed)
    eos_ids = tuple(int(e) for e in args.eos.split(","))
    prompt_ids = [torch.from_numpy(data_mod.fit_prompt(
        prompts[i % len(prompts)], args.prefill)).to(dev)
        for i in range(args.num_prompts)]

    if args.mode == "tree":
        from .tree import planner
        from .tree.spectree import TreeEngine, tree_decode
        if args.grow_map:
            gm = planner.GrowMap.load(args.grow_map)
        else:
            pvec = planner.modeled_acceptance_vector(args.tree_accept, 4)
            T, choice = planner.plan_tree(pvec, args.tree_size,
                                          args.tree_depth)
            gm = planner.build_grow_map(T, choice, args.tree_size,
                                        args.tree_depth)
        engine = TreeEngine(
            t_cfg, gm, t_params, prefill=args.prefill,
            max_cache_len=args.prefill + args.gen_len + 2 * gm.size,
            budget=args.budget, chunk_size=args.chunk_size,
            temperature=args.temp, top_p=args.top_p, dtype=dtype,
            kv_quant=args.kv_dtype == "int8",
            weight_quant=weight_quant, ssl=args.ssl,
            eos_ids=eos_ids, device=dev, mesh=eng_mesh,
            shard_seq=args.sp > 1)
        runs = [tree_decode(engine, pids, max_len=args.gen_len,
                            seed=args.seed + i, device=dev)
                for i, pids in enumerate(prompt_ids)]
        res = runs[0]
    else:
        d_cfg = d_params = None
        with_draft = args.mode == "triforce" or (
            args.mode == "serve" and args.serve_spec == "triforce")
        if with_draft:
            d_cfg, d_params, _ = load_model(args.draft, dtype, drafter=True,
                                            device=dev)
        if args.mode == "serve":
            from .batched_spec import SpecScheduler
            headroom = SpecScheduler.required_headroom(
                args.gen_len, args.segment, spec.gamma)
        else:
            headroom = 2 * (args.gen_len + spec.gamma + 2)
        engine = Engine(
            t_cfg, spec, t_params, draft_cfg=d_cfg, draft_params=d_params,
            prefill=args.prefill, max_cache_len=args.prefill + headroom,
            dtype=dtype, kv_quant=args.kv_dtype == "int8",
            weight_quant=weight_quant, eos_token_id=eos_ids, device=dev,
            mesh=eng_mesh, shard_seq=args.sp > 1)
        if args.mode == "serve":
            return _run_serve(engine, args, prompt_ids, dp_mesh)
        if args.batch > 1 and args.mode in ("retrieval", "triforce"):
            runs = [_run_batched(engine, args, prompts, dp_mesh)]
            res = runs[0]
        else:
            fn = {"triforce": decoding.triforce,
                  "retrieval": decoding.retrieval_spec,
                  "ar": decoding.autoregressive}[args.mode]
            kw = {} if args.mode == "ar" else \
                {"stop_on_eos": args.stop_on_eos}
            runs = [fn(engine, pids, max_len=args.gen_len,
                       seed=args.seed + i, verbose=args.verbose,
                       tokenizer=tokenizer, device=dev, **kw)
                    for i, pids in enumerate(prompt_ids)]
            res = runs[0]

    for i, r in enumerate(runs):
        print(f"\n[{args.mode}] prompt {i}: {r.tokens_per_sec:.2f} tokens/s "
              f"({1e3 / max(r.tokens_per_sec, 1e-9):.1f} ms/token), "
              f"acceptance {r.acceptance_rate:.3f}, "
              f"{r.avg_tokens_per_step:.2f} tokens/step, "
              f"{r.steps} steps, wall {r.wall_s:.1f}s"
              + (f" (+ {r.captures} CUDA graphs captured in "
                 f"{r.capture_s:.2f}s)" if r.captures else "")
              + f"; prefill {r.prefill_s:.2f}s"
              + (f" (+ {r.prefill_captures} CUDA graphs captured in "
                 f"{r.prefill_capture_s:.2f}s)" if r.prefill_captures
                 else ""))
    if len(runs) > 1:
        # latency averaged per token, acceptance pooled over proposals
        tps = [r.tokens_per_sec for r in runs]
        accs = [r.acceptance_rate for r in runs
                if not math.isnan(r.acceptance_rate)]
        res = dataclasses_replace_mean(res, runs)
        print(f"\n[{args.mode}] AVERAGE over {len(runs)} prompts: "
              f"{res.tokens_per_sec:.2f} tokens/s "
              f"(per-prompt sigma {float(np.std(tps)):.2f}), acceptance "
              f"{res.acceptance_rate:.3f}"
              + (f" (sigma {float(np.std(accs)):.3f})" if accs else ""))

    if args.file:
        entry = (f"{args.mode},{args.model},{args.prefill},{args.gen_len},"
                 f"{args.gamma},{args.budget},{args.chunk_size},{args.temp},"
                 f"{args.top_p},{args.dataset},{args.seed},"
                 f"{res.tokens_per_sec:.3f},{res.acceptance_rate:.4f},"
                 f"{res.avg_tokens_per_step:.3f}\n")
        log_csv(args.file, _CSV_HEADER, entry)
    return res


def dataclasses_replace_mean(res, runs):
    """Aggregate per-prompt DecodeResults into one average row: throughput
    token-weighted (sum tokens / sum wall), acceptance averaged over the
    prompts that measured one."""
    n = len(runs)
    accs = [r.acceptance_rate for r in runs
            if not math.isnan(r.acceptance_rate)]
    tot_tokens = sum(r.tokens_per_sec * r.wall_s for r in runs)
    tot_wall = sum(r.wall_s for r in runs)
    return dataclasses.replace(
        res,
        tokens_per_sec=tot_tokens / max(tot_wall, 1e-9),
        acceptance_rate=sum(accs) / len(accs) if accs else float("nan"),
        avg_tokens_per_step=sum(r.avg_tokens_per_step for r in runs) / n,
        steps=sum(r.steps for r in runs),
        wall_s=tot_wall)


def _run_batched(engine, args, prompts, dp_mesh=None):
    """--batch N: N rows speculate together (``BatchedSpecEngine``; over
    dp, each rank its block of them, the result every row's). tokens/s
    over all rows; acceptance pooled."""
    from .batched_spec import BatchedSpecEngine
    from .decoding import DecodeResult, _CaptureClock

    b = args.batch
    bat = BatchedSpecEngine(engine, mode=args.mode, mesh=dp_mesh)
    rows = [torch.from_numpy(data_mod.fit_prompt(prompts[i % len(prompts)],
                                                 args.prefill))
            .to(engine.device) for i in range(b)]
    state = bat.prefill_rows(rows, [args.seed + i for i in range(b)])
    _ = int(state.next_token[0])     # read-back: the prefill is done
    if bat.mesh is not None:         # every rank's rows are
        torch.distributed.barrier()
    # a fixed step count: ~gen_len tokens a row at >= 1 token a step
    steps = args.gen_len
    clock = _CaptureClock(engine.graphs)
    r0 = engine.graphs.readbacks
    t0 = time.perf_counter()
    state, toks, ns, counters, _eos = bat.decode(state, steps)
    wall = time.perf_counter() - t0 - clock.seconds
    total = int(ns.sum())
    # row 0's emitted stream: per step, the first n_emitted slots
    row0 = [int(t) for s in range(steps) for t in toks[0, s, :ns[0, s]]]
    return DecodeResult(
        tokens=row0,
        tokens_per_sec=total / wall,
        acceptance_rate=float(counters[:, 0].sum()) /
        max(int(counters[:, 1].sum()), 1),
        avg_tokens_per_step=total / (b * steps),
        steps=steps, wall_s=wall, captures=clock.count,
        capture_s=clock.seconds, readbacks=engine.graphs.readbacks - r0)


def _run_serve(engine, args, prompt_ids, dp_mesh=None):
    """--mode serve: ``--num_prompts`` requests flow through ``--batch``
    slots (``SpecScheduler``: admit -> ``--segment`` batched spec steps ->
    retire on EOS/length; over dp, the slots split over it). Returns the
    finished requests."""
    from .batched_spec import SpecScheduler
    from .batching import Request

    sched = SpecScheduler(engine, mode=args.serve_spec, slots=args.batch,
                          segment=args.segment, seed=args.seed,
                          mesh=dp_mesh)
    t0 = time.perf_counter()
    for i, pids in enumerate(prompt_ids):
        sched.submit(Request(rid=args.seed + i,
                             prompt=pids.reshape(-1).cpu().numpy(),
                             max_new_tokens=args.gen_len))
    done = sched.run()
    wall = time.perf_counter() - t0
    total = sum(len(r.out) for r in done)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"[serve] request {r.rid}: {len(r.out)} tokens"
              + (" (eos)" if len(r.out) < args.gen_len else ""))
    print(f"\n[serve] {len(done)}/{len(prompt_ids)} requests done, "
          f"{total} tokens in {wall:.1f}s = {total / wall:.2f} tokens/s "
          f"aggregate ({args.batch} slots, {args.serve_spec} spec, "
          f"segment {args.segment})")
    if args.file:
        # per-request acceptance is not defined for the aggregate
        entry = (f"serve,{args.model},{args.prefill},{args.gen_len},"
                 f"{args.gamma},{args.budget},{args.chunk_size},"
                 f"{args.temp},{args.top_p},{args.dataset},{args.seed},"
                 f"{total / wall:.3f},nan,nan\n")
        log_csv(args.file, _CSV_HEADER, entry)
    return done


if __name__ == "__main__":
    main()
