"""The port's command line (``triforce_tpu_torch/cli.py``) on the CPU
(``--device cpu``): every mode on the tiny presets, and, on one local HF
checkpoint pair, the JAX package's ``cli.main`` and the port's giving the
same tokens near-greedy (``--temp 1e-4``: every distribution one-hot, so
the two packages' different random streams draw alike).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from triforce_tpu import cli as jcli
from triforce_tpu_torch import cli as tcli

transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)

COMMON = ["--model", "tiny-target", "--prefill", "64", "--gen_len", "12",
          "--gamma", "3", "--budget", "16", "--chunk_size", "4",
          "--dataset", "synthetic", "--device", "cpu"]
DRAFT = ["--draft", "tiny-draft", "--draft_cache_budget", "36",
         "--start_size", "4"]
FIXTURE_DIR = __file__.rsplit("/", 1)[0] + "/fixtures"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_retrieval_writes_csv(tmp_path):
    csv = str(tmp_path / "log.csv")
    res = tcli.main(["--mode", "retrieval", *COMMON, "--file", csv])
    assert res.tokens_per_sec > 0 and len(res.tokens) >= 13
    assert open(csv).read().count("\n") == 2     # header + entry


def test_cli_ar():
    res = tcli.main(["--mode", "ar", *COMMON])
    assert res.steps == 12 and len(res.tokens) == 13


def test_cli_triforce():
    res = tcli.main(["--mode", "triforce", *COMMON, *DRAFT])
    assert len(res.tokens) >= 13 and 0 <= res.acceptance_rate <= 1


def test_cli_middle_chain_auto():
    res = tcli.main(["--mode", "triforce", *COMMON, *DRAFT,
                     "--middle_chain", "0"])
    assert res.tokens_per_sec > 0 and len(res.tokens) >= 13


def test_cli_tree():
    res = tcli.main(["--mode", "tree", *COMMON, "--tree_size", "8",
                     "--tree_depth", "4"])
    assert len(res.tokens) >= 2 and res.steps >= 1


def test_cli_serve():
    """5 requests through 2 speculative slots, each to its length."""
    done = tcli.main(["--mode", "serve", *COMMON, "--num_prompts", "5",
                      "--batch", "2", "--segment", "2", "--eos", "-1",
                      "--start_size", "4", "--draft_cache_budget", "19"])
    assert len(done) == 5
    assert all(r.done and len(r.out) == 12 for r in done)


def test_cli_batched_rows():
    res = tcli.main(["--mode", "retrieval", *COMMON, "--batch", "2"])
    assert res.tokens_per_sec > 0 and 0.0 <= res.acceptance_rate <= 1.0


@pytest.mark.parametrize("mode", ["ar", "triforce", "tree"])
def test_cli_int8(mode):
    extra = DRAFT if mode == "triforce" else (
        ["--tree_size", "8", "--tree_depth", "4"] if mode == "tree" else [])
    res = tcli.main(["--mode", mode, *COMMON, *extra, "--kv_dtype", "int8",
                     "--weight_dtype", "int8"])
    assert len(res.tokens) >= 2


def test_cli_multiple_prompts_average():
    res = tcli.main(["--mode", "ar", *COMMON, "--num_prompts", "2"])
    assert res.steps == 24 and res.tokens_per_sec > 0


def test_cli_pg19_fixture_with_stub_tokenizer(monkeypatch):
    class _Tok:
        def encode(self, text):
            return [ord(c) % 100 for c in text]

        def decode(self, ids, **kw):
            return "".join(chr(97 + (i % 26)) for i in ids)

    real = tcli.load_model

    def fake_load(spec, dtype, drafter=False, device=None):
        cfg, params, _ = real(spec, dtype, drafter=drafter, device=device)
        return cfg, params, _Tok()
    monkeypatch.setattr(tcli, "load_model", fake_load)
    res = tcli.main(["--mode", "retrieval", *COMMON[:-4], "--device", "cpu",
                     "--dataset", "one-shot", "--data_dir", FIXTURE_DIR,
                     "--verbose"])
    assert res.tokens_per_sec > 0


def test_cli_multi_gpu_flags_exit_nonzero():
    """Outside a process group of their size, --tp, --sp and --dp (with
    the --batch rows it splits) exit naming the torchrun launch."""
    for flags in (["--tp", "2"], ["--sp", "2"], ["--dp", "2", "--batch",
                                                 "2"]):
        with pytest.raises(SystemExit) as e:
            tcli.main(["--mode", "ar", *COMMON, *flags])
        assert e.value.code not in (0, None)
        assert "torchrun" in str(e.value.code)


def test_cli_without_device_and_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--mode", "ar", *COMMON[:-2]]          # no --device
    assert "--device" not in argv
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argv)


def test_cli_default_dtype_follows_device():
    assert tcli.parse_args([]).device == "cuda"
    res = tcli.main(["--mode", "ar", *COMMON, "--dtype", "bfloat16"])
    assert res.steps == 12


# --- one HF checkpoint pair, both packages ---------------------------------

@pytest.fixture(scope="module")
def hf_pair(tmp_path_factory):
    """A tiny HF target (GQA) and a tiny HF drafter over the same vocab."""
    root = tmp_path_factory.mktemp("hf_pair")
    dirs = []
    for name, kw, seed in (
            ("target", dict(hidden_size=32, intermediate_size=64,
                            num_attention_heads=4, num_key_value_heads=2),
             0),
            ("draft", dict(hidden_size=16, intermediate_size=32,
                           num_attention_heads=2, num_key_value_heads=2),
             1)):
        cfg = transformers.LlamaConfig(
            vocab_size=128, num_hidden_layers=2,
            max_position_embeddings=512, rms_norm_eps=1e-5,
            rope_theta=10000.0, tie_word_embeddings=False, **kw)
        torch.manual_seed(seed)
        model = transformers.LlamaForCausalLM(cfg).eval().float()
        d = str(root / name)
        model.save_pretrained(d)
        dirs.append(d)
    return dirs


def _hf_argv(mode, target, draft, extra=()):
    argv = ["--mode", mode, "--model", target, "--prefill", "64",
            "--gen_len", "16", "--gamma", "3", "--budget", "16",
            "--chunk_size", "4", "--dataset", "synthetic", "--temp", "1e-4",
            "--seed", "3", *extra]
    if mode == "triforce":
        argv += ["--draft", draft, "--draft_cache_budget", "36",
                 "--start_size", "4"]
    return argv


@pytest.mark.parametrize("mode", ["ar", "retrieval", "triforce"])
def test_cli_tokens_equal_jax_on_hf_checkpoint(hf_pair, mode, tmp_path):
    target, draft = hf_pair
    jcsv, tcsv = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    jr = jcli.main(_hf_argv(mode, target, draft, ["--file", jcsv]))
    tr = tcli.main(_hf_argv(mode, target, draft,
                            ["--file", tcsv, "--device", "cpu"]))
    assert tr.tokens == jr.tokens
    assert tr.steps == jr.steps
    if mode != "ar":
        assert tr.acceptance_rate == jr.acceptance_rate
    # the CSV: JAX's header and columns; every field but the timing equal
    jl, tl = (open(p).read().splitlines() for p in (jcsv, tcsv))
    assert tl[0] == jl[0] and len(tl) == len(jl) == 2
    jf, tf = jl[1].split(","), tl[1].split(",")
    assert len(tf) == len(jf) == len(jl[0].split(","))
    timing = jl[0].split(",").index("tokens_per_sec")
    assert tf[:timing] == jf[:timing] and tf[timing + 1:] == jf[timing + 1:]


def test_cli_native_checkpoint_round_trip(hf_pair, tmp_path):
    target, _ = hf_pair
    native = str(tmp_path / "native")
    a = tcli.main(_hf_argv("ar", target, None,
                           ["--device", "cpu", "--save_ckpt", native]))
    b = tcli.main(_hf_argv("ar", native, None, ["--device", "cpu"]))
    assert a.tokens == b.tokens


def test_cli_module_entry_point(tmp_path):
    """``python -m triforce_tpu_torch.cli`` exits 0 and prints its result
    line."""
    # one thread each, as the test process has: the suite runs in workers
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "triforce_tpu_torch.cli", "--mode", "ar",
         *COMMON[:-2], "--device", "cpu", "--gen_len", "4"],
        capture_output=True, text=True, cwd=str(tmp_path), env=env,
        timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "[ar] prompt 0:" in p.stdout
    p = subprocess.run(
        [sys.executable, "-m", "triforce_tpu_torch", "--mode", "ar",
         *COMMON[:-2], "--device", "cpu", "--tp", "2"],
        capture_output=True, text=True, cwd=str(tmp_path), env=env,
        timeout=300)
    assert p.returncode != 0


def test_jax_and_port_parse_the_same_flags():
    """Every flag of the JAX CLI exists in the port with its default; the
    port adds ``--device`` alone."""
    j, t = vars(jcli.parse_args([])), vars(tcli.parse_args([]))
    assert set(t) - set(j) == {"device"}
    for k, v in j.items():
        assert t[k] == v, k
    assert np.isclose(t["temp"], 0.6)


def test_tokenizer_only_from_local_files(tmp_path):
    """No tokenizer files: no tokenizer (and no attempt to fetch one)."""
    assert tcli._tokenizer(str(tmp_path)) is None


def test_cli_runs_an_int8_native_checkpoint(hf_pair, tmp_path):
    """A native checkpoint of int8 codes runs as it is: with or without
    --weight_dtype int8 the same tokens, and not those of the bf16
    weights it was quantized from."""
    from triforce_tpu_torch.models import ckpt as tckpt
    from triforce_tpu_torch.models import hf as thf
    from triforce_tpu_torch.models import llama as tl
    target, _ = hf_pair
    cfg, params = thf.load_params(target, dtype="float32", device="cpu")
    native = str(tmp_path / "int8")
    tckpt.save_checkpoint(native, cfg, tl.quantize_weights(params))
    argv = _hf_argv("ar", native, None, ["--device", "cpu"])
    a = tcli.main(argv)
    b = tcli.main(argv + ["--weight_dtype", "int8"])
    c = tcli.main(_hf_argv("ar", target, None,
                           ["--device", "cpu", "--weight_dtype", "int8"]))
    assert a.tokens == b.tokens == c.tokens


# ---------------------------------------------------------------------------
# --tp / --sp: one gloo process per rank, launched torchrun's way
# ---------------------------------------------------------------------------

MESH_RUNS = {
    "triforce": ["--mode", "triforce", *COMMON, *DRAFT],
    "retrieval int8": ["--mode", "retrieval", *COMMON, "--kv_dtype", "int8",
                       "--weight_dtype", "int8"],
}


@pytest.mark.parametrize("name", list(MESH_RUNS))
def test_cli_tp_sp_over_four_ranks_gives_the_tp1_tokens(name, tmp_path):
    """``cli.main([... "--tp", "2", "--sp", "2"])`` on 4 gloo ranks emits
    the one-process tokens on every rank, and only rank 0 prints."""
    from torch_mesh_worker import launch
    argv = MESH_RUNS[name]
    want = tcli.main(argv).tokens
    res = launch(dict(kind="cli", argv=argv + ["--tp", "2", "--sp", "2"]),
                 4, tmp_path)
    assert all(r["tokens"] == want for r in res)
    assert "prompt 0:" in res[0]["stdout"]
    assert all(r["stdout"] == "" for r in res[1:])


@pytest.mark.parametrize("extra", [["--mode", "tree"], ["--batch", "2"]],
                         ids=["tree", "batch"])
def test_cli_mesh_refuses_what_waits_for_a11b(extra):
    """The tree mode and --batch run over a mesh
    (``tests/test_torch_sharded_rows_tree.py``); outside a process group
    of its size they exit naming the torchrun launch, as every mode
    does."""
    with pytest.raises(SystemExit) as e:
        tcli.main(["--mode", "retrieval", *COMMON, "--tp", "2", *extra])
    assert "torchrun" in str(e.value.code)
