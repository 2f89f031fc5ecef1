"""Model / cache / speculation configuration for the PyTorch port.

Counterpart of ``triforce_tpu/config.py``: the same frozen dataclasses and
presets, with torch dtypes. Kept as its own copy so the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

FULL, SLIDING = "full_attention", "sliding_attention"
DENSE, SPARSE = "dense", "sparse"


@dataclasses.dataclass(frozen=True)
class RopeConfig:
    """Rotary embedding config.

    ``kind='llama'`` is the classic RoPE; ``kind='yarn'`` is YaRN NTK-by-parts.
    """

    kind: str = "llama"  # "llama" | "yarn"
    theta: float = 10000.0
    # YaRN-only knobs
    scaling_factor: float = 1.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    extrapolation_factor: float = 1.0
    attn_factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Llama-family architecture description."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    max_position_embeddings: int = 131072
    rms_norm_eps: float = 1e-5
    rope: RopeConfig = dataclasses.field(default_factory=RopeConfig)
    # Drafter-style attention: keys cached UN-rotated; RoPE re-applied to the
    # whole visible window each step with slot-index positions. Target
    # models cache rotated keys.
    rope_on_slots: bool = False
    tie_word_embeddings: bool = False

    @property
    def num_kv_groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # every layer full attention and dense (``HybridConfig`` varies them)
    windowed = False
    moe = False

    @property
    def plan(self) -> "LayerPlan":
        """Each layer's attention and MLP kind and its index among the
        layers of its kind (the stacks its cache and weights live in),
        resolved once a configuration."""
        return _layer_plan(self)

    @property
    def num_full_layers(self) -> int:
        return len(self.plan.full)


@dataclasses.dataclass(frozen=True)
class HybridConfig(ModelConfig):
    """A decoder whose layers differ in kind: sliding-window attention
    beside full attention, and sparse (expert) MLPs.

    ``layer_types``: ``FULL`` / ``SLIDING`` a layer. A sliding layer's
    query at position p sees the keys at positions p - sliding_window + 1
    .. p (itself included), rotated with ``rope_local`` (None: ``rope``).
    With ``num_experts`` every layer's MLP is sparse: it routes each token
    by a softmax over ``num_experts`` to its ``num_experts_per_tok`` best
    experts of width ``moe_intermediate_size`` (their weights renormalised
    to sum 1 with ``norm_topk_prob``). ``mlp_layer_types`` (a published
    config's ``SPARSE`` / ``DENSE`` a layer) may only say so: a model that
    mixes dense and sparse MLPs is not implemented."""

    layer_types: tuple = ()
    sliding_window: int = 0
    rope_local: Optional[RopeConfig] = None
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    norm_topk_prob: bool = True
    mlp_layer_types: tuple = ()

    @property
    def windowed(self) -> bool:
        return SLIDING in self.plan.attn

    @property
    def moe(self) -> bool:
        return self.plan.moe


def refuse_hybrid(cfg: ModelConfig, what: str) -> None:
    """NotImplementedError for a model with sliding-window or expert
    layers on a path that takes plain models only."""
    if cfg.windowed or cfg.moe:
        raise NotImplementedError(
            f"{what} is not implemented for models with sliding-window or "
            f"expert layers: it has no ring cache, window attention or "
            f"expert path; the batch-1 Engine runs them")


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """``attn[li]``: layer li's attention kind; ``slot[li]``: its index
    among the layers of that kind (its cache plane); ``full`` / ``sliding``:
    the layers of each kind, in order; ``moe``: every MLP sparse (the
    expert stacks are indexed by layer)."""
    attn: tuple
    slot: tuple
    full: tuple
    sliding: tuple
    moe: bool


def _kind_index(kinds) -> tuple:
    seen: dict = {}
    out = []
    for k in kinds:
        out.append(seen.get(k, 0))
        seen[k] = out[-1] + 1
    return tuple(out)


@functools.lru_cache(maxsize=64)
def _layer_plan(cfg: ModelConfig) -> LayerPlan:
    n = cfg.num_layers
    attn = tuple(getattr(cfg, "layer_types", ())) or (FULL,) * n
    moe = getattr(cfg, "num_experts", 0) > 0
    mlp = tuple(getattr(cfg, "mlp_layer_types", ())) or (
        (SPARSE if moe else DENSE),) * n
    if len(attn) != n or len(mlp) != n:
        raise ValueError(f"layer_types / mlp_layer_types must name all "
                         f"{n} layers")
    if set(attn) - {FULL, SLIDING} or set(mlp) - {DENSE, SPARSE}:
        raise ValueError(f"unknown layer kinds in {set(attn) | set(mlp)}")
    if SLIDING in attn and cfg.sliding_window < 1:
        raise ValueError("sliding layers need sliding_window >= 1")
    if moe and DENSE in mlp:
        raise NotImplementedError(
            "dense MLP layers beside expert layers are not implemented: "
            "with num_experts every layer's MLP is sparse")
    if SPARSE in mlp and not (0 < cfg.num_experts_per_tok
                              <= cfg.num_experts
                              and cfg.moe_intermediate_size > 0):
        raise ValueError("sparse layers need num_experts, "
                         "num_experts_per_tok and moe_intermediate_size")
    if FULL not in attn:
        raise ValueError("a model needs a full-attention layer (the "
                         "retrieval cache is built over them)")
    return LayerPlan(attn, _kind_index(attn),
                     tuple(i for i, k in enumerate(attn) if k == FULL),
                     tuple(i for i, k in enumerate(attn) if k == SLIDING),
                     moe)


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculation hyper-parameters."""

    gamma: int = 6                # drafter lookahead per middle round
    budget: int = 4096            # retrieval cache budget (selected tokens)
    chunk_size: int = 8           # retrieval chunk granularity
    # drafter tokens verified per middle forward (engine._middle_spec);
    # 1 = one drafter step per middle verify
    middle_chain: int = 1
    # middle-loop trip bound: 0 = loop until gamma proposals; > 0 = a fixed
    # number of trips (dead trips run with a zero-column retrieval read)
    middle_trips: int = 0
    # int8 activations in the middle verify (takes effect with int8
    # weights: ``llama._wmm(aq=True)``)
    mid_act_quant: bool = False
    draft_start_size: int = 16    # StreamingLLM sink
    draft_recent_size: int = 250  # StreamingLLM window
    temperature: float = 0.6
    top_p: float = 0.9
    top_k: int = -1
    max_len: int = 256            # generation length


# ---------------------------------------------------------------------------
# Presets (the same model zoo as the JAX package)
# ---------------------------------------------------------------------------

LLAMA_68M = ModelConfig(
    vocab_size=32000,
    hidden_size=768,
    intermediate_size=3072,
    num_layers=2,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    max_position_embeddings=2048,
    rms_norm_eps=1e-6,
    rope=RopeConfig(kind="llama", theta=10000.0),
    rope_on_slots=True,  # drafter: StreamingLLM slot-position semantics
)

# NousResearch/Yarn-Llama-2-7b-128k
LLAMA2_7B_128K = ModelConfig(
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=11008,
    num_layers=32,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    max_position_embeddings=131072,
    rms_norm_eps=1e-5,
    rope=RopeConfig(
        kind="yarn",
        theta=10000.0,
        scaling_factor=32.0,
        original_max_position_embeddings=4096,
    ),
)

# NousResearch/Yarn-Llama-2-13b-128k
LLAMA2_13B_128K = LLAMA2_7B_128K.with_(
    hidden_size=5120,
    intermediate_size=13824,
    num_layers=40,
    num_heads=40,
    num_kv_heads=40,
)

# LargeWorldModel/LWM-Text-Chat-128K: plain RoPE with a large theta.
LWM_TEXT_CHAT_128K = LLAMA2_7B_128K.with_(
    rope=RopeConfig(kind="llama", theta=10_000_000.0),
)

# A GQA long-context config (22 layers x 4 KV heads x 64 dim).
TINYLLAMA_1_1B_128K = ModelConfig(
    vocab_size=32000,
    hidden_size=2048,
    intermediate_size=5632,
    num_layers=22,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    max_position_embeddings=131072,
    rms_norm_eps=1e-5,
    rope=RopeConfig(
        kind="yarn",
        theta=10000.0,
        scaling_factor=64.0,
        original_max_position_embeddings=2048,
    ),
)

# Llama-7B-128K's KV-to-weights byte ratio at a smaller size.
BENCH_7B_PROXY = ModelConfig(
    vocab_size=32000,
    hidden_size=2048,
    intermediate_size=5632,
    num_layers=16,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    max_position_embeddings=131072,
    rms_norm_eps=1e-5,
    rope=RopeConfig(
        kind="yarn",
        theta=10000.0,
        scaling_factor=32.0,
        original_max_position_embeddings=4096,
    ),
)

# Llama2-13B-128K's KV-to-weights byte ratio at a smaller size.
BENCH_13B_PROXY = ModelConfig(
    vocab_size=32000,
    hidden_size=2560,
    intermediate_size=6912,
    num_layers=17,
    num_heads=20,
    num_kv_heads=20,
    head_dim=128,
    max_position_embeddings=131072,
    rms_norm_eps=1e-5,
    rope=RopeConfig(
        kind="yarn",
        theta=10000.0,
        scaling_factor=32.0,
        original_max_position_embeddings=4096,
    ),
)

# Tiny configs for CPU unit tests.
TINY_TARGET = ModelConfig(
    vocab_size=199,
    hidden_size=64,
    intermediate_size=128,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    max_position_embeddings=4096,
    rms_norm_eps=1e-5,
    rope=RopeConfig(kind="yarn", theta=10000.0, scaling_factor=4.0,
                    original_max_position_embeddings=1024),
)

TINY_DRAFT = ModelConfig(
    vocab_size=199,
    hidden_size=32,
    intermediate_size=64,
    num_layers=2,
    num_heads=2,
    num_kv_heads=2,
    head_dim=16,
    max_position_embeddings=2048,
    rms_norm_eps=1e-6,
    rope=RopeConfig(kind="llama", theta=10000.0),
    rope_on_slots=True,
)

PRESETS = {
    "llama-68m": LLAMA_68M,
    "llama2-7b-128k": LLAMA2_7B_128K,
    "llama2-13b-128k": LLAMA2_13B_128K,
    "lwm-text-chat-128k": LWM_TEXT_CHAT_128K,
    "tinyllama-1.1b-128k": TINYLLAMA_1_1B_128K,
    "bench-7b-proxy": BENCH_7B_PROXY,
    "bench-13b-proxy": BENCH_13B_PROXY,
    "tiny-target": TINY_TARGET,
    "tiny-draft": TINY_DRAFT,
}

# JetBrains/Mellum2-12B-A2.5B-Instruct (config.json): 28 layers, three
# 1024-token sliding-window layers then one full layer, repeated; 64
# experts of 896 a layer, top 8 renormalised, no shared expert. The full
# layers take YaRN x16 over 8192 (mscale 0.1 ln 16 + 1 = 1.27726, the
# config's attention_factor), the sliding ones plain RoPE, both at 5e5.
MELLUM2_12B_A2_5B = HybridConfig(
    vocab_size=98304,
    hidden_size=2304,
    intermediate_size=0,
    num_layers=28,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    max_position_embeddings=131072,
    rms_norm_eps=1e-6,
    rope=RopeConfig(kind="yarn", theta=500000.0, scaling_factor=16.0,
                    original_max_position_embeddings=8192),
    layer_types=(SLIDING, SLIDING, SLIDING, FULL) * 7,
    sliding_window=1024,
    rope_local=RopeConfig(kind="llama", theta=500000.0),
    num_experts=64,
    num_experts_per_tok=8,
    moe_intermediate_size=896,
)

# Mellum2's shape at CPU-test size: 3 sliding layers + 1 full, window 16,
# 8 experts top 2.
TINY_MOE_WINDOW = HybridConfig(
    vocab_size=199,
    hidden_size=64,
    intermediate_size=0,
    num_layers=4,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    max_position_embeddings=4096,
    rms_norm_eps=1e-6,
    rope=RopeConfig(kind="yarn", theta=10000.0, scaling_factor=4.0,
                    original_max_position_embeddings=1024),
    layer_types=(SLIDING, SLIDING, SLIDING, FULL),
    sliding_window=16,
    rope_local=RopeConfig(kind="llama", theta=10000.0),
    num_experts=8,
    num_experts_per_tok=2,
    moe_intermediate_size=32,
)

DEFAULT_DTYPE = torch.bfloat16


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's, else the first CUDA
    card. With no card and no explicit device this raises — the port never
    drops to the CPU unless asked to (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass "
                               "device='cpu' to run on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
