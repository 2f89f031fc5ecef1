"""Dataset layer: long-context prompt sources — the port's own copy of
``triforce_tpu/data.py`` (numpy only; the port imports nothing of the JAX
package): the PG-19 variants '128k' / 'gs' / 'one-shot' from local JSON
files, 'demo' / 'lwm' NarrativeQA with the LWM chat template from a local
``narrativeqa.json``, and a ``synthetic`` source that needs no corpus.
``synthetic_prompts`` gives the JAX package's arrays for the same seed.

Prompts are numpy [1, T] int64 arrays.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

# fixed NarrativeQA sample indices of the reference's 'demo' / 'lwm' sets
_NARRATIVEQA_IDX = [0, 50, 300, 800, 950, 1100, 2150, 2450, 2550, 2750,
                    3350, 3400, 3600, 3900, 4000, 4100, 4200, 4400, 4500,
                    4550]


def build_chat_input_lwm(tokenizer, message: str,
                         prefill: int = 127 * 1024) -> np.ndarray:
    """LWM single-turn chat template around a book excerpt, trimmed so the
    whole prompt is ~``prefill`` tokens."""
    book = tokenizer.encode(message)[: prefill - 84]
    prompt = (
        "You are a helpful assistant. USER: Please read a part of the book "
        "below, and then give me the summary.\n[start of the book]\n"
        + tokenizer.decode(book, skip_special_tokens=True)
        + "\n[end of the book]\n\nNow you have read it. Please summarize it "
        "for me. First, tell me the title and the author, and then tell the "
        "story in 400 words.\n\nASSISTANT: ")
    ids = tokenizer.encode(prompt)
    return np.asarray(ids, np.int64)[None]


def _pg19_prompts(tokenizer, limit: Optional[int],
                  data_dir: str) -> List[np.ndarray]:
    """Tokenize local PG-19 JSON files ({'text': ...} per line)."""
    # narrativeqa.json belongs to the demo / lwm branch
    files = sorted(f for f in os.listdir(data_dir)
                   if f != "narrativeqa.json") \
        if os.path.isdir(data_dir) else []
    if not files:
        raise FileNotFoundError(
            f"no PG-19 JSON files under {data_dir!r}; place "
            "{'text': ...}-per-line JSON there or use dataset='synthetic'")
    texts = []
    for name in files:
        with open(os.path.join(data_dir, name)) as f:
            for line in f:
                line = line.strip()
                if line:
                    texts.append(json.loads(line)["text"])
                if limit and len(texts) >= limit:
                    break
        if limit and len(texts) >= limit:
            break
    return [np.asarray(tokenizer.encode(t), np.int64)[None] for t in texts]


def synthetic_prompts(n_prompts: int = 1, length: int = 4096,
                      vocab_size: int = 32000, seed: int = 0,
                      ) -> List[np.ndarray]:
    """Deterministic corpus-free prompts: a Zipf-distributed token stream
    with periodic motif repeats (so retrieval has signal)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_prompts):
        ranks = rng.zipf(1.2, size=length).astype(np.int64)
        toks = (ranks + 3) % vocab_size
        motif = toks[: min(64, length)]
        for s in range(0, length - len(motif), max(length // 8, len(motif))):
            if rng.random() < 0.5:
                toks[s: s + len(motif)] = motif
        out.append(toks[None])
    return out


def get_dataset(name: str, tokenizer=None, datalen: Optional[int] = None,
                data_dir: str = "data/pg19", vocab_size: int = 32000,
                seed: int = 0) -> List[np.ndarray]:
    """Prompt source registry. NarrativeQA ('demo', 'lwm') reads
    ``<data_dir>/narrativeqa.json`` ({'text': ...} per line) and raises
    without it: the port does not fetch the corpus."""
    if name != "synthetic" and tokenizer is None:
        raise ValueError(
            f"dataset {name!r} needs a tokenizer, but none is available "
            "(preset models have no HF tokenizer). Use --dataset synthetic, "
            "or point --model at a local HF checkpoint directory.")
    if name == "128k":
        return _pg19_prompts(tokenizer, None, data_dir)
    if name == "gs":
        return _pg19_prompts(tokenizer, 20, data_dir)
    if name == "one-shot":
        return _pg19_prompts(tokenizer, 1, data_dir)
    if name in ("demo", "lwm"):
        idxs = _NARRATIVEQA_IDX[2:3] if name == "demo" else _NARRATIVEQA_IDX
        fx = os.path.join(data_dir, "narrativeqa.json")
        if not os.path.isfile(fx):
            raise FileNotFoundError(
                f"dataset {name!r} reads NarrativeQA from {fx!r} "
                "({'text': ...} per line), which is missing; the port "
                "does not download the corpus")
        with open(fx) as f:
            docs = [json.loads(line)["text"] for line in f if line.strip()]
        return [build_chat_input_lwm(tokenizer, t[3: 1024 * 500])
                for t in docs[: len(idxs)]]
    if name == "synthetic":
        return synthetic_prompts(1, datalen or 4096, vocab_size, seed)
    raise ValueError(f"unknown dataset {name!r}")


def fit_prompt(ids: np.ndarray, prefill: int) -> np.ndarray:
    """Trim / tile a prompt to exactly ``prefill`` tokens."""
    ids = np.asarray(ids)
    if ids.ndim == 1:
        ids = ids[None]
    t = ids.shape[1]
    if t >= prefill:
        return ids[:, :prefill]
    reps = -(-prefill // t)
    return np.tile(ids, (1, reps))[:, :prefill]
