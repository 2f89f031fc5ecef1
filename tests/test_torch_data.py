"""The port's data layer (``triforce_tpu_torch/data.py``) against the JAX
package's ``triforce_tpu/data.py``: the same prompts, array for array, from
the same seeds, fixtures and stub tokenizer (``tests/test_data.py``)."""

import json

import numpy as np
import pytest

from triforce_tpu import data as jdata
from triforce_tpu_torch import data as tdata

FIXTURE_DIR = __file__.rsplit("/", 1)[0] + "/fixtures"


class _Tok:
    def encode(self, text):
        return [ord(c) % 100 for c in text]

    def decode(self, ids, **kw):
        return "".join(chr(97 + (i % 26)) for i in ids)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n,length,vocab,seed", [
    (1, 4096, 32000, 0), (2, 256, 1000, 3), (3, 100, 199, 7),
    (1, 32768, 32000, 1)])
def test_synthetic_prompts_equal_jax(n, length, vocab, seed):
    a = tdata.synthetic_prompts(n, length, vocab_size=vocab, seed=seed)
    _same(a, jdata.synthetic_prompts(n, length, vocab_size=vocab, seed=seed))
    for x in a:
        assert x.shape == (1, length) and x.min() >= 0 and x.max() < vocab


@pytest.mark.parametrize("prefill", [1, 4, 10, 25, 64])
def test_fit_prompt_equals_jax(prefill):
    for ids in (np.arange(10)[None], np.arange(7), np.arange(3)[None] + 5):
        np.testing.assert_array_equal(tdata.fit_prompt(ids, prefill),
                                      jdata.fit_prompt(ids, prefill))


@pytest.mark.parametrize("name", ["128k", "gs", "one-shot"])
def test_pg19_fixture_equals_jax(name):
    a = tdata.get_dataset(name, _Tok(), data_dir=FIXTURE_DIR)
    _same(a, jdata.get_dataset(name, _Tok(), data_dir=FIXTURE_DIR))
    assert len(a) == {"128k": 2, "gs": 2, "one-shot": 1}[name]


def test_pg19_local_json_limits(tmp_path):
    d = tmp_path / "pg19"
    d.mkdir()
    with open(d / "a.json", "w") as f:
        for t in ["hello world", "second text", "third"]:
            f.write(json.dumps({"text": t}) + "\n")
    for name in ("one-shot", "gs", "128k"):
        _same(tdata.get_dataset(name, _Tok(), data_dir=str(d)),
              jdata.get_dataset(name, _Tok(), data_dir=str(d)))


@pytest.mark.parametrize("name", ["demo", "lwm"])
def test_narrativeqa_fixture_equals_jax(name):
    a = tdata.get_dataset(name, _Tok(), data_dir=FIXTURE_DIR)
    _same(a, jdata.get_dataset(name, _Tok(), data_dir=FIXTURE_DIR))
    assert len(a) == {"demo": 1, "lwm": 2}[name]


def test_lwm_chat_template_equals_jax():
    for msg, prefill in (("x" * 500, 300), ("a book", 127 * 1024)):
        np.testing.assert_array_equal(
            tdata.build_chat_input_lwm(_Tok(), msg, prefill=prefill),
            jdata.build_chat_input_lwm(_Tok(), msg, prefill=prefill))


def test_synthetic_dataset_equals_jax():
    _same(tdata.get_dataset("synthetic", datalen=512, vocab_size=500,
                            seed=4),
          jdata.get_dataset("synthetic", datalen=512, vocab_size=500,
                            seed=4))


def test_missing_sources_raise_clearly(tmp_path):
    # NarrativeQA without its fixture: a clear error, no download
    with pytest.raises(FileNotFoundError, match="narrativeqa.json"):
        tdata.get_dataset("demo", _Tok(), data_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no PG-19 JSON files"):
        tdata.get_dataset("gs", _Tok(), data_dir=str(tmp_path / "none"))
    with pytest.raises(ValueError, match="needs a tokenizer"):
        tdata.get_dataset("one-shot", None, data_dir=FIXTURE_DIR)
    with pytest.raises(ValueError, match="unknown dataset"):
        tdata.get_dataset("nope", _Tok())
