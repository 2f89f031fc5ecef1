"""The witness of where the judge's errors come from: the reference's own
equations (``reference/model.py``) evaluated in bfloat16 against float32,
on the same weights and tokens, layer by layer. No code of the program
runs, so what the bfloat16 evaluation reads is what rounding alone does
to these weights; the program's sound runs should read about as much.

    python3 portbench/witness.py --config yarn-mistral-7b-128k \
        --tokens 16384 --seed 7

``--scheme`` ``made`` (the default) takes the weights as the harness
makes them; ``chaotic`` takes an embedding N(0, 0.02) and no outlier
rows, a scheme under which 32 random layers amplify every rounding. One
JSON line a layer: the worst position's K and V error, measured as
``reference/check.py`` measures ``kv_err``, and their RMS over the
positions.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

import harness  # noqa: E402
from reference import model  # noqa: E402

SCHEMES = {"made": {}, "chaotic": {"embed_std": 0.02, "outlier_rows": 0}}


def layer_errors(cfg: dict, weights: dict, ids: torch.Tensor) -> list:
    """[(worst K, worst V, RMS K, RMS V)] a layer, bfloat16 against
    float32."""
    model.strict_fp32()
    low = {}
    with torch.no_grad():
        model.forward(cfg, weights, ids, dtype=torch.bfloat16,
                      on_layer=lambda li, q, k, v: low.update({li: (k, v)}))
    out = []

    def err(ref, got):
        d = (got.float() - ref).pow(2).sum(dim=(1, 2)).sqrt()
        n = float(ref.pow(2).sum(dim=(1, 2)).mean().sqrt())
        return float(d.max()) / n, float(d.pow(2).mean().sqrt()) / n

    def on_layer(li, q, k, v):
        (wk, rk), (wv, rv) = err(k, low[li][0]), err(v, low[li][1])
        out.append((wk, wv, rk, rv))
        del low[li]
    with torch.no_grad():
        model.forward(cfg, weights, ids, on_layer=on_layer)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--tokens", type=int, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--scheme", choices=sorted(SCHEMES), default="made")
    ap.add_argument("--layers", type=int, default=None,
                    help="only the first N layers (a CPU-sized check)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    cfg = harness.load_json(HERE / "configs" / f"{a.config}.json")
    if a.layers:
        cfg = dict(cfg, num_hidden_layers=a.layers)
    dev = torch.device(a.device)
    gen = torch.Generator(device=dev).manual_seed(a.seed)
    weights = harness.make_weights(cfg, gen, dev, **SCHEMES[a.scheme])
    ids = harness.make_prompt(cfg["vocab_size"], a.tokens, gen, dev)
    for li, (wk, wv, rk, rv) in enumerate(layer_errors(cfg, weights, ids)):
        print(json.dumps({"scheme": a.scheme, "layer": li, "k_worst": wk,
                          "v_worst": wv, "k_rms": rk, "v_rms": rv}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
