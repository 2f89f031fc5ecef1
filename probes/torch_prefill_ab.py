"""One batch-1 TriForce run of the port at full width, for holding two
trees (a parent and a change) token for token and timing their prefills
on one card: Llama2-7B-128K + Llama-68M with random weights from seeds 0
and 1, a 32768-token prompt from seed 5 (``chip_smoke.py``'s), the
engine's defaults (graphs where the tree has them).

It times two prefills of fresh states (``prefill_target`` then
``prefill_draft``; host clock, device synchronised at both ends; a tree
with prefill graphs captures them in both, a state's graphs being its
own), then runs ``decoding.triforce`` for 128 tokens with seed 1 and
counts every kernel's launches. It prints one ``AB TAG {...}`` line: the
tokens' SHA-256, steps, launches and the prefill seconds. Run it from
each tree's root, in turns, in one call:

    python3 probes/torch_prefill_ab.py TAG
"""

import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from triforce_tpu_torch import _build, config as tc, decoding  # noqa: E402
from triforce_tpu_torch.engine import Engine  # noqa: E402
from triforce_tpu_torch.models import llama  # noqa: E402
from triforce_tpu_torch.ops import flash_decode as fd  # noqa: E402
from triforce_tpu_torch.ops import retrieval_kernel as rk  # noqa: E402

PREFILL, GEN = 32768, 128
COUNTED = {"b1": fd.flash_decode_append, "b2": rk.chunk_scores}


def main():
    tag = sys.argv[1]
    dev = torch.device("cuda")
    _build.build()
    tcfg, dcfg = tc.LLAMA2_7B_128K, tc.LLAMA_68M
    spec = tc.SpecConfig(gamma=6, budget=4096, chunk_size=8)
    eng = Engine(tcfg, spec,
                 llama.init_params(tcfg, device=dev, dtype=torch.bfloat16,
                                   seed=0),
                 draft_cfg=dcfg,
                 draft_params=llama.init_params(dcfg, device=dev,
                                                dtype=torch.bfloat16, seed=1),
                 prefill=PREFILL, max_cache_len=PREFILL + GEN + 32,
                 dtype=torch.bfloat16, device=dev)
    ids = torch.randint(0, tcfg.vocab_size, (1, PREFILL),
                        generator=torch.Generator().manual_seed(5)).to(dev)
    prefill_s = []
    for seed in (2, 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = eng.prefill_draft(eng.prefill_target(eng.init_state(seed), ids),
                               ids)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        del st
    for fn in COUNTED.values():
        fn.launches = 0
    r = decoding.triforce(eng, ids, max_len=GEN, seed=1, device=dev)
    out = dict(
        tokens_sha256=hashlib.sha256(json.dumps(r.tokens).encode())
        .hexdigest(), tokens=len(r.tokens), steps=r.steps,
        middle_verifies=r.middle_verifies,
        launches={k: fn.launches for k, fn in COUNTED.items()},
        prefill_s=prefill_s, ms_per_token=1e3 / r.tokens_per_sec,
        captures=getattr(eng.graphs, "captures", None),
        capture_s=getattr(eng.graphs, "capture_s", None))
    print(f"AB {tag} {json.dumps(out)}", flush=True)


if __name__ == "__main__":
    main()
