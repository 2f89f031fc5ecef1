"""B3 (``ops/flash_decode.py``, row-batched) against its roofline: one
batched step of the eager witness on a copy of the pool under
``torch.profiler``; the flash-decode kernels' device seconds against
the least time of the reads that step needed (every target forward, one
call over each live row's cache, and each row's live middle verifies
over its retrieval cache; the drafter's reads left out, so a floor)."""

import roofline


def read(rec):
    b = rec.get("b3")
    if not b or b["device_s"] <= 0 or not b["lens"]:
        return None
    m, g = rec["model"], b["gamma"]
    verify = roofline.add(*(roofline.attention_kernel(m, g + 2, n)
                            for n in b["lens"]))
    least = (b["target_forwards"] * roofline.least_s(*verify)
             + sum(b["mid_live"]) * roofline.least_s(
                 *roofline.attention_kernel(m, g + 1, b["budget"])))
    return 100.0 * least / b["device_s"]
