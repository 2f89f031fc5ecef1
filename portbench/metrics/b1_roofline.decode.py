"""B1 (``ops/flash_decode.py``) against its roofline: a few steps of the
eager witness under ``torch.profiler``; the flash-decode kernels' device
seconds against the least time of the reads those steps needed (each
target verify over the full cache, each live middle verify over the
retrieval cache, each call its own least time; the drafter's small
reads are left out of the bound, so the share is a floor)."""

import roofline


def read(rec):
    b = rec.get("b1")
    if not b or b["device_s"] <= 0:
        return None
    m, g = rec["model"], b["gamma"]
    avg = (b["len0"] + b["len1"]) / 2
    least = (b["steps"] * roofline.least_s(*roofline.attention_kernel(
                 m, g + 2, avg))
             + b["mid_live"] * roofline.least_s(*roofline.attention_kernel(
                 m, g + 1, b["budget"])))
    return 100.0 * least / b["device_s"]
