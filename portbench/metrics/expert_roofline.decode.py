"""The expert kernel (``ops/moe.py``: its gate/up, down and combine
kernels) against its roofline: a few steps of the eager witness under
``torch.profiler``; the least time of the expert weights those steps'
forwards read (the experts the program's counter ``moe.experts_read``
counted, each 3 x I x H bf16 weights, over 3.35 TB/s) over the union of
the expert kernels' intervals on the card (so that launches overlapping
one another do not count twice)."""

import roofline
import roofline_moe


def read(rec):
    w = rec.get("moe", {}).get("witness")
    if not w or w["device_s"] <= 0:
        return None
    least = w["experts_read"] * roofline_moe.expert_bytes(rec["model"]) \
        / roofline.HBM_BYTES_PER_S
    return 100.0 * least / w["device_s"]
