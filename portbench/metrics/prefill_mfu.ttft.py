"""The target prefill's least time (each chunk's forward its own) over
``ttft_s`` (which also holds the retrieval build and the drafter's
prefill)."""

import roofline


def read(rec):
    if "ttft_s" not in rec:
        return None
    least = roofline.prefill_least_s(rec["model"], rec["prompt"],
                                     rec["prefill_chunk"])
    return 100.0 * least / rec["ttft_s"]
