"""Admission as a share of what the card could do in its seconds: the
least time of the prefills completed in the window (each chunk's forward
its own) over ``stats["admit_s"]``."""

import roofline


def read(rec):
    s = rec.get("serve")
    if not s or s["admit_s"] <= 0 or not s["prefill_tokens"]:
        return None
    least = roofline.prefill_least_s(rec["model"], rec["prompt"],
                                     rec["prefill_chunk"])
    return 100.0 * least * s["prefill_tokens"] / rec["prompt"] \
        / s["admit_s"]
