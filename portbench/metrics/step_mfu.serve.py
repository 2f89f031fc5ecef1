"""The serving window's work as a share of what the card could do in its
wall: every batched target forward over its live rows' caches (the
scheduler's ``target_forwards``, the rows live at each cycle's start) and
every admission's prefill completed in the window, each forward its own
least time. Middle verifies and drafter forwards have no counter in the
scheduler's stats and are left out, so the share is a floor."""

import roofline


def read(rec):
    s = rec.get("serve")
    if not s or s["wall_s"] <= 0:
        return None
    m, g = rec["model"], rec["serve"]["gamma"]
    least = roofline.prefill_least_s(m, rec["prompt"], rec["prefill_chunk"]
                                     ) * s["prefill_tokens"] / rec["prompt"]
    for fwd, lens in s["cycles"]:
        if fwd and lens:
            least += fwd * roofline.least_s(*roofline.forward(
                m, g + 2, sum(lens) / len(lens), rows=len(lens)))
    return 100.0 * least / s["wall_s"]
