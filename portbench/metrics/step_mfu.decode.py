"""The batch-1 window's forwards as a share of what the card could do
in the window's wall: the least time of every target verify over the
full cache, every middle verify over the retrieval cache and every
drafter forward the engine's counters record, each forward its own
least time, over the wall."""

import roofline


def read(rec):
    d = rec.get("decode")
    if not d or d["wall_s"] <= 0:
        return None
    m, g = rec["model"], d["gamma"]
    avg = (d["len0"] + d["len1"]) / 2

    def each(model, tokens, visible):
        return roofline.least_s(*roofline.forward(model, tokens, visible))
    least = (d["steps"] * each(m, g + 2, avg)
             + d["mid_live"] * each(m, g + 1, d["budget"])
             + (d["mid_verify"] - d["mid_live"]) * each(m, g + 1, 0)
             + d["mid_draft"] * each(m["drafter"], 1, d["draft_window"]))
    return 100.0 * least / d["wall_s"]
