"""The batch-1 window's forwards of a model with expert layers as a share
of what the card could do in the window's wall: the least time
(``roofline_moe.py``) of every target verify over the full cache and the
rings, every live middle verify over the retrieval cache and the rings
(a dead trip reads neither), each
with the experts the window's counters (``Engine.moe_counts``) say a
forward of its kind read on average, and every drafter forward, each
forward its own least time, over the wall."""

import roofline
import roofline_moe


def read(rec):
    d = rec.get("decode")
    win = rec.get("moe", {}).get("window")
    if not d or not win or d["wall_s"] <= 0:
        return None
    m, g = rec["model"], d["gamma"]
    layers = m["num_hidden_layers"]
    avg = (d["len0"] + d["len1"]) / 2

    def experts(kind):
        read_, _, calls = win[kind]
        return layers * read_ / calls if calls else 0.0
    least = (d["steps"] * roofline_moe.least_s(m, g + 2, avg,
                                               experts("target"))
             + d["mid_live"] * roofline_moe.least_s(
                 m, g + 1, avg, experts("middle"), full_visible=d["budget"])
             + (d["mid_verify"] - d["mid_live"]) * roofline_moe.least_s(
                 m, g + 1, 0, experts("middle"))
             + d["mid_draft"] * roofline.least_s(*roofline.forward(
                 m["drafter"], 1, d["draft_window"])))
    return 100.0 * least / d["wall_s"]
