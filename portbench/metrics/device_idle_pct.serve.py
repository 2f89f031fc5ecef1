"""The share of the serving window in which no graph replay ran on the
card: CUDA events before and after every replay; the eager work between
replays (row writes, the first token's sample) counts as idle."""


def read(rec):
    if "serve" not in rec or not rec.get("busy_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
