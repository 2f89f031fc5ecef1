"""The share of the batch-1 window in which no graph replay ran on the
card: CUDA events before and after every replay."""


def read(rec):
    if "decode" not in rec or not rec.get("busy_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
