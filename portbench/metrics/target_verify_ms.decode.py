"""The full-cache target verify (gamma + 2 tokens) at the window's
context: ``profiling.measure_phase_times``, CUDA events over graph
replays."""


def read(rec):
    return rec.get("phase_ms", {}).get("target_verify")
