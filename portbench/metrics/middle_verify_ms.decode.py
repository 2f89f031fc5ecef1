"""One middle verify (gamma + 1 tokens over the retrieval cache) at the
window's context: ``profiling.measure_phase_times``."""


def read(rec):
    return rec.get("phase_ms", {}).get("middle_step")
