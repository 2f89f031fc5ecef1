"""Share of the serving window spent admitting (the scheduler's
``stats["admit_s"]``, summed over the window's cycles)."""


def read(rec):
    s = rec.get("serve")
    if not s or s["wall_s"] <= 0:
        return None
    return 100.0 * s["admit_s"] / s["wall_s"]
