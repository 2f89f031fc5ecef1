"""Milliseconds a batched decode step of the serving window takes
(``stats["decode_s"] / stats["steps"]``)."""


def read(rec):
    s = rec.get("serve")
    if not s or not s["steps"]:
        return None
    return 1e3 * s["decode_s"] / s["steps"]
