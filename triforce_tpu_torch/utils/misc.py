"""Observability helpers: colored token streaming, CSV logging, config
banner — the port's own copy of ``triforce_tpu/utils/misc.py`` (the port
imports nothing of the JAX package); same colors, CSV layout and banner."""

from __future__ import annotations

import os

_COLORS = {"cyan": "\033[96m", "green": "\033[92m", "red": "\033[91m",
           "blue": "\033[94m", "yellow": "\033[93m"}
_RESET = "\033[0m"


def spec_stream(token_id, tokenizer=None, color: str = "cyan") -> None:
    """Stream one token to stdout, colored by which speculation level
    produced it."""
    if tokenizer is not None:
        text = tokenizer.decode([int(token_id)], skip_special_tokens=False)
    else:
        text = f"<{int(token_id)}>"
    print(f"{_COLORS.get(color, '')}{text}{_RESET}", end=" ", flush=True)


def log_csv(file_path: str, header: str, entry: str) -> None:
    """Append-with-header CSV logger."""
    if file_path is None:
        return
    write_header = not os.path.exists(file_path)
    with open(file_path, "a") as f:
        if write_header:
            f.write(header)
        f.write(entry)


def print_config(**kwargs) -> None:
    """Banner of run configuration."""
    width = max((len(k) for k in kwargs), default=0) + 2
    print("*" * 48)
    for k, v in kwargs.items():
        print(f"  {k:<{width}}: {v}")
    print("*" * 48, flush=True)
