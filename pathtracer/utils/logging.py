"""Structured logging (SURVEY.md §5.5): host-0-only lines on stderr."""

from __future__ import annotations

import sys
import time


def is_host_zero() -> bool:
    try:
        import jax

        return jax.process_index() == 0
    except Exception:
        return True


def log(msg: str, **fields) -> None:
    """Human line + optional structured fields, host 0 only."""
    if not is_host_zero():
        return
    if fields:
        msg = f"{msg} " + " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[pathtracer {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr)
