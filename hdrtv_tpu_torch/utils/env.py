"""Environment-variable parsing (the port's own copy of
``hdrtv_tpu/utils/env.py``: same tokens and clamps, so a user carries their
environment over unchanged)."""

from __future__ import annotations

import os

_TRUTHY = {"1", "true", "yes", "on", "y", "t"}
_FALSY = {"0", "false", "no", "off", "n", "f", ""}


def env_bool(name: str, default: bool = False) -> bool:
    """The variable as a flag; unset or unrecognised gives ``default``."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    token = raw.strip().lower()
    if token in _TRUTHY:
        return True
    if token in _FALSY:
        return False
    return default


def env_str(name: str, default: str = "") -> str:
    """The variable as it is set; unset gives ``default``."""
    value = os.environ.get(name)
    return default if value is None else str(value)


def env_int(name: str, default: int = 0, *, lo: int | None = None, hi: int | None = None) -> int:
    """The variable as an int clamped to [lo, hi]; unset or unparsable gives ``default``."""
    try:
        value = int(str(os.environ.get(name, default)).strip())
    except (TypeError, ValueError):
        value = default
    if lo is not None:
        value = max(lo, value)
    if hi is not None:
        value = min(hi, value)
    return value


def env_float(name: str, default: float = 0.0, *, lo: float | None = None, hi: float | None = None) -> float:
    """The variable as a float clamped to [lo, hi]; unset, unparsable or NaN gives ``default``."""
    try:
        value = float(str(os.environ.get(name, default)).strip())
    except (TypeError, ValueError):
        value = default
    if value != value:  # NaN
        value = default
    if lo is not None:
        value = max(lo, value)
    if hi is not None:
        value = min(hi, value)
    return value
