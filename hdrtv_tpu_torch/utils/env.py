"""Environment-variable parsing (the port's own copy of the ``env_bool`` and
``env_str`` of ``hdrtv_tpu/utils/env.py``: same tokens, so a user carries
their environment over unchanged)."""

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
