"""Last-used-settings persistence — the reference's ``.gui_prefs.json`` (the
port's copy of ``hdrtv_tpu/utils/prefs.py``; the same file, so both CLIs
restore the same settings).

The reference GUI persists the user's last precision/resolution/HG/display
choices in ``.gui_prefs.json`` next to the app and restores them at startup
(gui_settings_preview.py: prefs load/save + paused hot-swap preview). The
CLI plays that role here: ``convert`` restores any setting the user did not
pass explicitly, and the interactive shell saves the state it ended with
(after precision/resolution hot-swaps).

Location: ``$HDRTVNET_PREFS_PATH`` if set, else
``~/.config/hdrtv_tpu/prefs.json``.
"""

from __future__ import annotations

import json
import os
import tempfile

from hdrtv_tpu_torch.utils.env import env_str

# the persisted subset — mirrors the reference's prefs keys that have a
# CLI equivalent (precision/resolution/HG/display kind)
KNOWN_KEYS = ("precision", "resolution", "use_hg", "display", "upscale", "film_grain")


def prefs_path() -> str:
    override = env_str("HDRTVNET_PREFS_PATH").strip()
    if override:
        return override
    return os.path.join(os.path.expanduser("~"), ".config", "hdrtv_tpu", "prefs.json")


def load_prefs() -> dict:
    """Current prefs dict; {} when absent or unreadable (never raises)."""
    try:
        with open(prefs_path()) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, json.JSONDecodeError, ValueError):
        return {}


def save_prefs(**updates) -> dict:
    """Merge ``updates`` into the stored prefs (atomic write). Unknown keys
    are rejected to keep the file a stable schema. Returns the merged dict;
    never raises on IO failure (prefs are best-effort, like the GUI's)."""
    bad = [k for k in updates if k not in KNOWN_KEYS]
    if bad:
        raise ValueError(f"unknown pref keys: {bad}")
    merged = {**load_prefs(), **{k: v for k, v in updates.items() if v is not None}}
    path = prefs_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".prefs_")
        with os.fdopen(fd, "w") as f:
            json.dump(merged, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass
    return merged
