"""Required-asset inventory and validation — the clone-asset gate (the
port's copy of ``hdrtv_tpu/utils/assets.py``).

The reference ships a pinned-asset mechanism: assets too big for git are
listed with target paths and minimum sizes, missing ones are detected at
startup, auto-downloaded when allowed, and every download is validated by
size + an HTML-error-page sniff (required_clone_assets.py:32-70,80-113,
194-203; gates `HDRTVNET_REQUIRE_CLONE_ASSETS` /
`HDRTVNET_AUTO_DOWNLOAD_CLONE_ASSETS`). The package downloads nothing, so
the download step is absent: the inventory here enumerates every
weight file the preset table references, validates what exists, and reports
what is missing with the path a user must populate.
"""

from __future__ import annotations

import dataclasses
import os

from hdrtv_tpu_torch.utils.env import env_bool


@dataclasses.dataclass(frozen=True)
class AssetStatus:
    name: str
    path: str
    status: str  # ok | missing | too_small | html_page
    size_bytes: int = 0
    used_by: tuple = ()


def validate_file(path: str, min_size_bytes: int = 1024) -> str:
    """ok / missing / too_small / html_page — the reference's download
    validation contract (required_clone_assets.py:194-203)."""
    if not os.path.isfile(path):
        return "missing"
    size = os.path.getsize(path)
    if size < min_size_bytes:
        return "too_small"
    with open(path, "rb") as f:
        head = f.read(512).lstrip().lower()
    if head.startswith(b"<!doctype html") or head.startswith(b"<html"):
        return "html_page"
    return "ok"


def required_assets() -> list[AssetStatus]:
    """Every weight file the preset table references, deduplicated, with
    the presets that use it (gui_config.py:19-160 table as the manifest)."""
    from hdrtv_tpu_torch.config import PRECISIONS

    by_path: dict[str, set[str]] = {}
    for key, preset in PRECISIONS.items():
        for p in (preset.model, preset.model_nohg, preset.hg_weights):
            if p:
                by_path.setdefault(p, set()).add(key)
    out = []
    for path in sorted(by_path):
        # 64 KB floor: the smallest legitimate checkpoints (int8 HR) are
        # ~0.8 MB; the reference's 1 MB floor applies only to its two
        # pinned Drive assets, not the whole weight set
        status = validate_file(path, min_size_bytes=64 * 1024)
        size = os.path.getsize(path) if os.path.isfile(path) else 0
        out.append(
            AssetStatus(
                name=os.path.basename(path),
                path=path,
                status=status,
                size_bytes=size,
                used_by=tuple(sorted(by_path[path])),
            )
        )
    return out


def missing_assets() -> list[AssetStatus]:
    return [a for a in required_assets() if a.status != "ok"]


def require_assets_or_raise() -> None:
    """Fail fast when weights are absent and the require gate is on
    (HDRTVNET_REQUIRE_CLONE_ASSETS, required_clone_assets.py role)."""
    if not env_bool("HDRTVNET_REQUIRE_CLONE_ASSETS", False):
        return
    missing = missing_assets()
    if missing:
        names = ", ".join(f"{a.name} ({a.status})" for a in missing[:8])
        raise RuntimeError(
            f"{len(missing)} required weight file(s) unavailable: {names}. "
            "Populate HDRTVNET_WEIGHTS_ROOT or unset HDRTVNET_REQUIRE_CLONE_ASSETS."
        )
