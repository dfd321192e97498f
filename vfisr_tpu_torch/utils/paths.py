"""Repo-anchored artifact paths (port of ``vfisr_tpu/utils/paths.py``).

Default weight lookups check the working directory first, then the repo
root, so auto-loading works whatever the caller's working directory.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

REPO_ROOT = Path(__file__).resolve().parents[2]


def default_weights(name: str) -> Optional[str]:
    """Path to ``weights/<name>.npz`` if it exists, else None."""
    for base in (Path.cwd(), REPO_ROOT):
        p = base / "weights" / f"{name}.npz"
        if p.exists():
            return str(p)
    return None
