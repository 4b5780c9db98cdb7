"""Where the port builds its native code at first use: ``build/<name>`` at
the root of the checkout (``.gitignore`` lists ``build/``)."""

from __future__ import annotations

import os

__all__ = ["build_dir"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_dir(name: str) -> str:
    """``build/<name>`` under the checkout root, created if missing."""
    path = os.path.join(_ROOT, "build", name)
    os.makedirs(path, exist_ok=True)
    return path
