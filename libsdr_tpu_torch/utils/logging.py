"""Leveled logging (copied from ``libsdr_tpu.utils.logging``): one logger
tree under ``libsdr_tpu_torch`` with a stderr stream handler."""

from __future__ import annotations

import logging
import sys

_ROOT = "libsdr_tpu_torch"
_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s", "%H:%M:%S"))
        root.addHandler(h)
    root.setLevel(logging.WARNING)
    _configured = True


def get_logger(name: str) -> logging.Logger:
    _configure()
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)


def set_level(level) -> None:
    """Set the framework log level (DEBUG/INFO/WARNING/ERROR)."""
    _configure()
    logging.getLogger(_ROOT).setLevel(level)
