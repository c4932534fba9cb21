"""Leveled console logging.

Counterpart of ``srba_slam_tpu/utils/stats.py``'s ``VerboseLogger``
(≙ the VERBOSE_LEVEL console macro, src/srba-stereo-slam_common.h:86).
"""

from __future__ import annotations


class VerboseLogger:
    """Leveled console logging (0 none / 1 important / 2 chatty)."""

    def __init__(self, level: int = 0):
        self.level = level

    def __call__(self, level: int, msg: str):
        if self.level >= level:
            print(f"[srba_slam_tpu_torch] {msg}", flush=True)
