"""Small geometry/quality statistics and leveled console logging.

Counterpart of ``srba_slam_tpu/utils/stats.py``. ``compute_dispersion`` ≙
the reference's keypoint-dispersion statistic
(src/srba-stereo-slam_utils.h:534-556: the square root of the sum of squared
deviations of the matched keypoint coordinates, not divided by N).
``VerboseLogger`` ≙ the VERBOSE_LEVEL console macro
(src/srba-stereo-slam_common.h:86).
"""

from __future__ import annotations

import torch


def compute_dispersion(xs: torch.Tensor, ys: torch.Tensor, valid: torch.Tensor):
    """(std_x, std_y) of the valid matched keypoints, the reference's
    formula (sqrt of the sum of squared deviations, NOT divided by N)."""
    w = valid.to(torch.float32)
    n = torch.clamp(torch.sum(w), min=1.0)
    x = xs.to(torch.float32)
    y = ys.to(torch.float32)
    mx = torch.sum(x * w) / n
    my = torch.sum(y * w) / n
    sx = torch.sqrt(torch.sum(((x - mx) ** 2) * w))
    sy = torch.sqrt(torch.sum(((y - my) ** 2) * w))
    return sx, sy


class VerboseLogger:
    """Leveled console logging (0 none / 1 important / 2 chatty)."""

    def __init__(self, level: int = 0):
        self.level = level

    def __call__(self, level: int, msg: str):
        if self.level >= level:
            print(f"[srba_slam_tpu_torch] {msg}", flush=True)
