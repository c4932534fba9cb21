"""Dynamic keyframe-creation threshold schedules.

Bit-level re-implementations of the reference's pure functions
(src/srba-stereo-slam_utils.cpp:153-171). These run on host (they gate the
data-dependent keyframe decision) so they are plain floats, not traced.
"""

from __future__ import annotations


def update_translation_threshold(x: float, th: float) -> float:
    """newTh = clamp(0.02 + (0.25/th)*x, 0.02, 0.3)  (utils.cpp:153-161)."""
    new_th = 0.02 + (0.25 / th) * x
    return min(max(new_th, 0.02), 0.3)


def update_rotation_threshold(x: float, th: float) -> float:
    """newTh = clamp(15 + 13/th*(x - th), 2, 15)  (utils.cpp:163-171)."""
    new_th = 15.0 + 13.0 / th * (x - th)
    return min(max(new_th, 2.0), 15.0)
