"""Stereo camera model and inverse/forward projections on torch tensors.

Counterpart of ``srba_slam_tpu/utils/camera.py``: the reference's MRPT
``TStereoCamera`` plus the inverse stereo projection ``projectMatchTo3D``
(reference src/srba-stereo-slam_utils.h:558-574). The camera is a
NamedTuple of Python floats, so the projections take any device's tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class StereoCamera(NamedTuple):
    """Pinhole stereo rig (rectified); every entry is a Python number.

    ``baseline`` is the x-offset of the right camera in the left frame
    (reference demo/config_imgdir_kitti_srba.ini:155 stores it as the first
    element of ``pose_quaternion``).
    """

    fx_l: float
    fy_l: float
    cx_l: float
    cy_l: float
    fx_r: float
    fy_r: float
    cx_r: float
    cy_r: float
    baseline: float
    width: int = 0
    height: int = 0

    @staticmethod
    def kitti() -> "StereoCamera":
        """The KITTI seq-00 calibration from demo/config_imgdir_kitti_srba.ini:138-155."""
        return StereoCamera(
            fx_l=707.0912, fy_l=707.0912, cx_l=601.8873, cy_l=183.1104,
            fx_r=707.0912, fy_r=707.0912, cx_r=601.8873, cy_r=183.1104,
            baseline=0.54, width=1226, height=370,
        )


def project_match_to_3d(ul: torch.Tensor, vl: torch.Tensor, ur: torch.Tensor,
                        cam: StereoCamera) -> torch.Tensor:
    """Inverse stereo projection; batched over any shape of ul/vl/ur.

    Same formula as the reference (src/srba-stereo-slam_utils.h:572-573):
        b_d = baseline / (fl*(cur - ur) + fr*(ul - cul))
        X = b_d*fr*(ul - cul);  Y = b_d*fr*(vl - cvl);  Z = b_d*fl*fr
    Returns [..., 3] points in the LEFT camera frame.
    """
    fl, fr = cam.fx_l, cam.fx_r
    den = fl * (cam.cx_r - ur) + fr * (ul - cam.cx_l)
    # a true division: torch evaluates `scalar / tensor` as a reciprocal
    # times the scalar, which rounds differently from the JAX package
    b_d = torch.full_like(den, cam.baseline) / den
    x = b_d * fr * (ul - cam.cx_l)
    y = b_d * fr * (vl - cam.cy_l)
    z = b_d * fl * fr
    return torch.stack([x, y, z], dim=-1)


def project_stereo(pts: torch.Tensor, cam: StereoCamera, eps: float = 1e-6):
    """Forward stereo projection of points [..., 3] in the left camera frame.

    Returns (ul, vl, ur, vr), each of shape [...] (the reference's
    StereoCamera observation o = {ul, vl, ur, vr}, src/srba-stereo-slam.h:51).
    """
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    zi = 1.0 / torch.clamp(z, min=eps)
    ul = cam.cx_l + cam.fx_l * x * zi
    vl = cam.cy_l + cam.fy_l * y * zi
    ur = cam.cx_r + cam.fx_r * (x - cam.baseline) * zi
    vr = cam.cy_r + cam.fy_r * y * zi
    return ul, vl, ur, vr


def disparity(ul: torch.Tensor, ur: torch.Tensor, cam: StereoCamera) -> torch.Tensor:
    """Generalized disparity fl*(cur-ur) + fr*(ul-cul) (positive for valid depth)."""
    return cam.fx_l * (cam.cx_r - ur) + cam.fx_r * (ul - cam.cx_l)
