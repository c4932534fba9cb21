"""SE(3) / SO(3) algebra on float32 torch tensors.

Counterpart of ``srba_slam_tpu/utils/se3.py`` (the MRPT ``CPose3DRotVec``
algebra the reference uses, src/srba-stereo-slam_common.h:58-72). Poses are
6-vectors ``[wx wy wz tx ty tz]`` (rotation vector + translation) or
``(R, t)`` pairs; every function is batched over leading dimensions and
branch-free (``torch.where``), so it runs the same on any device.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 matrix product (full float32: the port never enables TF32)."""
    return torch.einsum("...ij,...jk->...ik", a, b)


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector. Batched over leading dims."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: rotation vector -> rotation matrix. Batched."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]  # [...,1,1]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    W = hat(w)
    W2 = _mm(W, W)
    small = theta2 < 1e-12
    # sin(t)/t and (1-cos t)/t^2 with Taylor fallbacks
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a * W + b * W2


def quat_from_rotmat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion [w,x,y,z] with w >= 0. Batched.

    Branch-free Shepperd's method: all four candidate quaternions, selected
    by the largest of (trace, R00, R11, R22).
    """
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = r00 + r11 + r22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    s0 = safe_sqrt(1.0 + tr) * 2.0
    q0 = torch.stack([0.25 * s0, (r21 - r12) / s0, (r02 - r20) / s0, (r10 - r01) / s0], dim=-1)
    s1 = safe_sqrt(1.0 + r00 - r11 - r22) * 2.0
    q1 = torch.stack([(r21 - r12) / s1, 0.25 * s1, (r01 + r10) / s1, (r02 + r20) / s1], dim=-1)
    s2 = safe_sqrt(1.0 - r00 + r11 - r22) * 2.0
    q2 = torch.stack([(r02 - r20) / s2, (r01 + r10) / s2, 0.25 * s2, (r12 + r21) / s2], dim=-1)
    s3 = safe_sqrt(1.0 - r00 - r11 + r22) * 2.0
    q3 = torch.stack([(r10 - r01) / s3, (r02 + r20) / s3, (r12 + r21) / s3, 0.25 * s3], dim=-1)

    cond1 = (r00 > r11) & (r00 > r22)
    cond2 = r11 > r22
    q_not0 = torch.where(cond1[..., None], q1, torch.where(cond2[..., None], q2, q3))
    q = torch.where((tr > 0.0)[..., None], q0, q_not0)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    # canonicalize sign: w >= 0
    return q * torch.where(q[..., :1] < 0.0, -1.0, 1.0)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> rotation vector, via the quaternion (exact at
    theta -> 0, well-behaved near theta -> pi). Batched."""
    q = quat_from_rotmat(R)
    qw = q[..., 0]
    qv = q[..., 1:]
    nv = torch.linalg.vector_norm(qv, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(nv, qw[..., None])
    scale = torch.where(nv < 1e-9, 2.0 / torch.clamp(qw[..., None], min=_EPS),
                        theta / torch.clamp(nv, min=_EPS))
    return qv * scale


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros(6, dtype=dtype, device=device)


def exp(xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pose 6-vector -> (R, t). Like MRPT's CPose3DRotVec, the translation is
    stored directly (not the se(3) exponential of a twist)."""
    return so3_exp(xi[..., :3]), xi[..., 3:]


def log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> pose 6-vector [rotvec, t]."""
    return torch.cat([so3_log(R), t], dim=-1)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pose composition a ⊕ b (point maps: x_w = Ra (Rb x + tb) + ta)."""
    Ra, ta = exp(a)
    Rb, tb = exp(b)
    R = _mm(Ra, Rb)
    t = torch.einsum("...ij,...j->...i", Ra, tb) + ta
    return log(R, t)


def inverse(a: torch.Tensor) -> torch.Tensor:
    """Pose inverse on 6-vectors."""
    Ra, ta = exp(a)
    Rinv = torch.swapaxes(Ra, -1, -2)
    tinv = -torch.einsum("...ij,...j->...i", Rinv, ta)
    return log(Rinv, tinv)


def relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a ⊖ b = inverse(b) ⊕ a: the pose of ``a`` as seen from frame ``b``
    (MRPT ``inverseComposeFrom``, reference src/srba-stereo-slam.h:203)."""
    return compose(inverse(b), a)


def transform_points(pose: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply pose to points: R @ p + t. pts [..., N, 3], pose [..., 6]."""
    R, t = exp(pose)
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def inverse_transform_points(pose: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply pose^-1 to points."""
    R, t = exp(pose)
    return torch.einsum("...ji,...nj->...ni", R, pts - t[..., None, :])


def ypr_from_rotmat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> [yaw, pitch, roll] (ZYX convention, MRPT order),
    as the ``out_kf_poses.txt`` dump writes them (reference
    src/CSRBAStereoSLAMEstimator.cpp:977-987)."""
    pitch = torch.atan2(-R[..., 2, 0], torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2))
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([yaw, pitch, roll], dim=-1)


def rotmat_from_ypr(ypr: torch.Tensor) -> torch.Tensor:
    """[yaw, pitch, roll] -> rotation matrix (ZYX)."""
    y, p, r = ypr[..., 0], ypr[..., 1], ypr[..., 2]
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotation_angle(pose_or_rotvec: torch.Tensor) -> torch.Tensor:
    """Magnitude of the rotation (radians) of a 6-vector pose or a 3-vector
    rotation vector."""
    return torch.linalg.vector_norm(pose_or_rotvec[..., :3], dim=-1)


def translation_norm(pose: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(pose[..., 3:6], dim=-1)
