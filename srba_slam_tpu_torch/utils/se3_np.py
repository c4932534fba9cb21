"""Pure-numpy mirror of the SE(3) 6-vector algebra in ``se3``.

Host-side graph bookkeeping (spanning trees, pose composition along paths,
global-pose refresh after optimization) touches hundreds of tiny 6-vectors;
dispatching each through JAX would cost a device round-trip per op. These
numpy twins are bit-compatible (same [wx wy wz tx ty tz] layout, float64
internally for stability) and exist only for host logic — device code uses
``srba_slam_tpu.utils.se3``.
"""

from __future__ import annotations

import numpy as np


def hat(w: np.ndarray) -> np.ndarray:
    return np.array(
        [[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]]
    )


def so3_exp(w: np.ndarray) -> np.ndarray:
    w = np.asarray(w, np.float64)
    theta = np.linalg.norm(w)
    W = hat(w)
    if theta < 1e-9:
        return np.eye(3) + W + 0.5 * W @ W
    a = np.sin(theta) / theta
    b = (1.0 - np.cos(theta)) / theta**2
    return np.eye(3) + a * W + b * W @ W


def so3_log(R: np.ndarray) -> np.ndarray:
    R = np.asarray(R, np.float64)
    tr = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(tr)
    if theta < 1e-9:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2.0
    if theta > np.pi - 1e-6:
        # near pi: use the symmetric part
        A = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diag(A), 0.0))
        # fix signs from off-diagonals
        if axis[0] > 0:
            axis[1] = np.copysign(axis[1], A[0, 1])
            axis[2] = np.copysign(axis[2], A[0, 2])
        elif axis[1] > 0:
            axis[2] = np.copysign(axis[2], A[1, 2])
        axis /= max(np.linalg.norm(axis), 1e-12)
        return axis * theta
    return (
        theta
        / (2.0 * np.sin(theta))
        * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    )


def exp(xi: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    xi = np.asarray(xi, np.float64)
    return so3_exp(xi[:3]), xi[3:].copy()


def log(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    return np.concatenate([so3_log(R), np.asarray(t, np.float64)])


def compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    Ra, ta = exp(a)
    Rb, tb = exp(b)
    return log(Ra @ Rb, Ra @ tb + ta)


def inverse(a: np.ndarray) -> np.ndarray:
    Ra, ta = exp(a)
    return log(Ra.T, -Ra.T @ ta)


def relative(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pose of `a` as seen from frame `b` (== inverse(b) ⊕ a)."""
    return compose(inverse(b), a)


def transform_point(pose: np.ndarray, p: np.ndarray) -> np.ndarray:
    R, t = exp(pose)
    return R @ np.asarray(p, np.float64) + t


def from_xyz_ypr(x: float, y: float, z: float, yaw: float, pitch: float,
                 roll: float) -> np.ndarray:
    """6-vector pose from MRPT ``CPose3D(x, y, z, yaw, pitch, roll)``
    (angles in RADIANS; R = Rz(yaw) Ry(pitch) Rx(roll))."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    R = np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ])
    return log(R, np.array([x, y, z], np.float64))


def conjugate(pose: np.ndarray, by: np.ndarray) -> np.ndarray:
    """``by ∘ pose ∘ by^-1`` — re-express a transform in another frame."""
    return compose(compose(by, pose), inverse(by))


# ---------------------------------------------------------------- batched
# Vectorized twins over leading axes (host graph bookkeeping touches
# hundreds of 6-vectors per keyframe insertion; per-item python calls cost
# ~40 us each and dominated insertion host time).

def hat_batch(w: np.ndarray) -> np.ndarray:
    w = np.asarray(w, np.float64)
    out = np.zeros(w.shape[:-1] + (3, 3))
    out[..., 0, 1] = -w[..., 2]; out[..., 0, 2] = w[..., 1]
    out[..., 1, 0] = w[..., 2]; out[..., 1, 2] = -w[..., 0]
    out[..., 2, 0] = -w[..., 1]; out[..., 2, 1] = w[..., 0]
    return out


def so3_exp_batch(w: np.ndarray) -> np.ndarray:
    w = np.asarray(w, np.float64)
    theta = np.linalg.norm(w, axis=-1)
    W = hat_batch(w)
    W2 = W @ W
    small = theta < 1e-9
    th = np.where(small, 1.0, theta)
    a = np.where(small, 1.0, np.sin(th) / th)[..., None, None]
    b = np.where(small, 0.5, (1.0 - np.cos(th)) / th**2)[..., None, None]
    return np.eye(3) + a * W + b * W2


def so3_log_batch(R: np.ndarray) -> np.ndarray:
    """Batched so3_log; falls back to the scalar path near theta = pi."""
    R = np.asarray(R, np.float64)
    tr = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(tr)
    v = 0.5 * np.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
         R[..., 1, 0] - R[..., 0, 1]], axis=-1)
    small = theta < 1e-9
    th = np.where(small, 1.0, theta)
    scale = np.where(small, 1.0, th / np.maximum(np.sin(th), 1e-12))
    out = v * scale[..., None]
    near_pi = theta > np.pi - 1e-6
    if np.any(near_pi):
        idx = np.nonzero(near_pi.ravel())[0]
        flat = out.reshape(-1, 3)
        Rf = R.reshape(-1, 3, 3)
        for i in idx:
            flat[i] = so3_log(Rf[i])
        out = flat.reshape(out.shape)
    return out


def exp_batch(xi: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    xi = np.asarray(xi, np.float64)
    return so3_exp_batch(xi[..., :3]), xi[..., 3:].copy()


def log_batch(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    return np.concatenate([so3_log_batch(R), np.asarray(t, np.float64)], axis=-1)


def compose_batch(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    Ra, ta = exp_batch(a)
    Rb, tb = exp_batch(b)
    return log_batch(Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta)


def inverse_batch(a: np.ndarray) -> np.ndarray:
    Ra, ta = exp_batch(a)
    RaT = np.swapaxes(Ra, -1, -2)
    return log_batch(RaT, -(RaT @ ta[..., None])[..., 0])


def relative_batch(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pose of each `a` as seen from each frame `b`."""
    Ra, ta = exp_batch(a)
    Rb, tb = exp_batch(b)
    RbT = np.swapaxes(Rb, -1, -2)
    return log_batch(RbT @ Ra, (RbT @ (ta - tb)[..., None])[..., 0])


def transform_points(pose: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply one pose to [N, 3] points."""
    R, t = exp(pose)
    return np.asarray(pts, np.float64) @ R.T + t


def transform_points_by_pose(poses: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply pose i to point i ([N, 6] x [N, 3] -> [N, 3])."""
    R, t = exp_batch(poses)
    return (R @ np.asarray(pts, np.float64)[..., None])[..., 0] + t
