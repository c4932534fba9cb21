"""Rendered stereo drives on the card: the benchmark's frames and ground truth.

A torch rewrite of the street scene and camera path of the port's numpy
generator (``utils/synthworld.py`` ``StreetScene``, ``utils/framesource.py``
``SyntheticSource``): the same random draws in the same order from the same
seed, the same geometry, the same 8-bit output, but every pixel computed on
the device in float64, so that a 1,101-frame KITTI log renders in seconds
where the numpy one takes minutes.

* ``texture``: the blob field of ``smooth_texture``. numpy adds the blobs one
  after another into the texture; here each texel gathers the blobs of the
  lattice cells near it and adds them in the same order (the lattice's
  order), in float32, so the texture does not depend on the order in which
  the card schedules its threads.
* ``Drive``: the scene and the path of one log, with its ground-truth poses
  (``[N, 6]`` rotation vector and translation of the left camera in the
  first frame's camera frame, x right, y down, z forward): a straight
  street, or the street bent along a ``Circuit`` (a city block) and driven
  in laps.
* ``Drive.render``: frames ``[n, H, W]`` uint8 for each eye. A camera with
  radial-tangential distortion (EuRoC's raw images) casts each raw pixel
  through the inverse of its distortion, so that the program's undistortion
  map gives back the pinhole image.

Nothing here runs at import, and nothing here imports the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

TEX_SIZE = 2048


# --------------------------------------------------------------- SE(3), numpy
def _hat(w):
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])


def so3_exp(w) -> np.ndarray:
    w = np.asarray(w, np.float64)
    theta = np.linalg.norm(w)
    W = _hat(w)
    if theta < 1e-9:
        return np.eye(3) + W + 0.5 * W @ W
    a = np.sin(theta) / theta
    b = (1.0 - np.cos(theta)) / theta**2
    return np.eye(3) + a * W + b * W @ W


def so3_log(R) -> np.ndarray:
    R = np.asarray(R, np.float64)
    theta = np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0))
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if theta < 1e-9:
        return v / 2.0
    return theta / (2.0 * np.sin(theta)) * v


def compose(a, b) -> np.ndarray:
    Ra, Rb = so3_exp(a[:3]), so3_exp(b[:3])
    return np.concatenate([so3_log(Ra @ Rb), Ra @ np.asarray(b[3:]) + np.asarray(a[3:])])


# ------------------------------------------------------------------- texture
@dataclass
class Layer:
    """One octave of blobs on a lattice of ``ny`` x ``nx`` cells."""

    spacing: int
    rad: int
    lo: int
    jitter: float      # the largest offset of a blob from its cell, in texels
    ny: int
    nx: int
    p: np.ndarray      # float64 [ny * nx, 7]: cy, cx, amp, sx, sy, cos th, sin th


def _layer(rng, h, w, spacing, sigma, amp_lo, amp_hi, jitter_frac, signed=False) -> Layer:
    """The draws of ``smooth_texture``'s ``stamp_layer``, in its order: per
    blob cy, cx, amp, (a sign), sx, sy, th."""
    rad = int(3 * sigma)
    lo = rad + max(spacing // 2, int(np.ceil(spacing * jitter_frac)) + 1)
    ny, nx = len(np.arange(lo, h - lo, spacing)), len(np.arange(lo, w - lo, spacing))
    n = ny * nx
    u = rng.uniform(size=(n, 7 if signed else 6))
    j = spacing * jitter_frac
    y0 = (lo + spacing * np.arange(ny, dtype=np.int64))[:, None].repeat(nx, 1).ravel()
    x0 = (lo + spacing * np.arange(nx, dtype=np.int64))[None, :].repeat(ny, 0).ravel()
    # numpy's uniform(a, b) is a + (b - a) * u
    cy = y0 + (-j + (j - -j) * u[:, 0])
    cx = x0 + (-j + (j - -j) * u[:, 1])
    amp = amp_lo + (amp_hi - amp_lo) * u[:, 2]
    if signed:
        amp = np.where(u[:, 3] < 0.5, -amp, amp)
        u = np.delete(u, 3, axis=1)
    sx = sigma * (0.55 + (1.5 - 0.55) * u[:, 3])
    sy = sigma * (0.55 + (1.5 - 0.55) * u[:, 4])
    th = 0.0 + (np.pi - 0.0) * u[:, 5]
    return Layer(spacing, rad, lo, j, ny, nx,
                 np.stack([cy, cx, amp, sx, sy, np.cos(th), np.sin(th)], -1))


def texture_layers(rng, h=TEX_SIZE, w=TEX_SIZE, spacing=48, sigma=6.0, jitter_frac=1.0 / 3.0,
                   fractal=False) -> list[Layer]:
    """The blob layers of ``smooth_texture(rng, ...)``, drawn from ``rng``."""
    layers = [_layer(rng, h, w, spacing * 4, sigma * 4, 25.0, 60.0, jitter_frac, signed=True),
              _layer(rng, h, w, spacing * 2, sigma * 2, 20.0, 50.0, jitter_frac, signed=True),
              _layer(rng, h, w, spacing, sigma, 40.0, 235.0, jitter_frac)]
    if fractal:
        layers += [_layer(rng, h, w, spacing // 2, sigma / 2, 40.0, 180.0, jitter_frac),
                   _layer(rng, h, w, spacing // 4, sigma / 4, 40.0, 150.0, jitter_frac)]
    return layers


def texture(layers: list[Layer], h: int = TEX_SIZE, w: int = TEX_SIZE, device="cuda",
            rows: int = 128) -> torch.Tensor:
    """The texture f32 [h, w] of ``layers``: 20 plus every blob that covers
    a texel, added in the lattice's order in float32, clipped to 0-255."""
    dev = torch.device(device)
    f64 = torch.float64
    tex = torch.full((h, w), 20.0, dtype=torch.float32, device=dev)
    for ly in layers:
        p = torch.as_tensor(ly.p, device=dev)
        iy, ix = torch.round(p[:, 0]), torch.round(p[:, 1])
        reach = ly.rad + ly.jitter + 1.0
        n_c = int(np.floor(2 * reach / ly.spacing)) + 2
        xs = torch.arange(w, device=dev, dtype=f64)
        i_lo = torch.ceil((xs - reach - ly.lo) / ly.spacing).to(torch.int64)
        for r0 in range(0, h, rows):
            ys = torch.arange(r0, min(r0 + rows, h), device=dev, dtype=f64)
            j_lo = torch.ceil((ys - reach - ly.lo) / ly.spacing).to(torch.int64)
            acc = tex[r0:r0 + len(ys)]
            for a in range(n_c):
                j = (j_lo + a)[:, None]
                for b in range(n_c):
                    i = (i_lo + b)[None, :]
                    ok = (j >= 0) & (j < ly.ny) & (i >= 0) & (i < ly.nx)
                    k = torch.where(ok, j * ly.nx + i, 0)
                    gy = ys[:, None] - iy[k]
                    gx = xs[None, :] - ix[k]
                    ok &= (gy.abs() <= ly.rad) & (gx.abs() <= ly.rad)
                    q = p[k]
                    fy, fx = q[..., 0] - iy[k], q[..., 1] - ix[k]
                    ct, st = q[..., 5], q[..., 6]
                    u = ct * (gx - fx) + st * (gy - fy)
                    v = -st * (gx - fx) + ct * (gy - fy)
                    blob = q[..., 2] * torch.exp(-(u**2 / q[..., 3]**2 + v**2 / q[..., 4]**2) / 2)
                    acc = torch.where(ok, acc + blob.to(torch.float32), acc)
            tex[r0:r0 + len(ys)] = acc
    return torch.clamp(tex, 0.0, 255.0)


# --------------------------------------------------------------------- drive
@dataclass
class Camera:
    """One eye: pinhole intrinsics, the image size, and the
    radial-tangential distortion (k1 k2 p1 p2 k3) of its raw pixels."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)


class Circuit:
    """A closed centre line in the ground plane (y = 0): a city block, the
    rounded rectangle of ``block_m`` = (length along the first heading,
    width) with quarter-circle corners of radius ``corner_m``, driven by
    ``turn`` ("right" or "left") turns: a left block is the right one
    mirrored in x = 0. It starts at the origin heading +z on its first long
    straight; a heading ``psi`` points along (x, z) = (sin psi, cos psi),
    and the right-hand side is (cos psi, -sin psi). Arc length ``s`` runs
    from 0 at the start to ``length``."""

    def __init__(self, block_m, corner_m: float, turn: str = "right"):
        if turn not in ("right", "left"):
            raise ValueError(f"circuit: turn {turn!r} is not 'right' or 'left'")
        self.sign = 1.0 if turn == "right" else -1.0
        long_side, wide_side = (float(v) for v in block_m)
        self.r = r = float(corner_m)
        if not 0.0 < 2 * r <= min(long_side, wide_side):
            raise ValueError(f"circuit: corner {corner_m} m does not fit the block {block_m}")
        a, b = long_side - 2 * r, wide_side - 2 * r
        # the corners' centres: the inner rectangle x in [r, r + b], z in [0, a]
        self.box = (r, r + b, 0.0, a)
        # (start s, length, start x, start z, start heading, arc or straight)
        segs, s, x, z = [], 0.0, 0.0, 0.0
        for k in range(4):
            straight = a if k % 2 == 0 else b
            psi = k * np.pi / 2
            segs.append((s, straight, x, z, psi, False))
            s, x, z = s + straight, x + straight * np.sin(psi), z + straight * np.cos(psi)
            segs.append((s, r * np.pi / 2, x, z, psi, True))
            cx, cz = x + r * np.cos(psi), z - r * np.sin(psi)
            x, z = cx - r * np.cos(psi + np.pi / 2), cz + r * np.sin(psi + np.pi / 2)
            s += r * np.pi / 2
        self.segments, self.length = segs, s

    def at(self, s) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The centre line's x, z and heading at arc lengths ``s`` (taken
        modulo a lap)."""
        s = np.mod(np.asarray(s, np.float64), self.length)
        x, z, psi = np.zeros_like(s), np.zeros_like(s), np.zeros_like(s)
        for s0, span, x0, z0, psi0, arc in self.segments:
            on = (s >= s0) & (s < s0 + span)
            d = s[on] - s0
            if arc:
                cx, cz = x0 + self.r * np.cos(psi0), z0 - self.r * np.sin(psi0)
                turned = psi0 + d / self.r
                x[on] = cx - self.r * np.cos(turned)
                z[on] = cz + self.r * np.sin(turned)
                psi[on] = turned
            else:
                x[on], z[on], psi[on] = x0 + d * np.sin(psi0), z0 + d * np.cos(psi0), psi0
        return self.sign * x, z, self.sign * psi

    def nearest(self, x: float, z: float) -> tuple[float, float, float]:
        """For a point within ``corner_m`` of the centre line: its distance
        to the right of the line, the line's heading at the nearest point,
        and the line's curvature there (1 / ``corner_m`` on a right-hand
        corner, its negative on a left-hand one)."""
        x = self.sign * x
        x0, x1, z0, z1 = self.box
        qx, qz = min(max(x, x0), x1), min(max(z, z0), z1)
        vx, vz = x - qx, z - qz
        d = np.hypot(vx, vz)
        corner = not x0 <= x <= x1 and not z0 <= z <= z1
        return (self.sign * (self.r - d), self.sign * float(np.arctan2(vz / d, -vx / d)),
                self.sign / self.r if corner else 0.0)


def _wrap(a: float) -> float:
    return (a + np.pi) % (2 * np.pi) - np.pi


def path_poses(n_frames: int, seed: int, step: float, keep_lane: bool = False,
               circuit: Circuit | None = None) -> np.ndarray:
    """``SyntheticSource``'s open path: [n_frames, 6] poses of the left
    camera, forward ``step`` metres a frame with sway, yaw and a random walk
    of heading, pitch and roll. With ``keep_lane`` a steering term turns the
    camera back towards the street's centre line (x = 0, y = 0, heading
    +z): over a long log the random walk would otherwise carry it out of
    the row of roadside boards or into the ground (heading noise of 0.002
    rad a frame drifts about 30 m sideways over 1,100 frames at 0.8 m).
    The steering settles in about ten frames and leaves the short-term
    motion as it is.

    On a ``circuit`` the same increments advance along its centre line: the
    line's curvature at the nearest point turns the heading by ``step`` /
    ``corner_m`` a frame on a corner, and ``keep_lane`` steers to that point
    and the line's heading there in place of x = 0 and heading +z."""
    rng = np.random.default_rng(seed + 1)
    poses = [np.zeros(6)]
    noise = rng.normal(size=(max(n_frames - 1, 0), 3))
    gain, pull = 0.2, 0.01 / step
    # the sideways sway, 3 cm a frame at 0.8 m, scales with the step when
    # the lane is kept (a flight at 2 cm a frame sways as a drive does)
    sway = 0.03 * step / 0.8 if keep_lane else 0.03
    for i in range(n_frames - 1):
        inc = np.array([0.002 * noise[i, 0], 0.006 * np.sin(i / 5), 0.002 * noise[i, 1],
                        sway * np.cos(i / 7), 0.004 * noise[i, 2], step])
        R, t = so3_exp(poses[-1][:3]), poses[-1][3:]
        heading, off = np.arctan2(R[0, 2], R[2, 2]), t[0]
        if circuit is not None:
            off, psi, curvature = circuit.nearest(t[0], t[2])
            heading = _wrap(heading - psi)
            inc[1] += curvature * step
        if keep_lane:
            pitch = -np.arcsin(np.clip(R[1, 2], -1.0, 1.0))
            roll = np.arctan2(R[1, 0], R[1, 1])
            inc[0] += pull * t[1] - gain * pitch
            inc[1] -= gain * heading + pull * off
            inc[2] -= gain * roll
        poses.append(compose(poses[-1], inc))
    return np.stack(poses)


class Drive:
    """The street scene and path of one log, from ``seed``: ``n_frames``
    frames ``step`` metres apart, seen by the rig ``eyes`` (left, right)
    with the right eye ``baseline`` metres to the right.

    The street is straight (boards in planes z = ``bz`` facing +z, the path
    along x = 0) or, with ``circuit`` (``{"block_m": [long, wide],
    "corner_m": r}``, and ``"turn": "left"`` for a block driven by left
    turns, :class:`Circuit`), bent along a closed centre line
    and driven in laps: the boards are drawn as on the straight street
    along one lap's arc length (``bz`` is then a board's arc length), each
    standing at its point of the centre line moved ``bx`` to the right, in
    the plane normal to the line there, facing the direction of travel, so
    every lap sees the front of the same boards."""

    def __init__(self, eyes: tuple[Camera, Camera], baseline: float, n_frames: int, seed: int,
                 step: float, device="cuda", keep_lane: bool = True, circuit: dict | None = None):
        self.eyes, self.baseline, self.device = eyes, baseline, torch.device(device)
        self.circuit = None if circuit is None else Circuit(
            circuit["block_m"], circuit["corner_m"], circuit.get("turn", "right"))
        rng = np.random.default_rng(seed)
        texture_layers(rng)          # the ground plane's first texture, replaced below
        self.layers = texture_layers(rng, jitter_frac=1.0, fractal=True)
        if self.circuit is None:
            zs = np.arange(6.0, n_frames * step + 70.0, 4.0)
        else:
            zs = 6.0 + 4.0 * np.arange(int(self.circuit.length // 4.0))
        n = len(zs)
        self.bz = zs + rng.uniform(-1.5, 1.5, n)
        side = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0)
        self.bx = side * rng.uniform(3.5, 9.0, n)
        self.by = rng.uniform(-1.2, 0.6, n)
        self.bs = rng.uniform(0.8, 2.2, n)
        self.bu = rng.uniform(0, TEX_SIZE, n)
        self.bv = rng.uniform(0, TEX_SIZE, n)
        self.bscale = rng.uniform(60.0, 130.0, n)
        self.bmu = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0)
        self.bmv = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0)
        self.poses = path_poses(n_frames, seed, step, keep_lane, self.circuit)
        # each board's centre (x, y, z), its right-hand axis (x, z) and its
        # normal (x, z), both in the ground plane
        if self.circuit is None:
            psi = np.zeros(n)
            self.board_c = np.stack([self.bx, self.by, self.bz], -1)
        else:
            x, z, psi = self.circuit.at(self.bz)
            self.board_c = np.stack([x + self.bx * np.cos(psi), self.by,
                                     z - self.bx * np.sin(psi)], -1)
        self.board_a = np.stack([np.cos(psi), -np.sin(psi)], -1)
        self.board_n = np.stack([np.sin(psi), np.cos(psi)], -1)
        self.tex = texture(self.layers, device=self.device)
        self._tex64 = self.tex.to(torch.float64)
        self._board_params = torch.as_tensor(np.concatenate(
            [self.board_c, self.board_a, self.board_n, np.stack(
                [self.bs, self.bmu, self.bscale, self.bu, self.bmv, self.bv], -1)], -1),
            device=self.device)
        self._rays = [self._unit_rays(e) for e in eyes]

    def _unit_rays(self, eye: Camera) -> torch.Tensor:
        """Per pixel (x, y, 1) in the eye's frame [H, W, 3], float64: the
        pinhole ray, or the ray whose distorted image is that pixel."""
        dev = self.device
        us = torch.arange(eye.width, device=dev, dtype=torch.float64)[None, :].expand(
            eye.height, eye.width)
        vs = torch.arange(eye.height, device=dev, dtype=torch.float64)[:, None].expand(
            eye.height, eye.width)
        x, y = (us - eye.cx) / eye.fx, (vs - eye.cy) / eye.fy
        k1, k2, p1, p2, k3 = (list(eye.dist) + [0.0] * 5)[:5]
        if any((k1, k2, p1, p2, k3)):
            xd, yd = x, y
            for _ in range(20):   # fixed point of the forward model
                r2 = x * x + y * y
                radial = 1.0 + k1 * r2 + k2 * r2**2 + k3 * r2**3
                dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
                dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
                x, y = (xd - dx) / radial, (yd - dy) / radial
        return torch.stack([x, y, torch.ones_like(x)], -1)

    def _boards(self, eye: Camera, R: np.ndarray, origin: np.ndarray):
        """The billboards ``StreetScene.render`` tests for one eye at one
        pose, in its order: (index, x0, x1, y0, y1) of each."""
        w, h = eye.width, eye.height
        # the corners (the first four) and points along the edges: a
        # distorted eye's image of an edge bows, so its box is taken over
        # the points of all four edges
        u = np.linspace(-1.0, 1.0, 9)
        sx = np.concatenate([[-1.0, -1.0, 1.0, 1.0], u, u, -np.ones(9), np.ones(9)])
        sy = np.concatenate([[-1.0, 1.0, -1.0, 1.0], -np.ones(9), np.ones(9), u, u])
        c, a = self.board_c, self.board_a
        along = sx * self.bs[:, None]
        cs = np.stack([c[:, 0, None] + along * a[:, 0, None],
                       c[:, 1, None] + sy * self.bs[:, None],
                       c[:, 2, None] + along * a[:, 1, None]], -1)
        cc = (cs - origin) @ R                                   # [n, m, 3]
        z = cc[..., 2]
        front = (z[:, :4] > 0.1).all(1)
        with np.errstate(divide="ignore", invalid="ignore"):
            x, y = cc[..., 0] / z, cc[..., 1] / z
            if any(eye.dist):
                k1, k2, p1, p2, k3 = (list(eye.dist) + [0.0] * 5)[:5]
                r2 = x * x + y * y
                radial = 1.0 + k1 * r2 + k2 * r2**2 + k3 * r2**3
                x, y = (x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x),
                        y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)
                pts = slice(None)
            else:
                pts = slice(0, 4)      # numpy's box: the four corners
            uc, vc = eye.fx * x[:, pts] + eye.cx, eye.fy * y[:, pts] + eye.cy
            x0 = np.maximum(np.floor(uc.min(1)) - 2, 0)
            x1 = np.minimum(np.ceil(uc.max(1)) + 2, w)
            y0 = np.maximum(np.floor(vc.min(1)) - 2, 0)
            y1 = np.minimum(np.ceil(vc.max(1)) + 2, h)
        # a distorted eye's box holds only where the whole board is in front
        # and inside the field where the model is monotonic
        boxed = front & ((z > 0.1).all(1) if any(eye.dist) else True)
        if any(eye.dist):
            boxed &= (np.abs(cc[..., 0] / z) < 1.2).all(1) & (np.abs(cc[..., 1] / z) < 1.2).all(1)
        keep = ~(z[:, :4] < 0.1).all(1) & ~(boxed & ((x0 >= x1) | (y0 >= y1)))
        return [(int(i), int(x0[i]), int(x1[i]), int(y0[i]), int(y1[i])) if boxed[i]
                else (int(i), 0, w, 0, h) for i in np.nonzero(keep)[0]]

    def _bilinear(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        h, w = self.tex.shape
        u0f, v0f = torch.floor(u), torch.floor(v)
        fu, fv = u - u0f, v - v0f
        u0, v0 = u0f.to(torch.int64) % w, v0f.to(torch.int64) % h
        u1, v1 = (u0 + 1) % w, (v0 + 1) % h
        t = self._tex64
        return (t[v0, u0] * (1 - fu) * (1 - fv) + t[v0, u1] * fu * (1 - fv)
                + t[v1, u0] * (1 - fu) * fv + t[v1, u1] * fu * fv)

    def _render_eye(self, k: int, frames: range) -> torch.Tensor:
        eye, rays = self.eyes[k], self._rays[k]
        dev, f64 = self.device, torch.float64
        n, h, w = len(frames), eye.height, eye.width
        Rs, origins, boards = [], [], []
        for f in frames:
            R = so3_exp(self.poses[f, :3])
            t = self.poses[f, 3:].astype(np.float64)
            origin = t + R @ np.array([self.baseline, 0.0, 0.0]) if k else t
            Rs.append(R)
            origins.append(origin)
            boards.append(self._boards(eye, R, origin))
        R_t = torch.as_tensor(np.stack(Rs), device=dev, dtype=f64)
        o_t = torch.as_tensor(np.stack(origins), device=dev, dtype=f64)
        dirs = torch.einsum("hwj,nij->nhwi", rays, R_t)
        # the ground: the plane y = 1.5 below the first camera
        denom = dirs[..., 1]
        lam_g = (1.5 - o_t[:, 1, None, None]) / torch.where(denom.abs() < 1e-12, 1e-12, denom)
        pts = o_t[:, None, None, :] + lam_g[..., None] * dirs
        # PlaneScene.ground's texture basis: e1 = n x (1,0,0) = (0,0,-1), e2 = n x e1 = (-1,0,0)
        u_t = -pts[..., 2] * 24.0 + TEX_SIZE / 2
        v_t = -pts[..., 0] * 24.0 + TEX_SIZE / 2
        img = self._bilinear(u_t, v_t)
        ok_g = (lam_g > 0.0) & (lam_g < 120.0)
        img = torch.where(ok_g, img, 0.0)
        best = torch.where(ok_g, lam_g, torch.inf)
        # the boards: every (frame, board) pair's box, its pixels laid out
        # one after another, tested together; a pixel takes the nearest hit
        # (the lower board on ties), and only where it is nearer than the
        # ground, as numpy's boards overwrite one after another on a strictly
        # nearer hit
        pairs = np.array([(j, *b) for j, bl in enumerate(boards) for b in bl], np.int64)
        best_i = torch.full((n * h * w,), -1, dtype=torch.int64, device=dev)
        best_lam = best.reshape(-1).clone()
        value = torch.zeros(n * h * w, dtype=f64, device=dev)
        area = (pairs[:, 3] - pairs[:, 2]) * (pairs[:, 5] - pairs[:, 4]) if len(pairs) else None
        lo = 0
        while lo < len(pairs):
            ends = np.cumsum(area[lo:])
            hi = lo + max(1, int(np.searchsorted(ends, self.BOARD_PIXELS, side="right")))
            self._boards_pass(pairs[lo:hi], area[lo:hi], dirs, o_t, h, w, best_lam, best_i, value)
            lo = hi
        img = torch.where((best_i >= 0).reshape(n, h, w), value.reshape(n, h, w), img)
        return torch.clamp(torch.round(img), 0.0, 255.0).to(torch.uint8)

    BOARD_PIXELS = 1 << 23

    def _boards_pass(self, pairs, area, dirs, o_t, h, w, best_lam, best_i, value):
        """Test the pixels of the (frame, board, box) ``pairs`` and merge
        their nearest hits into the running ``best_lam``/``best_i``/``value``."""
        dev, f64 = self.device, torch.float64
        p = torch.as_tensor(pairs, device=dev)
        a = torch.as_tensor(area, device=dev)
        pair = torch.repeat_interleave(torch.arange(len(pairs), device=dev), a)
        local = torch.arange(pair.shape[0], device=dev) - (torch.cumsum(a, 0) - a)[pair]
        q = p[pair]
        bw = q[:, 3] - q[:, 2]
        y, x, fr, bi = q[:, 4] + local // bw, q[:, 2] + local % bw, q[:, 0], q[:, 1]
        d = dirs[fr, y, x]
        o = o_t[fr]
        (cx, cy, cz, ax, az, nx, nz, bs, bmu, bscale, bu, bmv,
         bv) = self._board_params[bi].unbind(1)
        # the ray meets the board's plane; on the straight street (normal +z,
        # right-hand axis +x) the products with 0 and 1 are exact
        dn = d[:, 0] * nx + d[:, 2] * nz
        lam = ((cx - o[:, 0]) * nx + (cz - o[:, 2]) * nz) / torch.where(dn.abs() < 1e-12, 1e-12,
                                                                          dn)
        px = o[:, 0] + lam * d[:, 0]
        py = o[:, 1] + lam * d[:, 1]
        pz = o[:, 2] + lam * d[:, 2]
        across = (px - cx) * ax + (pz - cz) * az
        hit = (lam > 0.1) & (across.abs() <= bs) & ((py - cy).abs() <= bs)
        pix = (fr * h + y) * w + x
        lam_h = torch.where(hit, lam, torch.inf)
        m = torch.full_like(best_lam, torch.inf).scatter_reduce(0, pix, lam_h, "amin")
        cand = hit & (lam_h == m[pix])
        big = torch.iinfo(torch.int64).max
        first = torch.full_like(best_i, big).scatter_reduce(0, pix, torch.where(cand, bi, big),
                                                             "amin")
        win = cand & (bi == first[pix])
        better = win & ((lam < best_lam[pix]) | ((lam == best_lam[pix]) & (bi < best_i[pix])
                                                 & (best_i[pix] >= 0)))
        sel = pix[better]
        best_lam[sel] = lam[better]
        best_i[sel] = bi[better]
        u_b = bmu * across * bscale + bu
        v_b = bmv * (py - cy) * bscale + bv
        value[sel] = self._bilinear(u_b[better], v_b[better])

    def render(self, frames: range) -> tuple[torch.Tensor, torch.Tensor]:
        """Left and right frames uint8 [n, H, W] of the poses ``frames``."""
        return self._render_eye(0, frames), self._render_eye(1, frames)


def render_log(drive: Drive, chunk: int = 32, pin: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Every frame of ``drive`` on the host, (lefts, rights) uint8 [N, H, W],
    in pinned memory where the device is a card."""
    n = len(drive.poses)
    eye = drive.eyes[0]
    pin = pin and drive.device.type == "cuda"
    out = [torch.empty((n, eye.height, eye.width), dtype=torch.uint8, pin_memory=pin)
           for _ in range(2)]
    for f0 in range(0, n, chunk):
        pair = drive.render(range(f0, min(f0 + chunk, n)))
        for dst, src in zip(out, pair):
            dst[f0:f0 + len(src)].copy_(src, non_blocking=pin)
    if pin:
        torch.cuda.synchronize(drive.device)
    return out[0], out[1]
