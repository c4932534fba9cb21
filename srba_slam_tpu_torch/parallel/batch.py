"""Many stereo sequences through one VO step over a mesh of devices.

Counterpart of ``srba_slam_tpu/parallel/batch.py``. The JAX package places
a leading batch of sequences across a device mesh (``make_mesh``,
``shard_batch``) and lets XLA partition the step. Here a ``Mesh`` is an
ordered tuple of torch devices along one named axis: the machine's cards
(``make_mesh(n)``), or an explicit list (``make_mesh(devices=...)``) that
may repeat a device, the virtual mesh on which the CPU tests and a machine
with one card run the sharded paths. ``shard_batch`` splits a batch's
leading dimension into one contiguous chunk per device, and
``gather_batch`` puts the chunks back together on the lead device.

``batched_vo_step`` runs each shard's sequences on its device: the frontend
of the shard's 2B' images as one batch (one K1 and one K2 launch), and
their frame-to-frame tracking and pose solve as one ``track_and_solve`` of
B' lanes (≙ JAX's ``_batched_step`` on one shard). The fleet means are
reduced on the lead device, the shards summed in shard order: JAX's mesh
is one controller in one process, and a collective's order of sums would
depend on its algorithm (ROADMAP: reductions are deterministic).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srba_slam_tpu_torch.models.vo import (
    FrameFeatures, extract_and_match_batch, stack_features, track_and_solve,
)
from srba_slam_tpu_torch.utils.camera import StereoCamera

BATCH_AXIS = "batch"


class Mesh(NamedTuple):
    """Devices along one named axis (≙ a one-axis ``jax.sharding.Mesh``);
    ``len(mesh.devices)`` is JAX's ``mesh.devices.size``. The first device
    leads: reductions and replicated solves run there. A device may appear
    more than once (a virtual mesh): its shards then run one after the
    other on one card, so its wall time says nothing of scaling."""

    devices: tuple[torch.device, ...]
    axis: str = BATCH_AXIS

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    @property
    def distinct(self) -> bool:
        """Whether no device repeats."""
        return len(set(self.devices)) == len(self.devices)


def canonical_device(device) -> torch.device:
    """``device`` as one torch.device for each device: ``"cuda"`` is the
    current card with its index, and the CPU has none."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu") if dev.type == "cpu" else dev


def make_mesh(n_devices: int | None = None, devices=None, axis: str = BATCH_AXIS) -> Mesh:
    """A mesh of ``devices`` (an explicit list; repeats allowed), or of the
    machine's first ``n_devices`` cards (all of them by default). Without
    a card and without ``devices`` it raises: no mesh falls back to the
    CPU."""
    if devices is not None:
        devs = tuple(canonical_device(d) for d in devices)
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"n_devices {n_devices} but {len(devs)} devices given")
    else:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA card (pass devices= for a mesh of "
                               "explicit devices)")
        n = count if n_devices is None else n_devices
        if not 1 <= n <= count:
            raise ValueError(f"make_mesh: {n} devices asked, the machine has {count} cards")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    if not devs:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return Mesh(devs, axis)


def fleet_mesh(n_items: int, device) -> Mesh:
    """JAX's default mesh for a batch of ``n_items`` (``FleetSLAM``, the
    CLI's ``--fleet``): the largest count of the machine's cards that
    divides ``n_items``, since a batch splits into equal chunks. A count
    of 1 is ``device`` alone, and so is a ``device`` that is no card."""
    dev = canonical_device(device)
    if dev.type != "cuda":
        return make_mesh(devices=[dev])
    n_dev = torch.cuda.device_count()
    n = max(d for d in range(1, min(n_dev, n_items) + 1) if n_items % d == 0)
    return make_mesh(n) if n > 1 else make_mesh(devices=[dev])


def _tree_map(fn, *trees):
    """``fn`` over the leaves of equally shaped trees of tuples, named
    tuples and lists; None stays None."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, (tuple, list)):
        out = [_tree_map(fn, *parts) for parts in zip(*trees)]
        return type(t0)(*out) if hasattr(t0, "_fields") else type(t0)(out)
    return fn(*trees)


def shard_batch(mesh: Mesh, tree) -> list:
    """Split the leading dimension of every leaf of ``tree`` (tensors or
    arrays) into ``len(mesh.devices)`` equal contiguous chunks; returns one
    tree per device, its chunks on that device. Raises where a leading
    dimension does not divide, as ``NamedSharding`` does."""
    n = len(mesh.devices)

    def chunk(x, i: int, dev: torch.device):
        t = torch.as_tensor(x)
        if t.shape[0] % n:
            raise ValueError(f"a batch of {t.shape[0]} does not split over a mesh of {n} "
                             "devices")
        m = t.shape[0] // n
        return t[i * m:(i + 1) * m].to(dev)

    return [_tree_map(lambda x, i=i, d=d: chunk(x, i, d), tree)
            for i, d in enumerate(mesh.devices)]


def gather_batch(mesh: Mesh, shards: list):
    """Inverse of :func:`shard_batch`: the shards' trees concatenated leaf
    by leaf, in shard order, on the lead device."""
    return _tree_map(lambda *xs: torch.cat([x.to(mesh.lead) for x in xs]), *shards)


def batched_vo_step(mesh: Mesh, lefts, rights, prev: FrameFeatures, init_pose,
                    cam: StereoCamera, fast_th: float = 20.0, orb_th: int = 60, k: int = 256,
                    cell: int = 5):
    """One VO step for B sequences at once, sharded over ``mesh``: extract
    and stereo-match each sequence's pair (``lefts``/``rights`` [B, H, W]),
    track it against its previous frame (``prev``, FrameFeatures stacked
    along B) from ``init_pose`` [B, 6], and solve its pose. B must divide
    over the mesh. Every shard's frontend is enqueued before any pose
    solve. Returns ``(cur, poses, valid, fleet_mean_residual,
    fleet_valid_fraction)`` on the lead device: the stacked features, the
    per-sequence increments [B, 6] and validity [B], and the two fleet-wide
    means."""
    th = float(np.float32(fast_th))
    shards = shard_batch(mesh, (lefts, rights, prev, init_pose))
    curs = [stack_features(extract_and_match_batch(l, r, cam, th, int(orb_th), k=k, cell=cell,
                                                   device=dev))
            for dev, (l, r, _p, _i) in zip(mesh.devices, shards)]
    outs = [track_and_solve(p, cur, cam, init.to(torch.float32), int(orb_th)).pose
            for cur, (_l, _r, p, init) in zip(curs, shards)]
    res_sum = valid_sum = None
    for out in outs:  # shard order, on the lead device
        r = out.mean_residual.sum().to(mesh.lead)
        v = out.valid.to(torch.float32).sum().to(mesh.lead)
        res_sum, valid_sum = (r, v) if res_sum is None else (res_sum + r, valid_sum + v)
    b = sum(out.valid.shape[0] for out in outs)
    return (gather_batch(mesh, curs), gather_batch(mesh, [o.pose for o in outs]),
            gather_batch(mesh, [o.valid for o in outs]), res_sum / b, valid_sum / b)


def empty_features(batch: int, k: int, device="cuda") -> FrameFeatures:
    """A valid all-empty FrameFeatures batch (for the first frame)."""
    z_i = torch.zeros((batch, k), dtype=torch.int32, device=device)
    z_b = torch.zeros((batch, k), dtype=torch.bool, device=device)
    return FrameFeatures(
        ys_l=z_i, xs_l=z_i, score_l=torch.zeros((batch, k), dtype=torch.float32, device=device),
        valid_l=z_b, desc_l=torch.zeros((batch, k, 8), dtype=torch.int32, device=device),
        ys_r=z_i, xs_r=z_i, valid_r=z_b,
        desc_r=torch.zeros((batch, k, 8), dtype=torch.int32, device=device),
        m_r_idx=z_i, m_valid=z_b,
        pts3d=torch.zeros((batch, k, 3), dtype=torch.float32, device=device),
        octave=z_i,
    )
