"""The host's launches in one call of each of the parallel layer's programs
against the same call made eagerly, under torch.profiler.

A fleet steps over its sequences with its programs on (``parallel/batch.py``
``FLEET_GRAPHS``), recording its first lockstep attempt with every
sequence of a shard pending and its largest check group; then each of the
two is called again, and ``batched_vo_step`` over the sequences' second
frames on a mesh of the card repeated once a sequence, eagerly
(``FLEET_GRAPHS`` off) first and as programs last, each call traced alone
(``utils/kernel_timing.py`` ``profile_calls``, after an untraced call):
the kernel launches, graph launches and copies the host issues. A program
call of an attempt or a check group should launch no kernel and one graph;
a batched step one graph a shard, and beside them the kernels of the
cross-shard gather and means on the lead device. Traces of captured
programs can upset later profiler sessions in the process (ROADMAP Queue
3), so the eager calls are traced first and this runs in a process of its
own. Run from the root of the repository on a card:

    python -m srba_slam_tpu_torch.tools.fleet_launches --seeds 11,48,85,122 --frames 8

(the bench workload's estimator on its street scene, one vocabulary
trained as the CLI's ``--fleet`` trains it; ~1 min). Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from srba_slam_tpu_torch.models.vo import stack_features
from srba_slam_tpu_torch.ops import cuda_graphs
from srba_slam_tpu_torch.parallel import batch
from srba_slam_tpu_torch.parallel.fleet import FleetSLAM
from srba_slam_tpu_torch.utils import kernel_timing as kt

KINDS = ("fleet_attempt", "fleet_check", "batched_step")


def _counts(fn) -> list[int]:
    """Kernel launches, graph launches and copies of one call of ``fn``."""
    evs = kt.profile_calls(fn)
    return [kt.launch_count(evs), sum(e.count for e in evs if "GraphLaunch" in e.key),
            sum(e.count for e in evs if e.key == "cudaMemcpyAsync")]


def record_calls(flt: FleetSLAM) -> tuple[dict, tuple]:
    """Wrap ``flt``'s ``_attempt`` and ``_check_group`` so that each call's
    arguments are appended to ``rec["attempts"]`` and ``rec["checks"]`` (a
    check group's list copied); returns ``(rec, (the unwrapped _attempt,
    _check_group))``, whose calls on the recorded arguments repeat them."""
    attempt, check_group = flt._attempt, flt._check_group
    rec = {"attempts": [], "checks": []}

    def record_attempt(*a):
        rec["attempts"].append(a)
        return attempt(*a)

    def record_check(s, opts, group):
        rec["checks"].append((s, opts, list(group)))
        return check_group(s, opts, group)

    flt._attempt, flt._check_group = record_attempt, record_check
    return rec, (attempt, check_group)


def measure(ests: list, seqs: list) -> dict:
    """Step ``FleetSLAM(ests)`` over ``seqs`` (lists of (left, right) frames,
    one a sequence) with the programs on, then count the launches of its
    first attempt with a whole shard pending, its largest check group and
    ``batched_vo_step``, eager and as programs. Returns {"attempt eager":
    [kernels, graphs, copies], ..., "attempt n", "check q", "shards",
    "captures"}."""
    flt = FleetSLAM(ests)
    rec, (attempt, check_group) = record_calls(flt)
    flt.run(seqs)
    a_args = next(a for a in rec["attempts"] if len(a[1]) == len(flt.shards[a[0]]))
    c_args = max(rec["checks"], key=lambda c: len(c[2]))
    e0 = ests[0]
    dev = e0.device
    mesh = batch.make_mesh(devices=[dev] * len(ests))
    lefts = np.stack([s[1][0] for s in seqs])
    rights = np.stack([s[1][1] for s in seqs])
    prev = stack_features([e.vo.last_frame() for e in ests])
    init = torch.zeros((len(ests), 6), device=dev)
    calls = {
        "attempt": lambda: attempt(*a_args),
        "check": lambda: check_group(*c_args),
        "step": lambda: batch.batched_vo_step(mesh, lefts, rights, prev, init, e0.cam,
                                              torch.full((), 20.0, device=dev),
                                              torch.full((), 60.0, device=dev),
                                              k=e0.capacity),
    }
    out = {}
    try:
        for route in ("eager", "program"):
            batch.FLEET_GRAPHS = route == "program"
            for name, fn in calls.items():
                out[f"{name} {route}"] = _counts(fn)
    finally:
        batch.FLEET_GRAPHS = True
    out.update({"attempt n": len(a_args[1]), "check q": len(c_args[2]),
                "shards": len(mesh.devices),
                "captures": {k: cuda_graphs.capture_stats(k)["captures"] for k in KINDS}})
    return out


def main(argv=None) -> int:
    from srba_slam_tpu_torch.models.estimator import bench_estimator
    from srba_slam_tpu_torch.utils import bench_workload as bw
    from srba_slam_tpu_torch.utils.camera import StereoCamera
    from srba_slam_tpu_torch.utils.framesource import SyntheticSource

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="11,48,85,122",
                    help="the street sequences' seeds, one a sequence")
    ap.add_argument("--frames", type=int, default=8, help="frames a sequence")
    args = ap.parse_args(argv)
    cam = StereoCamera.kitti()
    seeds = [int(s) for s in args.seeds.split(",")]
    scratch = bench_estimator("cuda")
    n_voc = max(1, scratch.opts.voc_train_frames)
    seqs = [list(SyntheticSource(cam, n_frames=max(args.frames, n_voc if i == 0 else 0),
                                 seed=seed, step=bw.SOURCE["step"], scene=bw.SOURCE["scene"]))
            for i, seed in enumerate(seeds)]
    for left, right in seqs[0][:n_voc]:
        scratch.step(left, right)
    scratch.ensure_vocabulary()
    ests = []
    for _ in seeds:
        est = bench_estimator("cuda")
        est.initialize(vocabulary=scratch.bow.voc)
        ests.append(est)
    print(json.dumps(measure(ests, [s[:args.frames] for s in seqs])))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
