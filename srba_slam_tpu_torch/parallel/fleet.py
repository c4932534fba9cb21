"""Several independent SLAM runs in frame lockstep over a mesh of devices.

Counterpart of ``srba_slam_tpu/parallel/fleet.py``. ``FleetSLAM`` advances S
sequences one frame at a time together (multi-run evaluation, parameter
sweeps, fleet replay; the reference app runs one sequence, single-threaded).
The S sequences are sharded over a mesh (``parallel/batch.py``): sequence
``i`` lives on ``mesh.devices[i // (S // n)]`` for a mesh of n devices, and
its estimator was built there. The default mesh is JAX's: the largest
count of the machine's cards that divides S (one card: the whole fleet on
it).

* the frontend of each shard's sequences is one ``extract_and_match_batch``
  over their images on the shard's device, each sequence at its own
  adaptive FAST/ORB thresholds (K1 takes one threshold per image): one K1
  and one K2 launch per shard per attempt. The low-match retry protocol
  (reference src/CSRBAStereoSLAMEstimator.cpp:263-315) runs per sequence,
  fleet-wide: the sequences whose matches fell short go through the
  frontend again together, at most 6 attempts;
* the tracking and pose solve of a shard's sequences in an attempt is one
  ``solve_pose`` of one lane per sequence (``models/vo.py``
  ``solve_tracks``; ≙ JAX's ``_build_vo_prog``), and its outputs come to the
  host in one copy per shard;
* the keyframe checks of a shard's sequences that check this step are one
  batched ``query_and_associate`` over their stacked keyframe stores and
  BoW databases, lanes = (sequence, candidate) (≙ JAX's
  ``_build_qa_prog``); only the checking sequences advance their DA seeds;
* every shard's frontends, and every shard's checks, are enqueued before
  the host reads any of their outputs, so distinct cards overlap;
* every sequence's host bookkeeping goes through its own estimator's
  methods, the single copy that per-frame stepping uses: the retry protocol
  ``adaptive_vo``, the VO engine's ``commit_frame`` (IDs), and the walk's
  head (pose, triggers) and tail (the keyframe decision). So a fleet run
  makes each sequence's solo decisions, on any mesh;
* each estimator schedules its window solves as it does alone (pipelined
  by default): its launched solves ride its check's read and commit
  there. (The JAX fleet commits every sequence's solves at any check of
  the step; a sequence that does not check keeps its solves in flight
  here, so its poses stay its solo run's.)
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from srba_slam_tpu_torch.models.data_association import query_and_associate
from srba_slam_tpu_torch.models.estimator import SRBAStereoSLAMEstimator, StepResult
from srba_slam_tpu_torch.models.keyframe import KFArrays
from srba_slam_tpu_torch.models.vo import (
    FrameFeatures, commit_tracks, extract_and_match_batch, solve_tracks, stack_features,
    to_host,
)
from srba_slam_tpu_torch.ops import prng
from srba_slam_tpu_torch.parallel.batch import Mesh, canonical_device, fleet_mesh


class FleetSLAM:
    """Lockstep multi-sequence SLAM with a batched frontend, pose solve
    and keyframe check per shard of a device mesh."""

    def __init__(self, estimators: list[SRBAStereoSLAMEstimator], mesh: Mesh | None = None):
        assert estimators, "need at least one estimator"
        self.ests = estimators
        e0 = estimators[0]
        for e in estimators[1:]:
            assert e.capacity == e0.capacity and e.max_kfs == e0.max_kfs, \
                "fleet sequences must share capacities"
            assert e.cam == e0.cam and e.vo_opts == e0.vo_opts, \
                "fleet sequences share one frontend: camera and VO options"
        self.mesh = fleet_mesh(len(estimators), e0.device) if mesh is None else mesh
        n = len(self.mesh.devices)
        if len(estimators) % n:
            raise ValueError(f"{len(estimators)} sequences do not split over a mesh of {n} "
                             "devices")
        per = len(estimators) // n
        self.shards = [list(range(s * per, (s + 1) * per)) for s in range(n)]
        for dev, shard in zip(self.mesh.devices, self.shards):
            assert all(canonical_device(estimators[i].device) == dev for i in shard), \
                f"the estimators of a shard live on its device {dev}"
        self._shard_of = {i: s for s, shard in enumerate(self.shards) for i in shard}

    def run(self, sources, max_frames: int | None = None):
        """Drive S frame sources in lockstep until the shortest is
        exhausted (or ``max_frames``)."""
        its = [iter(s) for s in sources]
        n = 0
        try:
            while max_frames is None or n < max_frames:
                frames = []
                for it in its:
                    try:
                        frames.append(next(it))
                    except StopIteration:
                        return
                self.step(frames)
                n += 1
        finally:
            self.sync_states()

    def sync_states(self):
        """Give each estimator its own copy of its tracking state (its VO
        engine's previous frame is a view of the fleet's batched frontend
        output), so per-sequence stepping, checkpointing and ``finalize``
        continue after a fleet run without holding the batch."""
        for e in self.ests:
            if e.vo._prev is not None:
                e.vo._prev = FrameFeatures(*(a.clone() for a in e.vo._prev))

    def step(self, frames):
        """Advance every sequence by one frame (lockstep)."""
        S = len(self.ests)
        assert len(frames) == S
        # lockstep requires homogeneous estimator state: all bootstrapped or
        # none (a mixed fleet would bootstrap some sequences twice)
        boot = [e.store.n_kfs == 0 or e.vo._prev is None for e in self.ests]
        assert all(boot) or not any(boot), (
            "fleet estimators must be in the same lifecycle state "
            f"(needs-bootstrap flags: {boot})")
        if boot[0]:
            # the first frame goes through each estimator's normal path
            for e, (left, right) in zip(self.ests, frames):
                e.step(left, right)
            return

        frames_on = [[torch.as_tensor(np.stack([frames[i][j] for i in shard]), device=dev)
                      for j in (0, 1)] for dev, shard in zip(self.mesh.devices, self.shards)]
        results = []
        for e in self.ests:
            e.frame_idx += 1
            results.append(StepResult(e.frame_idx))
            e.step_log.append(results[-1])

        # the frontend of each shard's sequences still in the retry protocol
        # as one batch, each at its own thresholds; every sequence's protocol
        # is its estimator's own (one VO pass per send)
        protos = [e.adaptive_vo() for e in self.ests]
        for p in protos:
            next(p)
        vos = [None] * S
        pending = list(range(S))
        while pending:
            work = []  # (sequences, their frames' features) per shard
            for (lefts, rights), dev, shard in zip(frames_on, self.mesh.devices, self.shards):
                idx = [i for i in pending if i in shard]
                if not idx:
                    continue
                ths = [self.ests[i].vo.thresholds() for i in idx]
                sel = torch.as_tensor([i - shard[0] for i in idx], device=dev)
                fast = torch.tensor([t[0] for t in ths], dtype=torch.float32, device=dev)
                work.append((idx, extract_and_match_batch(
                    lefts[sel], rights[sel], self.ests[idx[0]].cam, fast, [t[1] for t in ths],
                    **self.ests[idx[0]].vo.frontend_options())))
            solved = [(idx, curs, solve_tracks([self.ests[i].vo for i in idx], curs))
                      for idx, curs in work]
            still = []
            for idx, curs, outs in solved:
                engines = [self.ests[i].vo for i in idx]
                for i, vo in zip(idx, commit_tracks(engines, curs, to_host(outs))):
                    try:
                        protos[i].send(vo)
                        still.append(i)
                    except StopIteration as done:
                        vos[i] = done.value
            pending = still

        # each sequence's walk head (pose, triggers); the checks of each
        # shard's sequences that check as one batch; then each one's decision
        checks = [(i, res, force) for i, (e, res, vo) in enumerate(zip(self.ests, results, vos))
                  if (force := e._walk_head(res, vo)) is not None]
        if checks:
            self._check(checks)

    def _check(self, checks):
        """The keyframe checks ``checks`` [(sequence, StepResult,
        force_new_kf)] of one step: one batched check per shard for the
        sequences whose vocabulary and check options agree (one batch a
        shard in a fleet built as the CLI builds it), every batch enqueued
        before any is read; then each sequence's decision."""
        groups = {}
        for i, res, force in checks:
            e = self.ests[i]
            seed = e.next_check_key()
            opts = e.check_options()
            sig = (self._shard_of[i], id(e.bow.voc), tuple(sorted(opts.items())),
                   e.debug.enabled)
            groups.setdefault(sig, (opts, []))[1].append((e, res, force, seed))
        queried = [(group, self._check_group(opts, group)) for opts, group in groups.values()]
        for group, outs in queried:
            pulled = self._pull_group(group, outs)
            for q, (e, res, force, _seed) in enumerate(group):
                e._walk_tail(res, e.vo.last_frame(), force, [a[q] for a in pulled])

    @staticmethod
    def _check_group(opts: dict, group: list) -> list:
        """One ``query_and_associate`` for the sequences of ``group``
        [(estimator, StepResult, force_new_kf, seed)] over their stacked
        frames, stores and BoW databases (one device); returns the check's
        outputs (the sequence dimension leading), not yet read."""
        ests = [e for e, *_ in group]
        e0 = ests[0]
        cur = stack_features([e.vo.last_frame() for e in ests])
        keys = torch.stack([prng.PRNGKey(seed, device=e0.device) for *_, seed in group])
        with contextlib.ExitStack() as sections:
            for e in ests:
                sections.enter_context(e.profiler.section("queryDB"))
            top_s, top_i, _cand, da = query_and_associate(
                cur, KFArrays(*(torch.stack(parts) for parts in zip(*(e.store.arrays
                                                                      for e in ests)))),
                torch.stack([e.bow._db for e in ests]), e0.bow._leaf_bits, e0.bow._weights,
                [e.store.n_kfs for e in ests], e0.cam, keys, **opts)
        return e0.check_outputs(top_s, top_i, da, cur)

    @staticmethod
    def _pull_group(group: list, outs: list) -> list:
        """The outputs ``outs`` of ``_check_group`` copied to the host once,
        with the launched window solves of the group's estimators, which
        commit there: each estimator's solves land at its own checks, as
        in its solo run."""
        ests = [e for e, *_ in group]
        with contextlib.ExitStack() as sections:
            for e in ests:
                sections.enter_context(e.profiler.section("performDA"))
            pends = [e.rba.pending_device_arrays() for e in ests]
            pulled = to_host(list(outs) + [a for p in pends for a in p])
            off = len(outs)
            for e, p in zip(ests, pends):
                if p:
                    e.rba.commit_pending(pulled[off:off + len(p)])
                    off += len(p)
                e._reanchor_if_dirty()
        return pulled[:len(outs)]
