"""Several independent SLAM runs in frame lockstep on one card.

Counterpart of ``srba_slam_tpu/parallel/fleet.py``. ``FleetSLAM`` advances S
sequences one frame at a time together (multi-run evaluation, parameter
sweeps, fleet replay; the reference app runs one sequence, single-threaded):

* the frontend of all S sequences is one ``extract_and_match_batch`` over
  their 2S images, each sequence at its own adaptive FAST/ORB thresholds
  (K1 takes one threshold per image): one K1 and one K2 launch per
  attempt. The low-match retry protocol (reference
  src/CSRBAStereoSLAMEstimator.cpp:263-315) runs per sequence, fleet-wide:
  the sequences whose matches fell short go through the frontend again
  together, at most 6 attempts;
* the tracking and pose solve of the sequences in an attempt is one
  ``solve_pose`` of one lane per sequence (``models/vo.py`` ``track_batch``;
  ≙ JAX's ``_build_vo_prog``);
* the keyframe checks of the sequences that check this step are one
  batched ``query_and_associate`` over their stacked keyframe stores and
  BoW databases, lanes = (sequence, candidate) (≙ JAX's
  ``_build_qa_prog``); only the checking sequences advance their DA seeds;
* every sequence's host bookkeeping goes through its own estimator's
  methods, the single copy that per-frame stepping uses: the retry protocol
  ``adaptive_vo``, the VO engine's ``commit_frame`` (IDs), and the walk's
  head (pose, triggers) and tail (the keyframe decision). So a fleet run
  makes each sequence's solo decisions.

The JAX package shards the fleet over a device mesh; one H100 has no mesh,
and the fleet is a leading batch dimension.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from srba_slam_tpu_torch.models.data_association import query_and_associate
from srba_slam_tpu_torch.models.estimator import SRBAStereoSLAMEstimator, StepResult
from srba_slam_tpu_torch.models.keyframe import KFArrays
from srba_slam_tpu_torch.models.vo import (
    FrameFeatures, extract_and_match_batch, stack_features, to_host, track_batch,
)
from srba_slam_tpu_torch.ops import prng


class FleetSLAM:
    """Lockstep multi-sequence SLAM with a batched frontend, pose solve
    and keyframe check."""

    def __init__(self, estimators: list[SRBAStereoSLAMEstimator]):
        assert estimators, "need at least one estimator"
        self.ests = estimators
        e0 = estimators[0]
        for e in estimators[1:]:
            assert e.capacity == e0.capacity and e.max_kfs == e0.max_kfs, \
                "fleet sequences must share capacities"
            assert e.device == e0.device and e.cam == e0.cam and e.vo_opts == e0.vo_opts, \
                "fleet sequences share one frontend: device, camera and VO options"

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

        e0 = self.ests[0]
        lefts = torch.as_tensor(np.stack([f[0] for f in frames]), device=e0.device)
        rights = torch.as_tensor(np.stack([f[1] for f in frames]), device=e0.device)
        results = []
        for e in self.ests:
            e.frame_idx += 1
            results.append(StepResult(e.frame_idx))
            e.step_log.append(results[-1])

        # the frontend of the sequences still in the retry protocol as one
        # batch, each at its own thresholds; every sequence's protocol is its
        # estimator's own (one VO pass per send)
        protos = [e.adaptive_vo() for e in self.ests]
        for p in protos:
            next(p)
        vos = [None] * S
        pending = list(range(S))
        while pending:
            ths = [self.ests[i].vo.thresholds() for i in pending]
            sel = torch.as_tensor(pending, device=e0.device)
            fast = torch.tensor([t[0] for t in ths], dtype=torch.float32, device=e0.device)
            curs = extract_and_match_batch(lefts[sel], rights[sel], e0.cam, fast,
                                           [t[1] for t in ths], **e0.vo.frontend_options())
            still = []
            for i, vo in zip(pending, track_batch([self.ests[i].vo for i in pending], curs)):
                try:
                    protos[i].send(vo)
                    still.append(i)
                except StopIteration as done:
                    vos[i] = done.value
            pending = still

        # each sequence's walk head (pose, triggers); the checks of all the
        # sequences that check as one batch; then each one's decision
        checks = [(e, res, force) for e, res, vo in zip(self.ests, results, vos)
                  if (force := e._walk_head(res, vo)) is not None]
        if checks:
            self._check(checks)

    def _check(self, checks):
        """The keyframe checks ``checks`` [(estimator, StepResult,
        force_new_kf)] of one step: one batched check for the sequences
        whose vocabulary and check options agree (one batch in a fleet
        built as the CLI builds it), then each sequence's decision."""
        groups = {}
        for e, res, force in checks:
            seed = e.next_check_key()
            opts = e.check_options()
            sig = (id(e.bow.voc), tuple(sorted(opts.items())), e.debug.enabled)
            groups.setdefault(sig, (opts, []))[1].append((e, res, force, seed))
        for opts, group in groups.values():
            pulled = self._check_group(opts, group)
            for q, (e, res, force, _seed) in enumerate(group):
                e._walk_tail(res, e.vo.last_frame(), force, [a[q] for a in pulled])

    @staticmethod
    def _check_group(opts: dict, group: list) -> list:
        """One ``query_and_associate`` for the sequences of ``group``
        [(estimator, StepResult, force_new_kf, seed)] over their stacked
        frames, stores and BoW databases, its outputs copied to the host
        once (the sequence dimension leading)."""
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
        with contextlib.ExitStack() as sections:
            for e in ests:
                sections.enter_context(e.profiler.section("performDA"))
            pulled = to_host(e0.check_outputs(top_s, top_i, da, cur))
            for e in ests:
                e._reanchor_if_dirty()
        return pulled
