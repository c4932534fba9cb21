"""Several independent SLAM runs in frame lockstep over a mesh of devices.

Counterpart of ``srba_slam_tpu/parallel/fleet.py``. ``FleetSLAM`` advances S
sequences one frame at a time together (multi-run evaluation, parameter
sweeps, fleet replay; the reference app runs one sequence, single-threaded).
The S sequences are sharded over a mesh (``parallel/batch.py``): sequence
``i`` lives on ``mesh.devices[i // (S // n)]`` for a mesh of n devices, and
its estimator was built there. The default mesh is JAX's: the largest
count of the machine's cards that divides S (one card: the whole fleet on
it).

* a lockstep attempt of a shard (``_attempt``; ≙ JAX's ``_build_vo_prog``)
  is the frontend of its pending sequences as one ``extract_and_match_batch``
  over their images on the shard's device, each sequence at its own
  adaptive FAST/ORB thresholds (K1 takes one threshold per image: one K1
  and one K2 launch), then their tracking and pose solves as one
  ``track_and_solve`` of one lane per sequence; its outputs come to the
  host in one copy per shard, and each engine commits its frame there. The
  low-match retry protocol (reference
  src/CSRBAStereoSLAMEstimator.cpp:263-315) runs per sequence,
  fleet-wide: the sequences whose matches fell short go through an attempt
  again together, at most 6 attempts;
* the keyframe checks of a shard's sequences that check this step
  (``_check_group``; ≙ JAX's ``_build_qa_prog``) are one batched
  ``query_and_associate`` over their frames, keyframe stores and BoW
  databases stacked on the device, lanes = (sequence, candidate), each
  key built on the device from its sequence's seed; only the checking
  sequences advance their DA seeds;
* on a card (``parallel/batch.py`` ``FLEET_GRAPHS``) an attempt and a
  check group are each one replay of a CUDA-graph program per key and
  shard (``ops/cuda_graphs.py`` ``program``), captured on the shard's
  device at a key's first call: the attempt's key is
  ``models/vo.py`` ``attempt_key`` (it holds the number of pending
  sequences, so a retry with fewer is another program), its sequences'
  indices, thresholds and initial increments one pinned upload an
  attempt; the check's is ``models/data_association.py``
  ``fleet_check_key`` (the group's size), its sequences' indices among the
  shard's, keyframe counts and seeds one pinned upload, and the shard's
  keyframe stores, BoW databases and the vocabulary held in place (their
  addresses join the key: a fleet's estimators are fixed for its life), so
  a group of any Q of them is one program. Eager launches otherwise (the
  CPU path, and the card's reference), the same code and so the same bits;
* every shard's attempts, and every shard's checks, are enqueued before
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

from srba_slam_tpu_torch.models.data_association import (
    check_output_list, fleet_check_key, query_and_associate,
)
from srba_slam_tpu_torch.models.estimator import SRBAStereoSLAMEstimator, StepResult
from srba_slam_tpu_torch.models.keyframe import KFArrays
from srba_slam_tpu_torch.models.vo import (
    FrameFeatures, attempt_key, commit_tracks, extract_and_match_batch, stack_features,
    to_host, track_and_solve,
)
from srba_slam_tpu_torch.ops import cuda_graphs, prng
from srba_slam_tpu_torch.parallel import batch
from srba_slam_tpu_torch.parallel.batch import Mesh, canonical_device, fleet_mesh


def _attempt_body(x: dict, cam, frontend: dict, solve: dict) -> tuple:
    """A shard's lockstep attempt (≙ one shard of JAX's ``_build_vo_prog``):
    the frontend of the pending sequences' pairs, picked from the shard's
    frames ``x["lefts"]``/``x["rights"]`` [S', H, W] by the first column of
    ``x["table"]`` (f32 [n, 9]: index in the shard, FAST and ORB
    thresholds, initial increment), then their tracks against ``x["prev"]``
    (their n previous frames) and pose solves as n lanes. Returns the n
    frames' stacked features and the tensors that ``commit_tracks`` reads.
    No host read."""
    t = x["table"]
    sel = t[:, 0].to(torch.int64)
    fast, orb = t[:, 1], t[:, 2]
    cur = stack_features(extract_and_match_batch(x["lefts"][sel], x["rights"][sel], cam, fast,
                                                 orb, rect_maps=x.get("rect_maps"), **frontend))
    out = track_and_solve(stack_features(x["prev"]), cur, cam, t[:, 3:].contiguous(), orb,
                          **solve)
    return cur, [out.track_idx, out.track_valid, cur.m_valid, out.pose.pose, out.pose.valid,
                 out.pose.mean_residual, out.pose.iters]


def _check_body(x: dict, cam, n_query: int, debug: bool, opts: dict) -> list:
    """A shard's check group (≙ one shard of JAX's ``_build_qa_prog``): the Q
    frames ``x["curs"]`` stacked, each checked against the keyframe store
    and BoW database of its sequence, picked from the shard's held ones
    (``x["stores"]``, ``x["dbs"]``) by the first column of ``x["table"]``
    (int64 [Q, 3]: index among them, stored keyframes, seed), its key built
    from its seed. Returns the check's outputs (``check_output_list``), Q
    leading. No host read."""
    t = x["table"]
    sel = t[:, 0]
    arrays = KFArrays(*(torch.stack(parts)[sel] for parts in zip(*x["stores"])))
    keys = torch.stack([prng.PRNGKey(t[q, 2]) for q in range(t.shape[0])])
    cur = stack_features(x["curs"])
    top_s, top_i, _cand, da = query_and_associate(
        cur, arrays, torch.stack(x["dbs"])[sel], x["leaf_bits"], x["weights"], t[:, 1], cam,
        keys, n_query=n_query, **opts)
    return check_output_list(top_s, top_i, da, cur, debug)


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

        frames_on = [[cuda_graphs.upload(np.stack([frames[i][j] for i in shard]), dev)
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
            work = [self._attempt(s, [i for i in pending if i in shard], lefts, rights)
                    for s, ((lefts, rights), shard) in enumerate(zip(frames_on, self.shards))
                    if any(i in shard for i in pending)]
            still = []
            for idx, curs, outs in work:
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

    def _attempt(self, s: int, idx: list, lefts: torch.Tensor, rights: torch.Tensor):
        """One lockstep attempt of shard ``s`` for its pending sequences
        ``idx`` over the shard's frames ``lefts``/``rights`` [S', H, W] on its
        device (:func:`_attempt_body`), each at its engine's thresholds and
        from its initial increment (one upload); on a card one replay of the
        attempt program of its :func:`models.vo.attempt_key`, the frontend's
        rectification maps held. Returns ``(idx, their FrameFeatures, the
        outputs commit_tracks reads)``, not yet read."""
        dev, shard = self.mesh.devices[s], self.shards[s]
        engines = [self.ests[i].vo for i in idx]
        e0 = self.ests[shard[0]].vo   # the fleet's one frontend: its options and maps
        table = cuda_graphs.upload([[i - shard[0], *e.thresholds(),
                                     *e.initial_increment().tolist()]
                                    for i, e in zip(idx, engines)], dev, torch.float32)
        inputs = dict(lefts=lefts, rights=rights, table=table, prev=[e._prev for e in engines])
        frontend = e0.frontend_options()
        maps = frontend.pop("rect_maps")
        held = {} if maps is None else dict(rect_maps=maps)
        solve = e0.solve_options()

        def body(x):
            return _attempt_body(x, e0.cam, frontend, solve)

        if batch.programs(dev):
            cur, outs = cuda_graphs.program(
                body, inputs, attempt_key(lefts, len(idx), e0.cam, maps,
                                          **{k: v for k, v in frontend.items() if k != "device"},
                                          **solve),
                counted=batch.COUNTED, held=held)
        else:
            cur, outs = body({**inputs, **held})
        return idx, [FrameFeatures(*(a[j] for a in cur)) for j in range(len(idx))], outs

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
        queried = [(group, self._check_group(sig[0], opts, group))
                   for sig, (opts, group) in groups.items()]
        for group, outs in queried:
            pulled = self._pull_group(group, outs)
            for q, (e, res, force, _seed) in enumerate(group):
                e._walk_tail(res, e.vo.last_frame(), force, [a[q] for a in pulled])

    def _check_group(self, s: int, opts: dict, group: list) -> list:
        """One ``query_and_associate`` for the sequences of ``group``
        [(estimator, StepResult, force_new_kf, seed)] of shard ``s`` over
        their stacked frames, stores and BoW databases (:func:`_check_body`;
        their indices among the shard's estimators that share the group's
        vocabulary, keyframe counts and seeds one upload); on a card one
        replay of the check program of its
        :func:`models.data_association.fleet_check_key`, those estimators'
        stores and databases and the vocabulary held. Returns the check's
        outputs (the sequence dimension leading), not yet read."""
        ests = [e for e, *_ in group]
        e0 = ests[0]
        dev = self.mesh.devices[s]
        held_ests = [self.ests[i] for i in self.shards[s]
                     if self.ests[i].bow is not None and self.ests[i].bow.voc is e0.bow.voc]
        table = cuda_graphs.upload([[held_ests.index(e), e.store.n_kfs, seed]
                                    for e, *_rest, seed in group], dev, torch.int64)
        inputs = dict(curs=[e.vo.last_frame() for e in ests], table=table)
        # the vocabulary's tensors of one estimator for every group of the
        # shard (each estimator has its own copy): one program a group size
        held = dict(stores=[e.store.arrays for e in held_ests], dbs=[e.bow._db for e in held_ests],
                    leaf_bits=held_ests[0].bow._leaf_bits, weights=held_ests[0].bow._weights)
        n_query, debug = 4, e0.debug.enabled

        def body(x):
            return _check_body(x, e0.cam, n_query, debug, opts)

        with contextlib.ExitStack() as sections:
            for e in ests:
                sections.enter_context(e.profiler.section("queryDB"))
            if batch.programs(dev):
                return cuda_graphs.program(
                    body, inputs, fleet_check_key(inputs["curs"], held["stores"], held["dbs"],
                                                  e0.cam, n_query, debug, **opts), held=held)
            return body({**inputs, **held})

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

