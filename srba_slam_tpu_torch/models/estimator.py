"""The SLAM estimator's per-frame pipeline (≙ CSRBAStereoSLAMEstimator).

Counterpart of ``srba_slam_tpu/models/estimator.py``'s ``step()`` path
(reference src/CSRBAStereoSLAMEstimator.{h,cpp}): VO with the adaptive
detector-threshold retry → keyframe-check triggers → BoW query →
similar-KF selection → DA cascade → loop-closure confirmation (and the
odometry-seeded recovery of a rejected one) → feature-ID propagation →
SRBA insertion and window solve → pose bookkeeping; at the end the global
pose graph and the output files.

This is the single copy of the per-frame host walk (``_walk_frame``: its
head, pose accumulators and triggers; the check; its tail, the keyframe
decision; the ID chain is the VO engine's ``commit_frame``). A keyframe
check runs the BoW query and the DA cascade, its five candidates as one
batch, on the estimator's device and copies their outputs to the host
once; the fleet runs the heads of its sequences, one batched check for
those that check, then their tails. The options around the loop run as in
the JAX package: the rectification maps of an unrectified rig, the
``general.debug`` file family, the ``show3D`` snapshots behind the live
viewer, and the resumable checkpoint (``utils/checkpoint.py``).

Window solves follow the JAX package's schedules. The default
(``solve_sync = False``) is pipelined: an insertion queues its window, the
engine launches groups of them with no host read, and they land at the
next read of the host (a check's, a batch's, the capacity guard's,
``flush()``/``finalize``), never on timing. ``solve_flush_before_insert``
lands them before the next insertion; ``solve_sync`` right after each.

The batched loop (``perform_stereo_slam_batched``, the CLI's ``--batch N``)
is the JAX package's default loop: a frame uploader thread stages the
frames; each batch's VO is one ``vo_scan``, launched before the batch
before it is walked; the walk goes through the same ``_walk_head``/
``_walk_tail`` with its keyframe checks deferred: each is predicted,
speculated on and planned, the batch's checks launch as one
``fused_checks_batch`` group (on a card one CUDA-graph replay a check, its
row and seed from one upload of the group's slot table), and they resolve
at the next batch's single read, which also carries the scan's summary and the launched window
solves. A wrong prediction restores the snapshot taken at its check and
replays the rest of its batch exactly (``_miss_recover``, or
``_shrink_replay`` for a threshold shrink), so the decisions are per-frame
stepping's. The adaptive-threshold protocol runs at batch granularity, as
in the JAX package.

Two differences from the JAX package's batched walk stay: at a skip frame
(an invalid pose or under 8 matches) the JAX walk cuts the track chains,
while the port's one ID walk carries them, as per-frame stepping does;
and the port stops at the frame where ``max_num_kfs`` or ``to_step`` is
reached, keeping the frames it took from the source but did not walk for
the next call.
"""

from __future__ import annotations

import itertools
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from srba_slam_tpu_torch.config import (
    GeneralOptions, SRBAStereoSLAMOptions, VOOptions, load_config,
)
from srba_slam_tpu_torch.models.bow import BoWDatabase, Vocabulary
from srba_slam_tpu_torch.models.data_association import (
    CHECK_SLOTS, S_TRACKED, fused_checks_batch, query_and_associate_packed, recheck_candidate,
    slot_table, unpack_check_outputs,
)
from srba_slam_tpu_torch.models.keyframe import KeyframeStore
from srba_slam_tpu_torch.models.srba import SRBAEngine, SRBAParams
from srba_slam_tpu_torch.models.vo import StereoVOEngine, to_host, vo_scan
from srba_slam_tpu_torch.ops import cuda_graphs, prng
from srba_slam_tpu_torch.ops.posegraph import optimize_pose_graph
from srba_slam_tpu_torch.ops.ransac import hypotheses_for_prob
from srba_slam_tpu_torch.ops.rectify import build_maps
from srba_slam_tpu_torch.utils import se3_np
from srba_slam_tpu_torch.utils.debug_dumps import DebugDumper, export_scene_ply
from srba_slam_tpu_torch.utils.profiler import Profiler
from srba_slam_tpu_torch.utils.stats import VerboseLogger
from srba_slam_tpu_torch.utils.thresholds import (
    update_rotation_threshold, update_translation_threshold,
)

MAX_SIMILAR = 5  # prev KF + up to 4 BoW results (reference queries n=4)
# Placeholder IDs of a speculative insert's frame start at or above this
# (a slot's placeholder is base + slot): above every real match ID, so a
# placeholder never equals one.
_SPEC_ID_BASE = 1 << 40


def _pack_scan_summary(outs, last_inc) -> list:
    """What the host walk reads of a scan (``vo_scan``'s ``outs``), in the
    order of the batch's one ``to_host``: the three track lanes the ID walk
    chains (track_idx, track_valid, m_valid [B, K]), the poses, their
    validity and mean residuals, and the chained last increment (≙ the JAX
    package's ``_pack_scan_summary``; the JAX walk counts its tracks on
    the device, the port's one ID walk on the host)."""
    curs, track_idx, track_valid, poses, pose_valid, _n_inl, mean_res = outs
    return [track_idx, track_valid, curs.m_valid, poses, pose_valid, mean_res, last_inc]


def _unpack_scan_summary(host) -> dict:
    """The host copies of :func:`_pack_scan_summary`'s tensors by name,
    with each frame's stereo-match count ``nm``."""
    ti, tv, mv, poses, pose_valid, mean_res, last_inc = host
    return dict(track_idx=ti, track_valid=tv, m_valid=mv, nm=mv.sum(axis=1), poses=poses,
                pose_valid=pose_valid, mean_res=mean_res, last_inc=last_inc)


def _chain_slotmaps(ids: np.ndarray, base: int, k: int) -> np.ndarray:
    """The keyframe slot each track of ``ids`` chains to, for the
    placeholder IDs ``base + slot`` of a speculative insert's frame (-1:
    not chained to it) (≙ the JAX package's slot maps)."""
    ids = np.asarray(ids, np.int64)
    return np.where((ids >= base) & (ids < base + k), ids - base, -1)


class _FrameUploader:
    """Stages the batched loop's frames to the device ahead of the walk.

    A worker thread takes ``batch`` frames at a time from the source and
    copies them into pinned host buffers; it makes no CUDA call, so it
    never breaks a CUDA graph capture on the main thread (captures use the
    global mode). The buffers, the device buffers and the copy stream are
    made on the main thread before the worker starts, and ``next()``, on
    the main thread, puts a batch's host-to-device copy on the copy stream
    with an event that the scan waits on. ``release(item)`` hands a
    batch's buffers back once its read has run (the copy is done then);
    ``drain_and_stop()`` stops the worker and returns the batches staged
    but not taken. On the CPU the buffers are plain memory and a batch is
    a copy of them.
    """

    def __init__(self, frame_iter, batch: int, device, f0: int, depth: int = 2,
                 stats: list | None = None):
        import queue
        import threading

        self._batch = batch
        self._dev = torch.device(device)
        self._cuda = self._dev.type == "cuda"
        self._q = queue.Queue(maxsize=depth)
        self._free = queue.Queue()
        self._stop = threading.Event()
        self._stats = stats
        self._next_f0 = f0
        first = next(frame_iter, None)
        self._bufs, self._dev_bufs = [], []
        if first is not None:
            shape = (2, batch) + np.asarray(first[0]).shape
            dtype = torch.from_numpy(np.asarray(first[0])[:1].copy()).dtype
            for i in range(depth + 3):
                self._bufs.append(torch.empty(shape, dtype=dtype, pin_memory=self._cuda))
                self._free.put(i)
            if self._cuda:
                self._copy = torch.cuda.Stream(device=self._dev)
                self._dev_bufs = [(torch.empty(shape, dtype=dtype, device=self._dev), None)
                                  for _ in range(depth + 2)]
            frame_iter = itertools.chain([first], frame_iter)
        self._it = frame_iter if first is not None else iter(())
        self._t = threading.Thread(target=self._run, daemon=True, name="srba-frame-uploader")
        self._t.start()

    def _run(self):
        import queue

        try:
            while self._bufs and not self._stop.is_set():
                try:
                    slot = self._free.get(timeout=0.05)
                except queue.Empty:
                    continue
                t0 = time.perf_counter()
                frames = list(itertools.islice(self._it, self._batch))
                if not frames:
                    break
                host = self._bufs[slot].numpy()
                for i, (left, right) in enumerate(frames):
                    host[0, i] = left
                    host[1, i] = right
                if self._stats is not None:
                    self._stats.append(dict(n=len(frames), bytes=int(host[:, :len(frames)].nbytes),
                                            t0=t0, t1=time.perf_counter()))
                # a staged batch is never dropped: drain_and_stop takes it
                self._q.put(dict(slot=slot, frames=frames))
            self._q.put(None)
        except BaseException as e:  # raised again on the main thread
            self._q.put(e)

    def next(self) -> dict | None:
        """The next staged batch as ``dict(lefts, rights, ready, frames,
        f0)`` (device frames, the copy's event, the host frames, the first
        frame's index), None at the end of the source."""
        item = self._q.get()
        if isinstance(item, BaseException):
            raise item
        if item is None:
            self._q.put(None)  # the end stays the end
            return None
        n, src = len(item["frames"]), self._bufs[item["slot"]]
        if self._cuda:
            dst, released = self._dev_bufs.pop(0) if self._dev_bufs else (
                torch.empty_like(src, device=self._dev), None)
            with torch.cuda.stream(self._copy):
                if released is not None:
                    self._copy.wait_event(released)  # its last scan is done
                dst[:, :n].copy_(src[:, :n], non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(self._copy)
            item["dev"] = dst
        else:
            dst, ready = src[:, :n].clone(), None
            self._free.put(item.pop("slot"))
        item.update(lefts=dst[0, :n], rights=dst[1, :n], ready=ready, f0=self._next_f0)
        self._next_f0 += n
        return item

    def release(self, item: dict):
        """Hand a taken batch's buffers back once its read has run: the
        host buffer to the worker, the device buffer to a later copy, which
        waits for the scans queued on it so far."""
        if "slot" in item:
            self._free.put(item.pop("slot"))
        if "dev" in item:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self._dev))
            self._dev_bufs.append((item.pop("dev"), done))

    def drain_and_stop(self) -> list:
        """Stop the worker; return the staged batches not taken, in order
        (their host frames under ``frames``)."""
        import queue

        self._stop.set()
        leftovers = []
        while self._t.is_alive() or not self._q.empty():
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            if isinstance(item, BaseException):
                raise item
            if item is not None:
                leftovers.append(item)
        self._t.join()
        if self._cuda:
            # no buffer goes back to the allocator while a copy writes it
            torch.cuda.current_stream(self._dev).wait_stream(self._copy)
        return leftovers


def _ypr_from_rotmat(R: np.ndarray) -> np.ndarray:
    """[yaw, pitch, roll] (ZYX, MRPT order) in float32, for the trajectory
    file (reference src/CSRBAStereoSLAMEstimator.cpp:977-987)."""
    R = np.asarray(R, np.float32)
    pitch = np.arctan2(-R[2, 0], np.sqrt(R[0, 0] ** 2 + R[1, 0] ** 2))
    yaw = np.arctan2(R[1, 0], R[0, 0])
    roll = np.arctan2(R[2, 1], R[2, 2])
    return np.array([yaw, pitch, roll], np.float32)


@dataclass
class StepResult:
    """What happened to one frame (for logging / tests)."""

    frame_idx: int
    vo_valid: bool = False
    n_stereo_matches: int = 0
    tracked_from_last_kf: int = 0
    kf_check: bool = False
    inserted_kf: int | None = None
    loop_closure_with: int | None = None
    # confirmed LC whose edge the consistency validator later rejected
    # (layer A at creation or layer B post-solve; see SRBAParams.lc_validate)
    lc_rejected_with: int | None = None
    best_tracked: int = 0
    define_kf_ms: float = 0.0


@dataclass
class TStatsSRBA:
    """≙ TStatsSRBA (reference utils.h:492-507) — per-insertion stats."""

    time_ms: float
    number_kfs: int
    number_feats_new: int
    number_feats_common: int


class SRBAStereoSLAMEstimator:
    def __init__(self, general: GeneralOptions | None = None,
                 options: SRBAStereoSLAMOptions | None = None,
                 vo_options: VOOptions | None = None,
                 capacity: int = 512, max_kfs: int = 512, device="cuda"):
        self.general = general or GeneralOptions()
        self.opts = options or SRBAStereoSLAMOptions()
        self.vo_opts = vo_options or VOOptions()
        self.capacity = capacity
        self.max_kfs = max_kfs
        self.device = torch.device(device)
        self.profiler = Profiler()
        # strict solve scheduling: every window solve lands right after its
        # insertion (per-frame and batched runs then commit solves at the
        # same points). The default, as in the JAX package, is pipelined:
        # solves land at the next read of the host.
        self.solve_sync = False
        # the middle schedule: the launched solves land right before the
        # next insertion, which then starts from its predecessor's optimized
        # state (ignored under solve_sync)
        self.solve_flush_before_insert = False
        # latency log (appends only): per batch ("batches": first frame j0,
        # size b, t_dispatch, t_pull), per keyframe decision ("checks":
        # frame, the newest frame in when it resolved, time) and per staged
        # upload ("uploads", from the frame uploader)
        self.lat: dict[str, list] = {"batches": [], "checks": []}
        self._initialized = False

    # ------------------------------------------------------------------ init
    @staticmethod
    def from_config(path: str, **kw) -> "SRBAStereoSLAMEstimator":
        gen, opts, vo = load_config(path)
        return SRBAStereoSLAMEstimator(gen, opts, vo, **kw)

    def initialize(self, vocabulary: Vocabulary | None = None):
        """≙ initialize() (reference .cpp:1099-1339)."""
        o = self.opts
        self.cam = o.camera
        # VO engine with the n_feats / fast_th overrides (reference .cpp:1140-1142)
        self.vo_opts.n_feats = o.n_feats
        self.vo_opts.fast_th = o.detect_fast_th
        self.vo = StereoVOEngine(self.cam, self.vo_opts, capacity=self.capacity,
                                 device=self.device)
        # RECTIFY stage (≙ stereo-vo rectification, the CAMERA_* dist rows):
        # a rig that declares unrectified images with real distortion gets
        # its per-eye undistortion grids once, on the device; the remap runs
        # in front of the detector
        dist_l = list(o.camera_dist_l or [])
        dist_r = list(o.camera_dist_r or [])
        if not self.vo_opts.rectified_images and (any(dist_l) or any(dist_r)):
            c = self.cam
            self.vo.rect_maps = (
                build_maps(c.width, c.height, c.fx_l, c.fy_l, c.cx_l, c.cy_l,
                           dist=dist_l, device=self.device),
                build_maps(c.width, c.height, c.fx_r, c.fy_r, c.cx_r, c.cy_r,
                           dist=dist_r, device=self.device),
            )
        # vocabulary: explicit > config file > on-the-fly training later
        if vocabulary is None and o.voc_filename and os.path.exists(o.voc_filename):
            vocabulary = Vocabulary.load_dbow2(o.voc_filename)
        self._pending_voc_training = vocabulary is None
        self._voc_buffer = []  # (frame_idx, desc, valid) on the device
        self.bow = (BoWDatabase(vocabulary, max_kfs=self.max_kfs, device=self.device)
                    if vocabulary else None)
        self.store = KeyframeStore(max_kfs=self.max_kfs, capacity=self.capacity,
                                   device=self.device)
        self.log = VerboseLogger(self.general.verbose_level)
        # the engine queues each window; the estimator's schedule lands it
        self.rba = SRBAEngine(
            self.cam,
            SRBAParams(
                submap_size=o.srba_submap_size,
                max_tree_depth=o.srba_max_tree_depth,
                max_optimize_depth=o.srba_max_optimize_depth,
                min_obs_to_loop_closure=o.min_obs_to_loop_closure,
                use_robust_kernel=o.srba_use_robust_kernel,
                use_robust_kernel_stage1=o.srba_use_robust_kernel_stage1,
                kernel_param=o.srba_kernel_param,
                std_noise_pixels=o.std_noise_pixels,
                max_kfs=self.max_kfs,
                anchor_prior_w_rot=o.anchor_prior_w_rot,
                anchor_prior_w_trans=o.anchor_prior_w_trans,
                lc_validate=o.lc_validate,
                lc_reject_drift_frac=o.lc_reject_drift_frac,
                lc_reject_floor_m=o.lc_reject_floor_m,
                lc_chi2_px=o.lc_chi2_px,
            ),
            logger=VerboseLogger(self.general.verbose_level),
            on_commit=self._on_rba_commit,
            lazy=True,
            device=self.device,
        )
        self.rba.on_lc_reject = self._on_lc_reject
        # camera-on-robot extrinsic (≙ reference .cpp:1106-1112): the
        # configured pose (x y z, yaw pitch roll in degrees) composed with the
        # fixed (-90°, 0, -90°) image-to-camera axis swap. Internal
        # bookkeeping stays in the KF0-camera frame; world outputs are
        # T_world = E ∘ T_cam ∘ E⁻¹, the current pose E ∘ T_cam.
        p = list(self.opts.camera_pose_on_robot or []) + [0.0] * 6
        cfg_pose = se3_np.from_xyz_ypr(p[0], p[1], p[2], np.deg2rad(p[3]),
                                       np.deg2rad(p[4]), np.deg2rad(p[5]))
        axis_swap = se3_np.from_xyz_ypr(0.0, 0.0, 0.0, np.deg2rad(-90.0), 0.0,
                                        np.deg2rad(-90.0))
        self.sensor_pose = se3_np.compose(cfg_pose, axis_swap)
        self.sensor_pose_inv = se3_np.inverse(self.sensor_pose)
        # pose state (KF0-camera frame)
        self.current_pose = np.zeros(6)
        self.last_kf_pose = np.zeros(6)
        self.incr_from_last_kf = np.zeros(6)
        self.incr_from_last_check = np.zeros(6)
        # dynamic thresholds (working values start at the config limits;
        # hard force-limits are 2x — reference .cpp:1163-1164)
        self.updated_translation_th = float(self.opts.max_translation)
        self.updated_rotation_th = float(self.opts.max_rotation)
        # RANSAC hypothesis budget from the configured confidence (≙
        # ransac_fit_prob -> cv::findFundamentalMat iterations, .cpp:2043)
        self._ransac_n_hyp = hypotheses_for_prob(self.opts.ransac_fit_prob)
        self.next_match_id = 0
        self.frame_idx = -1
        self._da_dead = False
        self._pose_dirty = False
        self.kf_stats: list[TStatsSRBA] = []
        self.step_log: list[StepResult] = []
        # DA RNG: a host counter; each check builds its key from it
        # (ops/prng.py, JAX's PRNGKey bits)
        self._da_seed = 7
        self.query_log: list = []  # (frame_idx, scores, ids) per KF check
        self.debug = DebugDumper(os.path.join(self.general.out_dir or "out", "debug"),
                                 enabled=self.general.debug)
        # frames a stop condition left unwalked inside a batch, for the next
        # perform_stereo_slam_batched call
        self._stashed_frames: list = []
        # the batched walk's speculation: deferred checks (their snapshots
        # and blobs), checks planned but not launched, walk-time trigger
        # norms since the oldest unresolved check (for _demote_shrink_miss),
        # the resolved speculative inserts' IDs by placeholder base
        self._spec: list[dict] = []
        self._check_plan: list[dict] = []
        self._walk_log: list[tuple] = []
        self._spec_ids: dict[int, np.ndarray] = {}
        self._in_walk = False
        self._virtual_bp = False
        self._replay_flag = False
        self._lat_resolved_at = None
        self._initialized = True

    def _skip_from_step(self, it):
        """Consume (and count) the first ``from_step`` frames unprocessed
        (≙ the from_step skip of reference .cpp:64-70)."""
        while self.frame_idx + 1 < self.general.from_step:
            try:
                next(it)
            except StopIteration:
                break
            self.frame_idx += 1
        return it

    def _pause_each_iteration(self):
        """≙ pause_at_each_iteration (reference .cpp:934-935); only on a tty."""
        if not self.general.pause_at_each_iteration:
            return
        import sys

        if sys.stdin is not None and sys.stdin.isatty():
            input("Press <enter> to continue...")

    # ----------------------------------------------------------------- loop
    def perform_stereo_slam(self, frame_source) -> list[StepResult]:
        """≙ performStereoSLAM() main loop (reference .cpp:29-937)."""
        assert self._initialized, "call initialize() first"
        it = self._skip_from_step(iter(frame_source))
        for left, right in it:
            self.step(left, right)
            self._pause_each_iteration()
            if self._stop_reached():
                break
        return self.step_log

    def _stop_reached(self) -> bool:
        """The main loop's stop conditions after a frame (≙ reference
        .cpp:930-932): ``max_num_kfs`` keyframes, or frame ``to_step``."""
        g = self.general
        return bool((g.max_num_kfs and self.store.n_kfs >= g.max_num_kfs)
                    or (g.to_step and self.frame_idx >= g.to_step))

    # ---------------------------------------------------------- batched loop
    def perform_stereo_slam_batched(self, frame_source, batch: int = 8) -> list[StepResult]:
        """The main loop with the VO of ``batch`` frames as one ``vo_scan``
        (one K1 and one K2 launch for their 2B images) and one blocking
        read of the host a batch: keyframe checks are deferred and
        speculated on (:meth:`_defer_check`), their outputs and the window
        solves ride the next batch's read (:meth:`_process_scan`), which
        also dispatches the batch after it. A frame uploader thread stages
        the frames (:class:`_FrameUploader`). The first frame (and the
        first after a resume, whose checkpoint holds no frame features)
        goes through ``step()``. Stops where ``perform_stereo_slam`` stops,
        at the frame: frames taken from the source but not walked are kept
        for the next call."""
        assert self._initialized, "call initialize() first"
        stashed, self._stashed_frames = self._stashed_frames, []
        it = self._skip_from_step(itertools.chain(stashed, iter(frame_source)))
        if self.store.n_kfs == 0 or self.vo._prev is None:
            first = next(it, None)
            if first is None:
                return self.step_log
            self.step(*first)
            if self._stop_reached():
                return self.step_log
        self._sync_bp_from_engine()
        up = _FrameUploader(it, batch, self.device, self.frame_idx + 1,
                            stats=self.lat.setdefault("uploads", []))
        held, disp, stop = [], None, False
        try:
            cur = up.next()
            if cur is not None:
                held.append(cur)
                disp = self._dispatch_scan(cur)
            nxt = up.next() if disp is not None else None
            while disp is not None:
                if nxt is not None:
                    held.append(nxt)

                def next_fn(chain_disp, nd=nxt):
                    return self._dispatch_scan(nd, chain=chain_disp)

                done = disp
                disp = self._process_scan(disp, next_fn if nxt is not None else None)
                up.release(done["item"])
                g = self.general
                if g.max_num_kfs and self.store.n_kfs + self._n_spec_inserts() >= g.max_num_kfs:
                    # a predicted insert that resolves to no insert must not
                    # stop the run early: resolve, decide on the committed count
                    self._resolve_pending_checks()
                if self._stop_reached():
                    stop = True
                    break
                if disp is not None and nxt is not None:
                    nxt = up.next()
                held = held[-3:]
            self._finish_batched()
        finally:
            leftovers = up.drain_and_stop()
        if stop:
            # the frames taken from the source after the stop frame, in
            # order: the rest of the walked batches, the next ones staged
            rest = [fr for item in held
                    for k, fr in enumerate(item["frames"]) if item["f0"] + k > self.frame_idx]
            self._stashed_frames = rest + [fr for item in leftovers for fr in item["frames"]]
        return self.step_log

    def perform_stereo_slam_device(self, chunks) -> list[StepResult]:
        """The loop over frames already on the device (≙ the device-resident
        loop the JAX package's ``bench.py`` times): ``chunks`` is a list of
        (lefts, rights) [B, H, W] device tensors, each chunk one scan
        chained from the chunk before it, with one read a chunk and no
        uploader. The engine must hold a previous frame (the first frame
        went through ``step()`` or a batched call)."""
        assert self._initialized and self.vo._prev is not None
        self._sync_bp_from_engine()
        items = [self.device_batch(lefts, rights) for lefts, rights in chunks]
        disp = self._dispatch_scan(items[0]) if items else None
        for i in range(1, len(items) + 1):
            if disp is None:
                break
            nxt = items[i] if i < len(items) else None
            disp = self._process_scan(disp, None if nxt is None else (
                lambda chain_disp, it=nxt: self._dispatch_scan(it, chain=chain_disp)))
            if self._stop_reached():
                break
        self._finish_batched()
        return self.step_log

    def step_batch(self, lefts, rights) -> int:
        """Process the B frames ``lefts``/``rights`` [B, H, W] with one
        ``vo_scan`` (and one more for each adaptive retry's tail) and its
        one read, every deferred check resolved before this returns.
        Returns the number of frames walked: B, or fewer where a stop
        condition fired."""
        self._sync_bp_from_engine()
        f0 = self.frame_idx + 1
        self._process_scan(self._dispatch_scan(self.device_batch(lefts, rights)))
        self._finish_batched()
        return self.frame_idx + 1 - f0

    def device_batch(self, lefts, rights) -> dict:
        """A batch for :meth:`_dispatch_scan` from frames ``lefts``/
        ``rights`` [B, H, W] (host arrays, or tensors already on the
        device: the device-resident loop stages whole chunks so)."""
        dev = self.device
        return dict(lefts=torch.as_tensor(lefts, device=dev),
                    rights=torch.as_tensor(rights, device=dev), ready=None,
                    f0=self.frame_idx + 1, frames=list(zip(lefts, rights)))

    def _dispatch_scan(self, item: dict, chain: dict | None = None) -> dict:
        """Launch one ``vo_scan`` of a staged batch ``item`` (device frames,
        the upload's event, the host frames, its first frame's index ``f0``)
        with no host read (its GN solves run to their caps, a step past the
        exit skipped on the device; on a card one graph replay per batch, a
        new batch length, such as an adaptive retry's tail, capturing its
        graph first, as a new shape compiles in JAX); its summary
        (:func:`_pack_scan_summary`) rides the batch's read. ``chain``
        continues from an earlier dispatch's last frame and increment (the
        next batch, launched before this one is walked); otherwise the scan
        chains from the engine's state."""
        eng = self.vo
        if item.get("ready") is not None:
            torch.cuda.current_stream(self.device).wait_event(item["ready"])
        lefts, rights = item["lefts"], item["rights"]
        prev_feat = chain["last_feat"] if chain else eng._prev
        prev_inc = chain["last_inc"] if chain else torch.from_numpy(
            np.asarray(eng._last_pose_inc, np.float32)).to(self.device, non_blocking=True)
        fast_th, orb_th = eng.thresholds()
        # the batch's dispatch, stamped before the host issues the scan's
        # launches (the latency log's arrival where no frame stamp is given)
        t_dispatch = time.perf_counter()
        # the thresholds as device inputs: on a card the scan is a replay of
        # a graph captured once per shape, at whatever thresholds they hold
        f32 = torch.float32
        fast_t = torch.full((lefts.shape[0],), fast_th, dtype=f32, device=self.device)
        orb_t = torch.full((), float(orb_th), dtype=f32, device=self.device)
        with cuda_graphs.no_exit_reads():
            last_feat, last_inc, outs = vo_scan(
                lefts, rights, prev_feat, prev_inc, self.cam, fast_t, orb_t,
                **eng.frontend_options(), **eng.solve_options())
        with cuda_graphs.span("eager", self.device):
            pk = _pack_scan_summary(outs, last_inc)
        disp = dict(outs=outs, last_feat=last_feat, last_inc=last_inc, b=lefts.shape[0],
                    f0=chain["f0"] + chain["b"] if chain else item["f0"], item=item,
                    lefts=lefts, rights=rights, pk=pk, t_dispatch=t_dispatch)
        if chain is None:
            # dispatched from the engine's state, which is current: attach
            # now (a chained batch attaches once the batch before it is walked)
            self._attach_summary(disp)
        return disp

    def _attach_summary(self, disp: dict):
        """The point where the JAX package attaches a scan's summary, which
        (re)enters its virtual-chain mode: a threshold-shrink miss of a
        check deferred in that mode replays on the fast path
        (:meth:`_shrink_replay`). The port's summary needs no walk state
        (it is packed at dispatch), so only the mode follows JAX's, which
        keeps the two replays, and the reads at which window solves land,
        the JAX package's."""
        self._virtual_bp = True

    def _process_scan(self, disp: dict, next_fn=None):
        """Read one dispatched batch and walk its frames.

        ONE blocking read serves three purposes: this batch's VO summary,
        the launched window solves (committed first), and the previous
        batch's deferred keyframe checks, which resolve here
        (:meth:`_resolve_spec`; a wrong prediction replays).

        The adaptive-threshold protocol runs at batch granularity (≙ the
        JAX package's, reference .cpp:271-315): if a frame's stereo matches
        fall under ``adaptive_th_min_matches`` while a threshold can still
        move, the frames before it are walked, ``retry_step()`` moves a
        threshold, and the tail from that frame on is scanned again,
        chained from the last walked frame (retries nest). Otherwise the
        thresholds drift once, from the batch's fewest matches.

        ``next_fn(disp)``, when given, launches the NEXT batch's scan; it
        is called once, after this batch's drift (so the next scan launches
        at its final thresholds) and before this batch's walk (so the
        device scans while the host walks). Returns that dispatch (or
        None)."""
        b = disp["b"]
        eng = self.vo
        self._dispatch_planned_checks()  # a retry or guard may leave some
        pend = self.rba.pending_device_arrays()
        spec = self._spec
        spec_handles = [h for c in spec for h in c["handles"]]
        pk = disp["pk"]
        pulled = to_host(list(pk) + list(pend) + spec_handles)
        # latency log: the batch's frame poses are on the host now
        self.lat["batches"].append(dict(j0=disp["f0"], b=b, t_dispatch=disp["t_dispatch"],
                                        t_pull=time.perf_counter()))
        summ = _unpack_scan_summary(pulled[:len(pk)])
        if pend:
            self.rba.commit_pending(pulled[len(pk):len(pk) + len(pend)])
        self._replay_flag = False
        if spec:
            # decision-lag accounting: this batch's frames are in already
            self._lat_resolved_at = disp["f0"] + b - 1
            self._resolve_spec(pulled[len(pk) + len(pend):])
            self._lat_resolved_at = None
        self._reanchor_if_dirty()
        if self._stop_reached():
            return None  # a replay stopped the run at its frame
        batch_rec = dict(feats=disp["outs"][0], b=b, f0=disp["f0"],
                         # a miss replayed just now, or the mode was left: the
                         # JAX package walks this batch from host lanes
                         host_mode=self._replay_flag or not self._virtual_bp, **summ)
        nm = summ["nm"]
        th = self.opts.adaptive_th_min_matches
        # the protocol runs only under orb_adaptive_fast_th (≙ .cpp:271)
        adaptive = self.opts.orb_adaptive_fast_th
        retry_j = None
        if adaptive and (not eng.is_fast_th_min() or not eng.is_orb_th_max()):
            below = np.nonzero(nm < th)[0]
            if len(below):
                retry_j = int(below[0])
        if retry_j is not None:
            # the record ends at the head, so that a replay never walks
            # into the tail scanned again below
            batch_rec["b"] = retry_j
            self._process_frames(batch_rec, 0, retry_j)
            if self._stop_reached():
                return None
            eng.retry_step()    # moves: gated above on a movable threshold
            item = disp["item"]
            tail = self._dispatch_scan(dict(
                lefts=disp["lefts"][retry_j:], rights=disp["rights"][retry_j:],
                f0=disp["f0"] + retry_j, frames=item["frames"][retry_j:]))
            tail["item"] = item
            # the tail's walk launches the next batch (thresholds final there)
            return self._process_scan(tail, next_fn)
        if adaptive:
            eng.drift_thresholds(int(nm.min()) if b else self.capacity, th)
        nxt = next_fn(disp) if next_fn is not None else None
        self._process_frames(batch_rec, 0, b)
        if nxt is not None:
            self._attach_summary(nxt)
        # launch the batch's deferred checks now, so the device runs them
        # while the host waits for the next batch
        self._dispatch_planned_checks()
        return nxt

    def _process_frames(self, batch_rec: dict, j0: int, j1: int, defer: bool = True):
        """Walk frames [j0, j1) of a batch (:meth:`_walk_frames`), with
        ``_in_walk`` set: a miss resolved inside the walk replays the
        classic way."""
        prev, self._in_walk = self._in_walk, True
        try:
            self._walk_frames(batch_rec, j0, j1, defer)
        finally:
            self._in_walk = prev

    def _walk_frames(self, batch_rec: dict, j0: int, j1: int, defer: bool):
        """Frames [j0, j1) of a scanned batch through the one host walk,
        in order: the VO engine's ``commit_frame`` (IDs), ``_walk_head``
        (pose, triggers) and, where a check fires, either a deferred check
        (``defer``: :meth:`_defer_check`) or the synchronous one and its
        decision (a replay). Returns at a stop condition: the keyframe
        capacity (deferring no further), ``max_num_kfs`` on the committed
        count (resolving first) or ``to_step``."""
        feats = batch_rec["feats"]
        ti, tv, mv = batch_rec["track_idx"], batch_rec["track_valid"], batch_rec["m_valid"]
        poses, pose_valid, mean_res = (batch_rec["poses"], batch_rec["pose_valid"],
                                       batch_rec["mean_res"])
        g = self.general
        for j in range(j0, j1):
            self.frame_idx += 1
            res = StepResult(self.frame_idx)
            self.step_log.append(res)
            cur = type(feats)(*(a[j] for a in feats))
            # (the scan's outputs, as the JAX package's, hold no GN iteration count)
            vo = self.vo.commit_frame(cur, ti[j], tv[j], mv[j], poses[j].copy(),
                                      bool(pose_valid[j]), float(mean_res[j]), 0)
            # a frame under 8 stereo matches is hopeless (≙ _vo_with_adaptive_retry)
            force_new_kf = self._walk_head(res, None if vo.num_stereo_matches < 8 else vo)
            if force_new_kf is not None:
                if defer and self.store.n_kfs + self._n_spec_inserts() >= self.max_kfs:
                    # at keyframe capacity a predicted insert would write out
                    # of range: land what is in flight, check synchronously
                    self._replay_flag = False
                    self._resolve_pending_checks()
                    if self._replay_flag:
                        return  # the replay walked this batch's tail already
                    defer = False
                if defer:
                    self._defer_check(res, force_new_kf, batch_rec, j)
                    if len(self._check_plan) >= CHECK_SLOTS:
                        # a full group: launch now, so it runs during the walk
                        self._dispatch_planned_checks()
                else:
                    frame = self.vo.last_frame()
                    self._walk_tail(res, frame, force_new_kf, self._kf_check(frame))
                # max_num_kfs is a per-frame stop (≙ .cpp:930-932): when the
                # predicted count reaches it, resolve and stop here iff the
                # committed count confirms it
                if g.max_num_kfs and self.store.n_kfs + self._n_spec_inserts() >= g.max_num_kfs:
                    self._replay_flag = False
                    self._resolve_pending_checks()
                    if self._replay_flag or self.store.n_kfs >= g.max_num_kfs:
                        return
            if g.to_step and self.frame_idx >= g.to_step:
                return

    def _n_spec_inserts(self) -> int:
        return sum(1 for c in self._spec if c["ins"])

    # ----------------------------------------------- speculative KF checks
    # A deferred check's outcome is predicted from its trigger (force / low
    # tracking => insert) and the last resolved check's DA result (an
    # appearance-blind VO chain can stay long while DA fails). Everything
    # the walk needs to go on is then known: a predicted insert resets the
    # accumulators and thresholds and re-references the track chains to
    # its frame (placeholder IDs, one per valid slot, until its IDs are
    # known), and its keyframe-store and BoW rows are written at the
    # speculative row (inert until committed); a predicted no-insert
    # changes nothing. The check resolves at the next read with exact host
    # state, so its decision is the synchronous one; a wrong prediction
    # restores the snapshot taken at the check and replays the rest of its
    # batch (:meth:`_miss_recover`), so the decisions stay per-frame
    # stepping's either way.

    def _defer_check(self, res: StepResult, force_new_kf: bool, batch_rec: dict, j: int):
        """Plan a keyframe check of frame ``j`` of the batch and speculate
        on its predicted outcome; the check launches with its batch's
        others (:meth:`_dispatch_planned_checks`)."""
        predict_insert = (force_new_kf
                          or res.tracked_from_last_kf < 1.2 * self.opts.updated_matches_th
                          or self._da_dead)
        snap = dict(log_len=len(self.step_log),      # keeps res (the check frame)
                    frame_idx=self.frame_idx, incr_kf=self.incr_from_last_kf.copy(),
                    tr_th=self.updated_translation_th, rot_th=self.updated_rotation_th,
                    batch=batch_rec, j=j, host_mode=batch_rec["host_mode"],
                    vo=self._vo_snapshot())
        spec_row = self.store.n_kfs + self._n_spec_inserts()
        sub = prng.check_seed(self._da_seed)
        self._da_seed += 1
        snap["da_seed"] = self._da_seed  # post-consume: a replay re-counts in order
        spec_entry = dict(handles=None, frame_ref=(batch_rec["feats"], j), res=res,
                          force=force_new_kf, ins=predict_insert, incr_at_check=snap["incr_kf"],
                          snap=snap, spec_row=spec_row, id_base=None)
        self._spec.append(spec_entry)
        self._check_plan.append(dict(spec=spec_entry, feats=batch_rec["feats"], j=j,
                                     row=spec_row, seed=sub))
        if predict_insert:
            # reset the accumulators and thresholds; the track chains re-
            # reference this frame through placeholder IDs (base + slot)
            self.incr_from_last_kf = np.zeros(6)
            self.updated_translation_th = float(self.opts.max_translation)
            self.updated_rotation_th = float(self.opts.max_rotation)
            base = max(self.vo._next_id, _SPEC_ID_BASE)
            ids = np.where(batch_rec["m_valid"][j], base + np.arange(self.capacity), -1)
            self.vo.set_frame_ids(ids, set(int(i) for i in ids if i >= 0))
            spec_entry["id_base"] = base

    def _vo_snapshot(self):
        """The VO engine's walk state (its previous frame, IDs, increment,
        ID counter and keyframe ID set), for a replay."""
        return self.vo.get_state(), set(self.vo._kf_id_set)

    def _vo_restore(self, snap):
        state, kf_ids = snap
        self.vo.set_state(state)
        self.vo._kf_id_set = set(kf_ids)

    def _dispatch_planned_checks(self):
        """Launch every planned check, one ``fused_checks_batch`` per
        CHECK_SLOTS of them from one scanned batch (a padded slot launches
        nothing). Must run before any read of the checks' blobs."""
        plan, self._check_plan = self._check_plan, []
        if not plan:
            return
        if self.bow is None:
            # the first check trains the fallback vocabulary, capped at its
            # frame as per-frame stepping caps it
            self.ensure_vocabulary(limit_fidx=plan[0]["spec"]["res"].frame_idx)
        grps: list[list[dict]] = []
        for p in plan:
            if grps and grps[-1][0]["feats"] is p["feats"] and len(grps[-1]) < CHECK_SLOTS:
                grps[-1].append(p)
            else:
                grps.append([p])
        for grp in grps:
            n = len(grp)
            pad = CHECK_SLOTS - n
            with self.profiler.section("queryDB"):
                # the group's rows and seeds: one upload (a captured slot's inputs)
                table = slot_table([p["row"] for p in grp] + [0] * pad,
                                   [p["seed"] for p in grp] + [grp[-1]["seed"]] * pad,
                                   self.device)
                blobs, arrays, db = fused_checks_batch(
                    grp[0]["feats"], self.store.arrays, self.bow._db, self.bow._leaf_bits,
                    self.bow._weights, [p["j"] for p in grp] + [0] * pad, table[:, 0],
                    [True] * n + [False] * pad, self.cam, table[:, 1],
                    debug=self.debug.enabled, **self.check_options())
            self.store.arrays, self.bow._db = arrays, db
            for p, blob in zip(grp, blobs[:n]):
                p["spec"]["handles"] = (blob,)

    def _spec_frame(self, c: dict):
        """A deferred check's frame features (only a late insertion and
        the debug dumps need them)."""
        feats, j = c["frame_ref"]
        return type(feats)(*(a[j] for a in feats))

    def _resolve_spec(self, vals):
        """Resolve the deferred checks in order from their host blobs
        ``vals``. The host graph state (edges, topological distances,
        thresholds) is exact here, so each decision is the synchronous
        one; only the device inputs were speculative, and they are exact
        unless a prediction missed."""
        checks, self._spec = self._spec, []
        if not checks:
            self._walk_log = []
        t_res = time.perf_counter()
        newest = self.frame_idx if self._lat_resolved_at is None else self._lat_resolved_at
        for idx, c in enumerate(checks):
            d = self._kf_decide((vals[idx],), c["res"], c["force"])
            # latency log: the keyframe decision of this frame commits now
            self.lat["checks"].append(dict(frame=c["res"].frame_idx, resolved_at=newest,
                                           t=t_res))
            if not c["force"]:
                # non-forced checks run at short range: if DA fails there,
                # the appearance regime is bad and every check will insert
                self._da_dead = c["res"].best_tracked < self.opts.updated_matches_th
            hit = (d["insert"] == c["ins"]) and (d["insert"] or d["new_tr_th"] is None)
            if not hit:
                if self._demote_shrink_miss(c, d):
                    # an immaterial shrink: the tail's walk is the same under
                    # the shrunk thresholds; apply them and go on
                    self._apply_no_insert(d)
                    continue
                self._miss_recover(c, d)
                return
            if d["insert"]:
                ids = self._kf_apply(d, self._spec_frame(c) if self.debug.enabled else None,
                                     c["res"], initial_rel=c["incr_at_check"], pre_written=True)
                self._spec_ids[c["id_base"]] = ids
        # every check resolved without a replay: the walk log is spent
        self._walk_log = []
        if any(c["ins"] for c in checks):
            self.last_kf_pose = self.rba.kf_global[self.store.n_kfs - 1].copy()
            self.current_pose = se3_np.compose(self.last_kf_pose, self.incr_from_last_kf)
            self._pose_dirty = False

    def _demote_shrink_miss(self, c: dict, d: dict) -> bool:
        """Is this miss a pure threshold shrink whose tail is unaffected?

        A check predicted and decided no insert but shrank the dynamic
        thresholds (≙ reference .cpp:525-541). Shrinking only adds
        triggers, and only for the frames between this check and the next
        check of the walk: if none of them had walk-time norms above the
        shrunk values, the triggered frames, and every later decision, are
        the same, so the outcome applies without a replay (the next
        check's resolution covers the frames after it, with the shrink
        applied)."""
        if d["insert"] or c["ins"] or d["new_tr_th"] is None:
            return False  # a mispredicted outcome: the tail really diverges
        f_c = c["res"].frame_idx
        for (f, t_chk, r_chk, was_check) in self._walk_log:
            if f <= f_c:
                continue
            if was_check:
                break
            if t_chk > d["new_tr_th"] or r_chk > d["new_rot_th"]:
                return False  # material: this frame would now trigger
        return True

    def _dry_tracked(self, snap, b_rec: dict, j0: int) -> np.ndarray:
        """The tracked-from-keyframe counts of frames [j0, b) of a batch
        under the snapshot's keyframe reference, as ``commit_frame`` would
        count them with no insertion on the way (host only)."""
        (_prev, ids, _inc, _next), kf_ids = snap
        kf = np.fromiter(kf_ids, np.int64) if kf_ids else np.zeros(0, np.int64)
        ids = ids.copy()
        out = []
        for j in range(j0, b_rec["b"]):
            tv, mv = b_rec["track_valid"][j], b_rec["m_valid"][j]
            nxt = np.full(self.capacity, -1, np.int64)
            nxt[tv] = ids[b_rec["track_idx"][j][tv]]
            nxt[~mv] = -1
            out.append(int(np.isin(nxt[nxt >= 0], kf).sum()))
            ids = nxt
        return np.asarray(out, np.int64)

    def _shrink_tail_ok(self, c: dict, d: dict) -> bool:
        """Can the fast replay handle this shrink miss? Dry-runs the tail's
        triggers under the shrunk thresholds on the batch's host summary:
        every newly triggered check must predict no insert (force off,
        tracking well above the threshold, DA alive), since a predicted
        no-insert changes no reference state."""
        snap = c["snap"]
        b_rec = snap["batch"]
        nm, poses, pose_valid = b_rec["nm"], b_rec["poses"], b_rec["pose_valid"]
        tracked_all = self._dry_tracked(snap["vo"], b_rec, snap["j"] + 1)
        incr_kf = snap["incr_kf"].copy()
        incr_chk = np.zeros(6)
        o = self.opts
        for n, j in enumerate(range(snap["j"] + 1, b_rec["b"])):
            if not bool(pose_valid[j]) or int(nm[j]) < 8:
                continue  # skip frame: no motion integrated (≙ .cpp:318-323)
            tracked = int(tracked_all[n])
            motion = se3_np.inverse(poses[j].astype(np.float64))
            incr_kf = se3_np.compose(incr_kf, motion)
            incr_chk = se3_np.compose(incr_chk, motion)
            force = (np.linalg.norm(incr_kf[3:]) > 2.0 * o.max_translation
                     or np.rad2deg(np.linalg.norm(incr_kf[:3])) > 2.0 * o.max_rotation)
            check = (force or tracked < o.vo_id_tracking_th
                     or np.linalg.norm(incr_chk[3:]) > d["new_tr_th"]
                     or np.rad2deg(np.linalg.norm(incr_chk[:3])) > d["new_rot_th"])
            if not check:
                continue
            if force or tracked < 1.2 * o.updated_matches_th or self._da_dead:
                return False  # would predict an insert: the reference moves
            incr_chk = np.zeros(6)
        return True

    def _shrink_replay(self, c: dict, d: dict):
        """The fast replay of a pure threshold-shrink miss (gated by
        :meth:`_shrink_tail_ok`): no insertion happened at the check and
        none is predicted in the tail, so restore the walk state at the
        check, apply the shrink and walk the tail again with deferred
        checks, which ride the next read. No read here."""
        snap = c["snap"]
        self.frame_idx = snap["frame_idx"]
        del self.step_log[snap["log_len"]:]
        self.incr_from_last_kf = snap["incr_kf"].copy()
        self.incr_from_last_check = np.zeros(6)
        self._apply_no_insert(d)  # the true outcome: shrunk thresholds
        b_rec = snap["batch"]
        self._vo_restore(snap["vo"])
        self._da_seed = snap["da_seed"]
        self._walk_log = []  # the walk reuses the rewound frame indices
        if self.store.n_kfs:
            self.last_kf_pose = self.rba.kf_global[self.store.n_kfs - 1].copy()
        self.current_pose = se3_np.compose(self.last_kf_pose, self.incr_from_last_kf)
        self._pose_dirty = False
        self._process_frames(b_rec, snap["j"] + 1, b_rec["b"], defer=True)
        self._dispatch_planned_checks()

    def _miss_recover(self, c: dict, d: dict):
        """A wrong prediction at check ``c``: restore the snapshot taken at
        the check, apply the true outcome, and walk the rest of its batch
        again with synchronous checks (the later deferred checks were
        dropped by the caller; their speculative rows are inert and the
        next real insertions overwrite them)."""
        if (not self._in_walk and self._virtual_bp and not c["snap"]["host_mode"]
                and not d["insert"] and not c["ins"] and d["new_tr_th"] is not None
                and self._shrink_tail_ok(c, d)):
            self._shrink_replay(c, d)
            return
        self._replay_flag = True
        self._walk_log = []
        snap = c["snap"]
        self.frame_idx = snap["frame_idx"]
        del self.step_log[snap["log_len"]:]
        self.incr_from_last_kf = snap["incr_kf"].copy()
        self.incr_from_last_check = np.zeros(6)
        self.updated_translation_th = snap["tr_th"]
        self.updated_rotation_th = snap["rot_th"]
        b_rec = snap["batch"]
        self._vo_restore(snap["vo"])
        self._virtual_bp = False
        self._da_seed = snap["da_seed"]
        if d["insert"]:
            # a late insertion: written at the real row now
            ids = self._kf_apply(d, self._spec_frame(c), c["res"], initial_rel=snap["incr_kf"])
            self.incr_from_last_kf = np.zeros(6)
            self.current_pose = self.last_kf_pose.copy()
            self.vo.set_frame_ids(ids, set(int(i) for i in ids if i >= 0))
        else:
            self._apply_no_insert(d)
            if self.store.n_kfs:
                self.last_kf_pose = self.rba.kf_global[self.store.n_kfs - 1].copy()
            self.current_pose = se3_np.compose(self.last_kf_pose, self.incr_from_last_kf)
        self._pose_dirty = False
        self._process_frames(b_rec, snap["j"] + 1, b_rec["b"], defer=False)

    def _resolve_pending_checks(self):
        """Land the deferred checks and the launched window solves (one
        read a round; a fast shrink replay defers again, and another round
        resolves those)."""
        self._dispatch_planned_checks()
        first_round = True
        while True:
            if not self._spec:
                if first_round:
                    self.rba.flush()
                self._reanchor_if_dirty()
                return
            pend = self.rba.pending_device_arrays()
            spec_handles = [h for c in self._spec for h in c["handles"]]
            pulled = to_host(list(pend) + spec_handles)
            if pend:
                self.rba.commit_pending(pulled[:len(pend)])
            self._replay_flag = False
            self._resolve_spec(pulled[len(pend):])
            self._reanchor_if_dirty()
            if self._replay_flag or not self._spec:
                return
            self._dispatch_planned_checks()
            first_round = False

    def _materialize_engine_ids(self):
        """Give the VO engine its keyframe's real IDs where its tracks
        still chain to a speculative insert's placeholders (the insert
        resolved since), so per-frame stepping, a checkpoint or the fleet
        continue from the batched state."""
        eng = self.vo
        spec = [i for i in eng._kf_id_set if i >= _SPEC_ID_BASE]
        if spec:
            # the resolved insert whose placeholder range holds the set
            base = next(b for b in self._spec_ids if b <= min(spec) < b + self.capacity)
            real = self._spec_ids[base]
            for name in ("_prev_ids", "_cur_ids"):
                ids = getattr(eng, name)
                if ids is None:
                    continue
                slot = _chain_slotmaps(ids, base, self.capacity)
                setattr(eng, name, np.where(slot >= 0, real[np.maximum(slot, 0)], ids))
            eng._kf_id_set = set(int(i) for i in real if i >= 0)
        self._spec_ids = {}

    def _sync_bp_from_engine(self):
        """(Re)enter the batched walk from the engine's state: the walk's
        chains are the VO engine's IDs already, so only the speculation
        state starts afresh."""
        self._virtual_bp = False
        self._walk_log = []
        self._spec_ids = {}

    def _finish_batched(self):
        """Resolve all speculative state; batched results become final."""
        self._resolve_pending_checks()
        self._materialize_engine_ids()

    # ------------------------------------------------------------------ step
    def step(self, left: np.ndarray, right: np.ndarray) -> StepResult:
        self.frame_idx += 1
        res = StepResult(self.frame_idx)
        self.step_log.append(res)

        if self.store.n_kfs == 0:
            self._insert_first_kf(left, right, res)
            return res

        self._walk_frame(res, self._vo_with_adaptive_retry(left, right, res))
        return res

    def _walk_frame(self, res: StepResult, vo):
        """The host walk of one frame after its VO (``vo``, None for a
        hopeless frame): pose integration and the keyframe triggers
        (:meth:`_walk_head`), and when one fires, the keyframe check
        (:meth:`_kf_check`) and its decision (:meth:`_walk_tail`).
        Per-frame stepping and the batched walk call the three in a row;
        the fleet calls every sequence's head, one check for all the
        sequences that check, then their tails."""
        force_new_kf = self._walk_head(res, vo)
        if force_new_kf is not None:
            frame = self.vo.last_frame()
            self._walk_tail(res, frame, force_new_kf, self._kf_check(frame))

    def _walk_head(self, res: StepResult, vo) -> bool | None:
        """Pose integration and the keyframe triggers of one frame. Returns
        None when no check fires, else the check's force-new-KF flag."""
        if vo is None or not vo.valid:
            return None  # skip frame (≙ reference .cpp:318-323)
        res.vo_valid = True
        res.n_stereo_matches = vo.num_stereo_matches
        res.tracked_from_last_kf = vo.tracked_from_last_kf
        self._buffer_voc_frame(self.vo.last_frame())

        # pose integration (≙ .cpp:327-330): the increment maps prev->cur
        # points, so camera motion is its inverse
        motion = se3_np.inverse(vo.pose_increment.astype(np.float64))
        self.current_pose = se3_np.compose(self.current_pose, motion)
        self.incr_from_last_kf = se3_np.compose(self.incr_from_last_kf, motion)
        self.incr_from_last_check = se3_np.compose(self.incr_from_last_check, motion)

        force_new_kf, check, t_chk, r_chk = self._kf_triggers(vo.tracked_from_last_kf)
        if self._in_walk:
            # the batched walk's trigger norms, read by _demote_shrink_miss
            self._walk_log.append((self.frame_idx, t_chk, r_chk, check))
        if not check:
            return None
        res.kf_check = True
        self.incr_from_last_check = np.zeros(6)
        return force_new_kf

    def _walk_tail(self, res: StepResult, frame, force_new_kf: bool, pulled):
        """The keyframe decision from a check's host outputs ``pulled``,
        and the hand-over of an inserted keyframe's IDs to the VO engine."""
        ids = self._kf_check_host(pulled, frame, res, force_new_kf)
        if ids is not None:
            self.vo.set_frame_ids(ids, set(int(i) for i in ids if i >= 0))

    def _kf_triggers(self, tracked_from_last_kf: int) -> tuple[bool, bool, float, float]:
        """KF-check triggers (≙ reference .cpp:366-394): hard force limit at
        2x the configured translation/rotation, tracking-count trigger, and
        the dynamic since-last-check distance trigger. Returns
        (force_new_kf, check, t_chk, r_chk), the last two the norms since
        the last check."""
        t_kf = np.linalg.norm(self.incr_from_last_kf[3:])
        r_kf = np.rad2deg(np.linalg.norm(self.incr_from_last_kf[:3]))
        t_chk = float(np.linalg.norm(self.incr_from_last_check[3:]))
        r_chk = float(np.rad2deg(np.linalg.norm(self.incr_from_last_check[:3])))
        force_new_kf = (t_kf > 2.0 * self.opts.max_translation
                        or r_kf > 2.0 * self.opts.max_rotation)
        check = (force_new_kf
                 or tracked_from_last_kf < self.opts.vo_id_tracking_th
                 or t_chk > self.updated_translation_th
                 or r_chk > self.updated_rotation_th)
        return force_new_kf, check, t_chk, r_chk

    # ------------------------------------------------------- adaptive VO
    def _vo_with_adaptive_retry(self, left, right, res: StepResult):
        """One frame's VO under the adaptive retry protocol (:meth:`adaptive_vo`),
        each pass a ``process_stereo_pair`` of the frame."""
        proto = self.adaptive_vo()
        next(proto)
        try:
            while True:
                proto.send(self.vo.process_stereo_pair(left, right))
        except StopIteration as done:
            return done.value

    def adaptive_vo(self):
        """≙ the FAST/ORB threshold retry protocol (reference .cpp:263-315),
        run only when orb_adaptive_fast_th is set (≙ the gate at .cpp:271);
        otherwise one plain VO pass. A generator: each ``yield`` asks for one
        VO pass of the frame at the engine's thresholds and takes its
        VOResult (``send``); it returns the frame's result, None for a
        hopeless frame. Per-frame stepping drives it with one frame; the
        fleet drives one per sequence and batches their passes."""
        if not self.opts.orb_adaptive_fast_th:
            vo = yield
            return None if vo.num_stereo_matches < 8 else vo
        th_min_matches = self.opts.adaptive_th_min_matches
        vo = None
        for _attempt in range(6):
            state = self.vo.get_state()
            vo = yield
            if vo.num_stereo_matches >= th_min_matches:
                break
            if not self.vo.retry_step():
                break
            self.vo.set_state(state)  # re-process the same frame
        n = vo.num_stereo_matches
        if n < 8:
            return None  # hopeless frame (≙ abort below 8 matches)
        self.vo.drift_thresholds(n, th_min_matches)
        return vo

    # ------------------------------------------------------------ first KF
    def _insert_first_kf(self, left, right, res: StepResult):
        """≙ the FIRST FRAME branch (reference .cpp:82-216)."""
        vo = self.vo.process_stereo_pair(left, right)
        frame = self.vo.last_frame()
        self._buffer_voc_frame(frame)
        ids = self._mint_fresh_ids(frame.m_valid.cpu().numpy())
        kf_id = self.store.append(frame, ids, self.current_pose)
        if self.bow is not None:
            self.bow.insert(frame.desc_l, frame.m_valid)
        # else: the vocabulary is still accumulating (voc_train_frames);
        # ensure_vocabulary backfills this KF's DB row from the store
        obs = self._build_obs(frame, ids)
        self.rba.define_new_keyframe(obs, run_opt=False)
        self.vo.set_frame_ids(ids, set(ids[ids >= 0]))
        self.debug.dump_kf(kf_id, frame, ids)
        res.vo_valid = True
        res.inserted_kf = kf_id
        res.n_stereo_matches = vo.num_stereo_matches
        self.kf_stats.append(TStatsSRBA(0.0, 1, int((ids >= 0).sum()), 0))
        if self.general.show3D:
            self._live_viz_snapshot()  # the live view exists from KF0 on

    def _buffer_voc_frame(self, frame):
        """Keep a processed frame's descriptors for the fallback vocabulary
        (no voc_filename configured): the first ``voc_train_frames`` valid
        frames, as device tensors (one copy at training time)."""
        if self.bow is not None or not self._pending_voc_training:
            return
        if len(self._voc_buffer) >= max(1, self.opts.voc_train_frames):
            return
        if self._voc_buffer and self._voc_buffer[-1][0] >= self.frame_idx:
            return
        self._voc_buffer.append((self.frame_idx, frame.desc_l, frame.m_valid))

    def ensure_vocabulary(self, limit_fidx: int | None = None):
        """No vocabulary file: train one from the descriptors of the first
        ``voc_train_frames`` frames (framework capability beyond the
        reference, which requires a prebuilt voc.yml.gz — CBoWManager.h:
        59-66). Called at the first keyframe check; keyframes inserted before
        get their BoW rows backfilled from the store. ``limit_fidx``
        restricts training to frames <= that index."""
        if self.bow is not None:
            return
        ents = [e for e in self._voc_buffer if limit_fidx is None or e[0] <= limit_fidx]
        if ents:
            dh, vh = to_host([torch.stack([d for _, d, _ in ents]),
                              torch.stack([v for _, _, v in ents])])
            desc = dh.reshape(-1, dh.shape[-1])[vh.ravel()]
        else:
            desc = np.zeros((0, 8), np.uint32)
        if len(desc) < 32:  # degenerate; random fallback
            desc = np.random.default_rng(0).integers(
                0, 2**32, (1024, 8), dtype=np.uint64).astype(np.uint32)
        # deeper tree once the corpus supports it (k=8: L=3 -> 512 leaves,
        # L=4 -> 4096)
        L = 4 if len(desc) >= 2048 else 3
        voc = Vocabulary.train(desc, k=8, L=L, seed=0)
        self.bow = BoWDatabase(voc, max_kfs=self.max_kfs, device=self.device)
        if self.store.n_kfs:
            self.bow.rebuild_from_store(self.store.arrays, self.store.n_kfs)
        self._pending_voc_training = False
        self._voc_buffer = []

    # ------------------------------------------------------------- KF check
    def check_options(self) -> dict:
        """The keyframe check's options, as keyword arguments of
        ``query_and_associate``."""
        o = self.opts
        return dict(max_orb_distance_da=o.max_orb_distance_da, residual_th=o.residual_th,
                    max_y_diff_epipolar=o.max_y_diff_epipolar,
                    filter_by_direction=o.da_filter_by_direction,
                    filter_by_orb_distance=o.da_filter_by_orb_distance,
                    use_fund_matrix=o.da_filter_by_fund_matrix,
                    use_change_pose=o.da_filter_by_pose_change,
                    kernel_param=self.vo_opts.kernel_param, ransac_n_hyp=self._ransac_n_hyp)

    def next_check_key(self) -> int:
        """The vocabulary for a keyframe check (trained at the first one),
        and the check's seed of the DA RNG stream."""
        self.ensure_vocabulary(limit_fidx=self.frame_idx)
        sub = prng.check_seed(self._da_seed)
        self._da_seed += 1
        return sub

    def capture_check_program(self):
        """On a card, capture the one-check program of this estimator's
        store and database now (a program is keyed by the tensors it
        holds, so each estimator has its own): one read-only check of the
        VO engine's last frame, its outputs dropped and the DA stream
        untouched. The bench harness calls it after its warm-up, whose
        first fused group captured the slot program, so that a replay of a
        wrong prediction in a timed part captures nothing. Nothing on the
        CPU, or before the first check."""
        if self.device.type != "cuda" or self.bow is None or self.vo._prev is None:
            return
        query_and_associate_packed(self.vo._prev, self.store.arrays, self.bow._db,
                                   self.bow._leaf_bits, self.bow._weights, self.store.n_kfs,
                                   self.cam, 0, debug=self.debug.enabled, **self.check_options())

    def _kf_check(self, frame) -> list:
        """BoW query and DA cascade of ``frame`` on the device (on a card
        one replay of the one-check program, its count and seed device
        inputs), its packed outputs and the launched window solves copied to
        the host in one copy, the solves committed (the decision is
        :meth:`_kf_check_host`)."""
        sub = self.next_check_key()
        with self.profiler.section("queryDB"):
            handles = query_and_associate_packed(
                frame, self.store.arrays, self.bow._db, self.bow._leaf_bits,
                self.bow._weights, self.store.n_kfs, self.cam, sub,
                debug=self.debug.enabled, **self.check_options())
        with self.profiler.section("performDA"):
            pend = self.rba.pending_device_arrays()
            pulled = to_host(list(handles) + list(pend))
            if pend:
                self.rba.commit_pending(pulled[len(handles):])
            self._reanchor_if_dirty()
        return pulled[:len(handles)]

    def _kf_check_host(self, pulled, frame, res: StepResult, force_new_kf: bool):
        """Host half of the keyframe check: similar-KF selection, LC
        confirmation, the insertion decision and the insertion itself."""
        d = self._kf_decide(pulled, res, force_new_kf)
        if not force_new_kf:
            self._da_dead = res.best_tracked < self.opts.updated_matches_th
        if not d["insert"]:
            self._apply_no_insert(d)
            return None
        ids = self._kf_apply(d, frame, res, initial_rel=self.incr_from_last_kf)
        # reset accumulators (≙ .cpp:662-663, 922-923)
        self.current_pose = self.last_kf_pose.copy()
        self.incr_from_last_kf = np.zeros(6)
        return ids

    def _kf_decide(self, pulled, res: StepResult, force_new_kf: bool) -> dict:
        """The insertion decision from the check's host outputs (one packed
        blob, or the fleet's arrays): similar-KF selection + LC confirmation
        (≙ .cpp:483-545). Mutates only logs; threshold changes are returned
        for the caller to apply, so a deferred check decides late exactly."""
        if len(pulled) == 1:
            pulled = unpack_check_outputs(pulled[0], s=MAX_SIMILAR, k=self.capacity, nq=4,
                                          debug=self.debug.enabled)
            extras = pulled[11] if len(pulled) > 11 else None
        else:
            extras = (dict(zip(("raw_oidx", "distance", "residuals"), pulled[11:]))
                      if len(pulled) > 11 else None)
        (scores, ids, da_status_all, da_oidx_all, tracked_all, f_m_valid,
         f_xs_l, f_ys_l, f_xs_r, f_m_r, f_pts) = pulled[:11]
        self.query_log.append((res.frame_idx, np.asarray(scores).copy(),
                               np.asarray(ids).copy()))
        if len(scores) and scores[0] < self.opts.query_score_th:
            # ≙ the "Lost camera?" warning (reference .cpp:1748-1751)
            self.log(1, "Best BoW query score below query_score_th — lost camera?")
        with self.profiler.section("get_similar_kfs"):
            similar, lc_candidate = self._get_similar_kfs(scores, ids)
        if scores[0] < 0.05:
            force_new_kf = True  # "lost camera?" floor (≙ .cpp:439-440)

        # reindex the candidate rows (0 = prev KF, 1+r = BoW result r) onto
        # the selected similar list
        prev_kf = self.store.n_kfs - 1
        pos_of = {prev_kf: 0}
        for r, i in enumerate(ids):
            pos_of.setdefault(int(i), 1 + r)
        positions = [pos_of[s] for s in similar]
        da_status = da_status_all[positions]
        da_oidx = da_oidx_all[positions]
        tracked = tracked_all[positions]
        self.debug.dump_da_host(self.store.n_kfs, similar, da_status, da_oidx, tracked)
        da_dists = None
        if extras is not None:
            da_dists = extras["distance"][positions]
            self._dump_match_artifacts(similar, da_status, extras, positions,
                                       f_m_valid, f_xs_l, f_ys_l)
        order = np.argsort(-tracked)  # ≙ DATrackedSorter ranking
        best = int(tracked[order[0]]) if len(order) else 0
        res.best_tracked = best

        # LC confirmation (≙ .cpp:483-545): a confirmed loop closure forces
        # the insertion; an unconfirmed potential LC neither inserts (beyond
        # voForceNewKf) nor shrinks thresholds; without a potential LC the
        # check inserts below updated_matches_th or shrinks the dynamic
        # thresholds from the tracked-feature surplus (.cpp:525-541)
        lc_confirmed = None
        insert = force_new_kf
        new_tr_th = new_rot_th = None
        with self.profiler.section("confirmLC"):
            if lc_candidate is not None:
                lc_pos = similar.index(lc_candidate)
                if tracked[lc_pos] > 0.5 * best:
                    lc_confirmed = lc_candidate
                    insert = True
                    order = np.concatenate(
                        [[lc_pos], [o for o in order if o != lc_pos]]).astype(int)
            else:
                if best < self.opts.updated_matches_th:
                    insert = True
                elif best <= self.opts.updated_matches_th + self.opts.up_matches_th_plus:
                    olimit = self.opts.updated_matches_th + self.opts.up_matches_th_plus
                    new_tr_th = update_translation_threshold(
                        best - self.opts.updated_matches_th, self.opts.up_matches_th_plus)
                    new_rot_th = update_rotation_threshold(best, olimit)
        return dict(
            insert=insert, similar=similar, order=order, tracked=tracked,
            da_status=da_status, da_oidx=da_oidx, lc_confirmed=lc_confirmed,
            f_m_valid=f_m_valid, f_xs_l=f_xs_l, f_ys_l=f_ys_l, f_xs_r=f_xs_r,
            f_m_r=f_m_r, f_pts=f_pts, new_tr_th=new_tr_th, new_rot_th=new_rot_th,
            da_dists=da_dists,
        )

    def _dump_match_artifacts(self, similar, da_status, extras, positions,
                              m_valid, xs_l, ys_l):
        """Write the per-candidate match files of the reference's
        ``debug=true`` mode: ``if_raw_match*`` (pre-filter matches,
        reference .cpp:1455-1473), ``if_match_after*`` (post-cascade status
        per match, .cpp:1649-1721) and ``posechange_outliers*`` (filter-4
        residual outliers, .cpp:2236-2251: one file per new KF, the last
        cascade call's content surviving, as in the reference)."""
        kf_id = self.store.n_kfs
        raw_oidx = extras["raw_oidx"][positions]
        distance = extras["distance"][positions]
        residuals = extras["residuals"][positions]
        # the other KFs' left keypoints: one device read, debug mode only
        oth_x, oth_y = to_host([self.store.arrays.xs_l[similar],
                                self.store.arrays.ys_l[similar]])
        for s, other_kf in enumerate(similar):
            self.debug.dump_if_raw_match(
                kf_id, other_kf, xs_l, ys_l, oth_x[s], oth_y[s],
                raw_oidx[s], distance[s], m_valid)
            self.debug.dump_if_match_after(
                kf_id, other_kf, da_status[s], xs_l, ys_l, oth_x[s],
                oth_y[s], raw_oidx[s], distance[s], m_valid)
        if len(similar):
            s = len(similar) - 1
            sel = np.nonzero(m_valid & (distance[s] < 1e8)
                             & (residuals[s] > self.opts.residual_th))[0]
            self.debug.dump_posechange_outliers(kf_id, sel, residuals[s][sel])

    def _apply_no_insert(self, d: dict):
        """Threshold shrink of the no-insert branch (≙ .cpp:525-541)."""
        if d["new_tr_th"] is not None:
            self.updated_translation_th = d["new_tr_th"]
            self.updated_rotation_th = d["new_rot_th"]

    def _kf_apply(self, d: dict, frame, res: StepResult, initial_rel: np.ndarray,
                  pre_written: bool = False):
        """INSERT NEW KF (≙ .cpp:563-924) from a positive decision.
        ``initial_rel`` is the pose increment since the previous keyframe
        at the check (for ``use_initial_pose``). ``pre_written``: a
        deferred check wrote the keyframe's store and BoW rows already, so
        only the counts and host fields commit (``frame`` may be None).
        Returns the keyframe's match IDs."""
        t0 = time.perf_counter()
        ids, n_new, n_common = self._propagate_ids(
            d["f_m_valid"], d["da_status"], d["da_oidx"], d["similar"], d["order"],
            dists=d.get("da_dists"))
        obs = self._build_obs_host(d["f_m_valid"], d["f_xs_l"], d["f_ys_l"],
                                   d["f_xs_r"], d["f_m_r"], d["f_pts"], ids)
        if d["lc_confirmed"] is not None:
            self.rba.loop_closure_detected(True)
            self.rba.set_lc_old_id(d["lc_confirmed"])
            res.loop_closure_with = d["lc_confirmed"]
            self.debug.dump_loop_closure(self.store.n_kfs, d["lc_confirmed"],
                                         int(d["tracked"][d["order"][0]]))
        if self.opts.use_initial_pose:
            self.rba.set_initial_kf_pose(initial_rel)
        if self.solve_flush_before_insert and not self.solve_sync:
            # the middle schedule: the launched solves land before this
            # insertion builds its window
            with self.profiler.section("solve_flush"):
                self.rba.flush()
        with self.profiler.section("define_kf"):
            try:
                info = self.rba.define_new_keyframe(obs, run_opt=True)
                if (d["lc_confirmed"] is not None
                        and self.rba.lc_rejects_last_insert):
                    # the confirmed closure's edge failed the creation-time
                    # consistency gate (aliased consensus): attempt the
                    # odometry-seeded recovery before giving the closure up
                    tgt = self.rba._area_of(d["lc_confirmed"])
                    if any(self.rba._area_of(u) == tgt
                           for (u, _v) in self.rba.lc_rejects_last_insert):
                        if not self._lc_recovery(d, info.kf_id, d["lc_confirmed"], ids,
                                                 frame):
                            res.lc_rejected_with = d["lc_confirmed"]
                            res.loop_closure_with = None
                if self.solve_sync:
                    # strict schedule: the insertion's solves land now
                    self.rba.flush()
            except Exception as exc:
                # ≙ the reference's exception epilogue around
                # define_new_keyframe (.cpp:792-839)
                self.emergency_epilogue(exc)
                raise
        kf_id = info.kf_id
        new_global = self.rba.kf_global[kf_id].copy()
        if pre_written:
            committed = self.store.commit_row(ids, new_global)
            assert committed == kf_id
            self.bow.commit_row()
        else:
            self.store.append(frame, ids, new_global)
            self.bow.insert(frame.desc_l, frame.m_valid)
        if frame is not None:
            self.debug.dump_kf(kf_id, frame, ids)
        # restore thresholds (≙ .cpp:662-663)
        self.updated_translation_th = float(self.opts.max_translation)
        self.updated_rotation_th = float(self.opts.max_rotation)
        self.last_kf_pose = new_global.copy()
        dt = (time.perf_counter() - t0) * 1e3
        res.inserted_kf = kf_id
        res.define_kf_ms = dt
        self.kf_stats.append(TStatsSRBA(dt, self.store.n_kfs, n_new, n_common))
        if self.general.show3D:
            self._live_viz_snapshot()
        return ids

    def _last_query_scores(self):
        """The last keyframe check's ranked BoW scores placed at their KF
        ids (the viewers' score bars); None before the first check."""
        if not self.query_log:
            return None
        _f, sc, qids = self.query_log[-1]
        q_scores = np.zeros(self.store.n_kfs)
        for s_, i_ in zip(sc, qids):
            if 0 <= int(i_) < len(q_scores):
                q_scores[int(i_)] = s_
        return q_scores

    def _typed_edges(self) -> list:
        kinds = {0: "submap", 1: "base", 2: "lc"}
        return [(self.rba._edge_u[e], self.rba._edge_v[e],
                 kinds.get(int(self.rba._edge_kind[e]), "submap"))
                for e in range(self.rba.n_edges) if self.rba._edge_valid[e]]

    def _kf_frame_indices(self) -> list:
        return [r.frame_idx for r in self.step_log if r.inserted_kf is not None]

    def _live_viz_snapshot(self):
        """Per-keyframe map snapshot (headless stand-in for the reference's
        live CDisplayWindow3D updates, .cpp:1262-1338): overwrite
        ``<out_dir>/live_map.png`` with the current trajectory and the
        latest BoW query bars after every insertion, and
        ``live_map.json``, the payload the live browser viewer
        (utils/live_server, ``--serve``) polls once a second. finalize()
        still renders the final optimized map."""
        out_dir = self.general.out_dir or "out"
        try:
            from srba_slam_tpu_torch.utils.viz import render_map_png

            os.makedirs(out_dir, exist_ok=True)
            q_scores = self._last_query_scores()
            # raw camera-frame poses mid-run: plot the x-z ground plane
            render_map_png(
                os.path.join(out_dir, "live_map.png"),
                self.rba.kf_global[:self.store.n_kfs], query_scores=q_scores,
                query_score_th=self.opts.query_score_th, plane=(0, 2),
            )
            self._write_live_json(out_dir, q_scores)
        except Exception as exc:  # viz must never kill the pipeline
            self.log(1, f"live viz snapshot failed: {exc!r}")

    def _write_live_json(self, out_dir: str, q_scores=None):
        """Dump the current (mid-run, pre-epilogue) map as live_map.json for
        the polling browser viewer. Atomic rename, so the poller never reads
        a half-written file."""
        import json

        from srba_slam_tpu_torch.utils.html_viewer import build_map_data

        data = build_map_data(
            self.rba.kf_global[:self.store.n_kfs],
            edges=self._typed_edges(),
            query_scores=q_scores,
            query_score_th=self.opts.query_score_th,
            kf_frames=self._kf_frame_indices(),
            title="srba_slam_tpu_torch live map (camera frame, mid-run)",
        )
        tmp = os.path.join(out_dir, ".live_map.json.tmp")
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, os.path.join(out_dir, "live_map.json"))

    @property
    def current_world_pose(self) -> np.ndarray:
        """Camera pose in the world/robot frame: E ∘ T_cam (≙ m_current_pose,
        reference .cpp:922, :1112)."""
        return se3_np.compose(self.sensor_pose, self.current_pose)

    def _lc_recovery(self, d: dict, kf_id: int, lc_kf: int, ids: np.ndarray,
                     frame) -> bool:
        """Recover an aliasing-rejected confirmed loop closure (framework
        extension; no reference counterpart): (1) re-run the single-candidate
        DA with the change-in-pose solve seeded from the odometry-implied
        relative pose (recheck_candidate); (2) if it tracks enough (>= 15
        and >= 0.5*best, the reference's own confirmation bar), re-propagate
        those match IDs and re-attach the observations to the far
        landmarks; (3) retry the loop-closure edge. Mutates ``ids`` in place
        so the keyframe row commits the recovered IDs. Returns True when
        the edge was re-created."""
        # the recovery is an odometry-prior-seeded change-in-pose re-check:
        # only under a DA that uses pose-prior seeds and the change-pose
        # stage (≙ the ST2M_CHANGEPOSE / ST2M_BOTH gate, .cpp:1372-1380)
        if self.opts.da_stage2_method not in (2, 3) or not self.opts.da_filter_by_pose_change:
            return False
        if frame is not None:
            self.store.write_row(frame, kf_id)  # the new KF's row is not in the store yet
        init = se3_np.relative(self.rba.kf_global[lc_kf], self.rba.kf_global[kf_id])
        sub = self._da_seed
        self._da_seed += 1
        out = recheck_candidate(
            self.store.arrays, kf_id, lc_kf, self.cam,
            torch.as_tensor(init, dtype=torch.float32, device=self.device), sub,
            max_orb_distance_da=self.opts.max_orb_distance_da,
            residual_th=self.opts.residual_th,
            max_y_diff_epipolar=self.opts.max_y_diff_epipolar,
            filter_by_direction=self.opts.da_filter_by_direction,
            filter_by_orb_distance=self.opts.da_filter_by_orb_distance,
            use_fund_matrix=self.opts.da_filter_by_fund_matrix,
            kernel_param=self.vo_opts.kernel_param,
            ransac_n_hyp=self._ransac_n_hyp,
            # hard residual pre-gate at the odometry prior: without it the
            # recovery GN converges back into the aliased basin
            init_gate_budget_m=self.rba.lc_budget(lc_kf, kf_id),
        )
        status, oidx, tracked, _pose = to_host(out)
        best = int(max(d["tracked"])) if len(d["tracked"]) else 0
        if int(tracked) < max(15, int(0.5 * best)):
            self.log(1, f"kf{kf_id}: LC recovery re-check tracked only "
                        f"{int(tracked)} (need >= {max(15, int(0.5 * best))})")
            return False
        other_ids = self.store.match_ids[lc_kf]
        used = {int(i) for i in ids if i >= 0}
        pairs = []
        for f in np.nonzero((status == S_TRACKED) & (ids >= 0))[0]:
            new_id = int(other_ids[oidx[f]])
            old_id = int(ids[f])
            if new_id < 0:
                continue
            if new_id != old_id and new_id in used:
                continue  # duplicate guard (≙ the foundIds guard, .cpp:596)
            pairs.append((old_id, new_id))
            if new_id != old_id:
                ids[f] = new_id
                used.add(new_id)
        if not pairs:
            return False
        n_moved = self.rba.reassociate_obs(kf_id, pairs, self.rba._area_of(lc_kf))
        ok = self.rba.retry_lc_edge(kf_id, lc_kf)
        self.log(1, f"kf{kf_id}: LC recovery vs kf{lc_kf}: tracked {int(tracked)}, "
                    f"{len(pairs)} id updates, {n_moved} obs re-attached, edge "
                    f"{'created' if ok else 'NOT created'}")
        return ok

    def _on_lc_reject(self, root: int, target_center: int, stage: str):
        """A loop-closure edge was rejected by the validator. For post-solve
        (layer B) rejections the insertion already logged a confirmed LC;
        move it to ``lc_rejected_with`` (creation-time rejections are
        handled inline in :meth:`_kf_apply`)."""
        if stage != "solve":
            return
        for r in self.step_log:
            if r.inserted_kf == root and r.loop_closure_with is not None:
                r.lc_rejected_with = r.loop_closure_with
                r.loop_closure_with = None

    def _on_rba_commit(self, kf_id: int, old_global: np.ndarray, new_global: np.ndarray):
        """A window solve landed: record it and mark the pose bookkeeping
        dirty; :meth:`_reanchor_if_dirty` re-derives it at the next check."""
        if kf_id < self.store.n_kfs:
            self.store.set_pose(kf_id, new_global)
        self._pose_dirty = True

    def _reanchor_if_dirty(self):
        """Re-derive the pose bookkeeping from the committed graph, using
        the invariant current_pose = last_kf_global ∘ incr_from_last_kf:
        valid once the accumulated increment is measured from the last
        committed keyframe, that is with no deferred check unresolved."""
        if not self._pose_dirty or self._spec:
            return
        self._pose_dirty = False
        if self.store.n_kfs:
            self.last_kf_pose = self.rba.kf_global[self.store.n_kfs - 1].copy()
            self.current_pose = se3_np.compose(self.last_kf_pose, self.incr_from_last_kf)

    def _get_similar_kfs(self, scores, ids):
        """≙ m_get_similar_kfs (reference .cpp:1737-1878): prev KF always in;
        BoW results with score > 0.8*best; LC candidate = far-away (topo
        distance from the current submap base > lc_distance) with score > 0.05."""
        prev_kf = self.store.n_kfs - 1
        similar = [prev_kf]
        best = scores[0] if len(scores) else 0.0
        lc_candidate = None
        cur_base = (self.store.n_kfs // self.opts.srba_submap_size) * self.opts.srba_submap_size
        cur_base = min(cur_base, prev_kf)
        for s, i in zip(scores, ids):
            i = int(i)
            if i < 0 or i == prev_kf or s <= 0:
                continue
            if s > 0.8 * best and i not in similar and len(similar) < MAX_SIMILAR:
                similar.append(i)
            if (lc_candidate is None
                    and s > 0.05
                    # never re-propose a candidate from an area pair a
                    # previous validation rejected (perceptual aliasing)
                    and not self.rba.is_lc_blacklisted(self.rba._area_of(i),
                                                       self.rba._area_of(prev_kf))
                    and not self.rba.is_lc_blacklisted(self.rba._area_of(i), cur_base)
                    and self.rba.topo_distance(cur_base, i, self.opts.lc_distance + 1)
                    > self.opts.lc_distance):
                lc_candidate = i
                if i not in similar:
                    if len(similar) >= MAX_SIMILAR:
                        similar[-1] = i
                    else:
                        similar.append(i)
        return similar, lc_candidate

    def _propagate_ids(self, m_valid, status, oidx, similar, order, dists=None):
        """Feature-ID propagation (≙ .cpp:571-617): per stereo match, the
        first tracked hit across the ranked similar KFs reuses that KF's
        match ID (duplicate guard); everything else gets a fresh ID. With
        ``dists`` (debug mode: per-rank raw match distances), writes the
        ``da_dist_kf*`` file: the winning tracked match's distance per
        slot, 0.00 for new features (≙ reference .cpp:566-616)."""
        ids = np.full(self.capacity, -1, np.int64)
        used = np.zeros(0, np.int64)
        n_common = 0
        win_dist = np.zeros(self.capacity, np.float32)
        for rank in order:
            if rank >= len(similar):
                continue
            other_ids = self.store.match_ids[similar[int(rank)]]
            sel = np.nonzero((status[rank] == S_TRACKED) & m_valid & (ids < 0))[0]
            if not len(sel):
                continue
            cand = other_ids[oidx[rank, sel]]
            ok = (cand >= 0) & ~np.isin(cand, used)
            sel, cand = sel[ok], cand[ok]
            # duplicate guard within this rank: the lowest feature index
            # claims a repeated candidate id
            _uniq, first = np.unique(cand, return_index=True)
            sel, cand = sel[first], cand[first]
            ids[sel] = cand
            if dists is not None:
                win_dist[sel] = dists[int(rank), sel]
            used = np.concatenate([used, cand])
            n_common += len(sel)
        fresh = m_valid & (ids < 0)
        n_new = int(fresh.sum())
        ids[fresh] = np.arange(self.next_match_id, self.next_match_id + n_new)
        self.next_match_id += n_new
        if dists is not None:
            self.debug.dump_da_dist(self.store.n_kfs, win_dist[m_valid])
        return ids, n_new, n_common

    def _mint_fresh_ids(self, m_valid: np.ndarray) -> np.ndarray:
        ids = np.full(self.capacity, -1, np.int64)
        n = int(m_valid.sum())
        ids[m_valid] = np.arange(self.next_match_id, self.next_match_id + n)
        self.next_match_id += n
        return ids

    def _build_obs(self, frame, ids):
        """Observation arrays for SRBA (≙ .cpp:139-161 / 685-728) from a
        frame on the device (one copy)."""
        host = to_host([frame.m_valid, frame.xs_l, frame.ys_l, frame.xs_r,
                        frame.m_r_idx, frame.pts3d])
        return self._build_obs_host(*host, ids)

    def _build_obs_host(self, m_valid, xs_l, ys_l, xs_r, m_r, pts, ids):
        """(lm_ids, px, rel) observation arrays; the engine falls back to
        its default init where rel is non-finite and ignores rel for
        already-registered landmarks."""
        sel = np.nonzero(m_valid & (ids >= 0))[0]
        px = np.stack([xs_l[sel].astype(np.float64), ys_l[sel].astype(np.float64),
                       xs_r[m_r[sel]].astype(np.float64)], axis=-1)
        return (ids[sel], px, pts[sel].astype(np.float64))

    # -------------------------------------------------------------- epilogue
    def save_checkpoint(self, path: str):
        """The whole state as one resumable ``.npz`` (``utils/checkpoint.py``)."""
        from srba_slam_tpu_torch.utils.checkpoint import save_state

        save_state(self, path)

    def emergency_epilogue(self, exc: BaseException | None = None):
        """≙ the exception handler around define_new_keyframe (reference
        .cpp:792-839): on a mid-run failure persist everything recoverable
        (final_graph.dot, out_kf_poses.txt, time_new_kf.txt, profiler.csv
        and a full checkpoint, emergency_state.npz) to ``<out_dir>/crash/``.
        ``error.txt`` is written first, so that it survives a failure in
        here. Never raises; the original exception is the caller's."""
        out_dir = os.path.join(self.general.out_dir or "out", "crash")
        try:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "error.txt"), "w") as f:
                f.write(f"{type(exc).__name__ if exc else 'unknown'}: {exc}\n")
        except Exception:
            return
        try:
            # failed or in-flight solves are not committable, nor are
            # unresolved speculative checks
            self.rba._queued, self.rba._pending = [], []
            self._spec, self._check_plan, self._walk_log = [], [], []
            self.finalize(out_dir=out_dir)
        except Exception:
            # minimal fallback: raw graph + unoptimized trajectory
            try:
                self.final_poses = self.rba.kf_global[: self.store.n_kfs].copy()
                self.final_poses_cam = self.final_poses
                self.save_trajectory(os.path.join(out_dir, "out_kf_poses.txt"))
                self.save_kf_stats(os.path.join(out_dir, "time_new_kf.txt"))
                self.profiler.save_csv(os.path.join(out_dir, "profiler.csv"))
                self.rba.save_graph_as_dot(os.path.join(out_dir, "final_graph.dot"))
            except Exception:
                pass
        try:
            self.save_checkpoint(os.path.join(out_dir, "emergency_state.npz"))
        except Exception:
            pass

    def finalize(self, out_dir: str | None = None):
        """Final global pose-graph optimization + outputs (≙ the epilogue,
        reference .cpp:939-1096): out_kf_poses.txt, kf_frames.txt,
        time_new_kf.txt, profiler.csv, final_graph.dot, final_global_path.ply
        and map_viewer.html in ``out_dir``, and final_global_path.png under
        ``show3D``."""
        self._finish_batched()
        n = self.store.n_kfs
        self.rba.flush()
        if n >= 2 and self.rba.n_edges:
            eu, ev, rel = self.rba.get_global_graphslam_problem()
            e_pad = max(64, 1 << (len(eu) - 1).bit_length())
            n_pad = max(64, 1 << (n - 1).bit_length())
            eu_a = np.zeros(e_pad, np.int32); eu_a[: len(eu)] = eu
            ev_a = np.zeros(e_pad, np.int32); ev_a[: len(ev)] = ev
            rel_a = np.zeros((e_pad, 6), np.float32); rel_a[: len(eu)] = rel
            e_valid = np.zeros(e_pad, bool); e_valid[: len(eu)] = True
            poses0 = np.zeros((n_pad, 6), np.float32)
            poses0[:n] = self.rba.kf_global[:n]
            dev = self.device
            with self.profiler.section("global_posegraph"):
                # pinned uploads, and the gather tables from the host's
                # edges: the call reads nothing back before its result
                poses, _c0, _c1, _ = optimize_pose_graph(
                    *(cuda_graphs.upload(a, dev) for a in
                      (poses0, np.arange(n_pad) < n, eu_a, ev_a, rel_a, e_valid)),
                    max_iters=25, host_edges=(eu_a, ev_a, e_valid))
                final_cam = poses[:n].cpu().numpy().astype(np.float64)
        else:
            final_cam = self.rba.kf_global[:n].copy()
        # world-frame KF poses T_world = E ∘ T_cam ∘ E⁻¹
        self.final_poses_cam = final_cam
        E = np.broadcast_to(self.sensor_pose, final_cam.shape)
        Ei = np.broadcast_to(self.sensor_pose_inv, final_cam.shape)
        self.final_poses = (se3_np.compose_batch(se3_np.compose_batch(E, final_cam), Ei)
                            if n else final_cam)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self.save_trajectory(os.path.join(out_dir, "out_kf_poses.txt"))
            # kf-id -> frame-index sidecar for the ATE tool
            # (python -m srba_slam_tpu_torch.utils.evaluation)
            with open(os.path.join(out_dir, "kf_frames.txt"), "w") as f:
                for r in self.step_log:
                    if r.inserted_kf is not None:
                        f.write(f"{r.inserted_kf} {r.frame_idx}\n")
            self.save_kf_stats(os.path.join(out_dir, "time_new_kf.txt"))
            self.profiler.save_csv(os.path.join(out_dir, "profiler.csv"))
            self.rba.save_graph_as_dot(os.path.join(out_dir, "final_graph.dot"))
            # map + trajectory point cloud (≙ final_global_path.3DScene):
            # landmarks composed with the optimized base-KF poses, so that
            # map and trajectory share the post-epilogue frame; a landmark's
            # world position is (E ∘ T_cam_base) applied to its base-frame
            # point
            n_lms = self.rba.n_lms
            bases = self.rba.lm_base[:n_lms]
            in_range = bases < len(final_cam)
            world_cam = se3_np.compose_batch(E, final_cam) if n else final_cam
            lms = (np.asarray(se3_np.transform_points_by_pose(
                world_cam[bases[in_range]], self.rba.lm_pos[:n_lms][in_range]))
                if in_range.any() else None)
            export_scene_ply(os.path.join(out_dir, "final_global_path.ply"),
                             self.final_poses, lms)
            # interactive equivalent of the reference's live 3D window
            # (.cpp:1262-1338): one self-contained HTML file
            from srba_slam_tpu_torch.utils.html_viewer import write_map_viewer

            q_scores = self._last_query_scores()
            write_map_viewer(
                os.path.join(out_dir, "map_viewer.html"), self.final_poses,
                landmarks=lms, edges=self._typed_edges(), query_scores=q_scores,
                query_score_th=self.opts.query_score_th,
                kf_frames=self._kf_frame_indices(),
            )
            if self.general.show3D:
                # headless stand-in for the live 3D window (≙ show3D)
                from srba_slam_tpu_torch.utils.viz import render_map_png

                render_map_png(
                    os.path.join(out_dir, "final_global_path.png"),
                    self.final_poses, lms, query_scores=q_scores,
                    query_score_th=self.opts.query_score_th,
                )
        return self.final_poses

    def save_trajectory(self, path: str):
        """``kf x y z yaw pitch roll`` rows (≙ out_kf_poses.txt, reference
        .cpp:977-987)."""
        with open(path, "w") as f:
            for i in range(self.store.n_kfs):
                R, t = se3_np.exp(self.final_poses[i])
                ypr = _ypr_from_rotmat(R)
                f.write(f"{i} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                        f"{ypr[0]:.6f} {ypr[1]:.6f} {ypr[2]:.6f}\n")

    def save_kf_stats(self, path: str):
        """≙ time_new_kf.txt (reference .cpp:940-943)."""
        with open(path, "w") as f:
            for s in self.kf_stats:
                f.write(f"{s.time_ms:.3f} {s.number_kfs} {s.number_feats_new} "
                        f"{s.number_feats_common}\n")


def bench_estimator(device="cuda", solve_sync: bool = False) -> SRBAStereoSLAMEstimator:
    """The estimator of the bench workload (``utils/bench_workload.py``),
    initialized on ``device``; ``solve_sync`` for the strict schedule (the
    fingerprint's)."""
    from srba_slam_tpu_torch.utils import bench_workload as bw
    from srba_slam_tpu_torch.utils.camera import StereoCamera

    cam = StereoCamera.kitti()
    est = SRBAStereoSLAMEstimator(
        GeneralOptions(), SRBAStereoSLAMOptions(camera=cam, **bw.OPTIONS),
        VOOptions(**bw.VO_OPTIONS), capacity=bw.CAPACITY, max_kfs=bw.MAX_KFS,
        device=device)
    est.initialize()
    est.solve_sync = solve_sync
    return est
