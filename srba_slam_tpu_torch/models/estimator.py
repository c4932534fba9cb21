"""The SLAM estimator's per-frame pipeline (≙ CSRBAStereoSLAMEstimator).

Counterpart of ``srba_slam_tpu/models/estimator.py``'s ``step()`` path
(reference src/CSRBAStereoSLAMEstimator.{h,cpp}): VO with the adaptive
detector-threshold retry → keyframe-check triggers → BoW query →
similar-KF selection → DA cascade → loop-closure confirmation (and the
odometry-seeded recovery of a rejected one) → feature-ID propagation →
SRBA insertion and window solve → pose bookkeeping; at the end the global
pose graph and the output files.

The parity reference is JAX's ``step()`` with ``solve_sync = True``: every
window solve lands right after its insertion. This is the single copy of
the per-frame host walk (``_walk_frame``: its head, pose accumulators and
triggers; the check; its tail, the keyframe decision; the ID chain is the
VO engine's ``commit_frame``). A keyframe check runs the BoW query and the
DA cascade, its five candidates as one batch, on the estimator's device and
copies their outputs to the host once; the fleet runs the heads of its
sequences, one batched check for those that check, then their tails. The
options around the loop run as in the JAX package: the rectification maps
of an unrectified rig, the ``general.debug`` file family, the ``show3D``
snapshots behind the live viewer, and the resumable checkpoint
(``utils/checkpoint.py``).

The batched loop (``perform_stereo_slam_batched``, the CLI's ``--batch N``)
runs the VO of B frames as one ``vo_scan`` and walks the B frames through
the same ``_walk_frame`` in ``step()``'s order, with the JAX package's
adaptive-threshold protocol at batch granularity. It is synchronous: the
JAX package's tunnel scheduling (speculative deferred checks, miss replay,
the frame uploader, bulk pulls, queued solves) is not ported, since a
keyframe inserted inside a batch changes no VO output.
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
    S_TRACKED, query_and_associate, recheck_candidate,
)
from srba_slam_tpu_torch.models.keyframe import KeyframeStore
from srba_slam_tpu_torch.models.srba import SRBAEngine, SRBAParams
from srba_slam_tpu_torch.models.vo import StereoVOEngine, to_host, vo_scan
from srba_slam_tpu_torch.ops import prng
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
        # the engine queues each window; step() lands it right after the
        # insertion (the JAX package's solve_sync scheduling)
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
        (one K1 and one K2 launch for their 2B images) and the frames
        walked through ``step()``'s host walk in order. The first frame (and
        the first after a resume, whose checkpoint holds no frame features)
        goes through ``step()``. Stops where ``perform_stereo_slam`` stops,
        at the frame: frames of the batch left unwalked are kept for the
        next call."""
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
        while True:
            chunk = list(itertools.islice(it, batch))
            if not chunk:
                break
            walked = self.step_batch(np.stack([f[0] for f in chunk]),
                                     np.stack([f[1] for f in chunk]))
            if walked < len(chunk) or self._stop_reached():
                self._stashed_frames = chunk[walked:]
                break
        return self.step_log

    def step_batch(self, lefts, rights) -> int:
        """Process the B frames ``lefts``/``rights`` [B, H, W] with one
        ``vo_scan`` (and one more for each adaptive retry's tail), each frame
        walked to its keyframe decision before this returns. Returns the
        number of frames walked: B, or fewer where a stop condition fired."""
        dev = self.device
        return self._process_scan(torch.as_tensor(lefts, device=dev),
                                  torch.as_tensor(rights, device=dev))

    def _process_scan(self, lefts: torch.Tensor, rights: torch.Tensor) -> int:
        """One scan and its walk, with the adaptive-threshold protocol at
        batch granularity (≙ JAX ``_process_scan``, reference .cpp:271-315):
        if a frame's stereo matches fall under ``adaptive_th_min_matches``
        while a threshold can still move, the frames before it are walked,
        ``retry_step()`` moves a threshold, and the tail from that frame on
        is scanned again, chained from the last walked frame (retries nest).
        Otherwise the thresholds drift once, from the batch's fewest
        matches. Returns the number of frames walked."""
        eng = self.vo
        fast_th, orb_th = eng.thresholds()
        _last, _inc, outs = vo_scan(
            lefts, rights, eng._prev,
            torch.as_tensor(eng._last_pose_inc, dtype=torch.float32, device=self.device),
            self.cam, fast_th, orb_th, **eng.frontend_options(), **eng.solve_options())
        curs = outs[0]
        scan = to_host([outs[1], outs[2], curs.m_valid, outs[3], outs[4], outs[6]])
        b = lefts.shape[0]
        nm = scan[2].sum(axis=1)
        th = self.opts.adaptive_th_min_matches
        # the protocol runs only under orb_adaptive_fast_th (≙ .cpp:271)
        adaptive = self.opts.orb_adaptive_fast_th
        retry_j = None
        if adaptive and (not eng.is_fast_th_min() or not eng.is_orb_th_max()):
            below = np.nonzero(nm < th)[0]
            if len(below):
                retry_j = int(below[0])
        if retry_j is not None:
            walked = self._walk_scan(curs, scan, retry_j)
            if walked < retry_j:
                return walked
            eng.retry_step()    # moves: gated above on a movable threshold
            return retry_j + self._process_scan(lefts[retry_j:], rights[retry_j:])
        if adaptive:
            eng.drift_thresholds(int(nm.min()) if b else self.capacity, th)
        return self._walk_scan(curs, scan, b)

    def _walk_scan(self, curs, scan, upto: int) -> int:
        """Walk frames [0, upto) of a scan in order: each through the VO
        engine's ``commit_frame`` (IDs) and ``_walk_frame`` (pose, triggers,
        check), as ``step()`` walks a frame. Returns the frames walked: fewer
        than ``upto`` where a stop condition fired."""
        track_idx, track_valid, m_valid, poses, pose_valid, mean_res = scan
        for j in range(upto):
            self.frame_idx += 1
            res = StepResult(self.frame_idx)
            self.step_log.append(res)
            cur = type(curs)(*(a[j] for a in curs))
            # (the scan's outputs, as the JAX package's, hold no GN iteration count)
            vo = self.vo.commit_frame(cur, track_idx[j], track_valid[j], m_valid[j],
                                      poses[j].copy(), bool(pose_valid[j]),
                                      float(mean_res[j]), 0)
            # a frame under 8 stereo matches is hopeless (≙ _vo_with_adaptive_retry)
            self._walk_frame(res, None if vo.num_stereo_matches < 8 else vo)
            if self._stop_reached():
                return j + 1
        return upto

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

        force_new_kf, check = self._kf_triggers(vo.tracked_from_last_kf)
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

    def _kf_triggers(self, tracked_from_last_kf: int) -> tuple[bool, bool]:
        """KF-check triggers (≙ reference .cpp:366-394): hard force limit at
        2x the configured translation/rotation, tracking-count trigger, and
        the dynamic since-last-check distance trigger. Returns
        (force_new_kf, check)."""
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
        return force_new_kf, check

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
        sub = self._da_seed
        self._da_seed += 1
        return sub

    def check_outputs(self, top_s, top_i, da, frame) -> list:
        """A check's outputs as ``_kf_check_host`` takes them: the tensors
        (with ``general.debug``, the cascade's intermediates for the dumps
        too), each leading with a sequence dimension when the check ran
        batched over sequences."""
        return ([top_s, top_i, da.status, da.other_idx, da.tracked_count, frame.m_valid,
                 frame.xs_l, frame.ys_l, frame.xs_r, frame.m_r_idx, frame.pts3d]
                + ([da.raw_oidx, da.distance, da.residuals] if self.debug.enabled else []))

    def _kf_check(self, frame) -> list:
        """BoW query and DA cascade of ``frame`` on the device, outputs
        copied to the host in one copy (the decision is
        :meth:`_kf_check_host`)."""
        key = prng.PRNGKey(self.next_check_key(), device=self.device)
        with self.profiler.section("queryDB"):
            top_s, top_i, _cand, da = query_and_associate(
                frame, self.store.arrays, self.bow._db, self.bow._leaf_bits,
                self.bow._weights, self.store.n_kfs, self.cam, key, **self.check_options())
        with self.profiler.section("performDA"):
            pulled = to_host(self.check_outputs(top_s, top_i, da, frame))
            self._reanchor_if_dirty()
        return pulled

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
        """The insertion decision from the check's host outputs: similar-KF
        selection + LC confirmation (≙ .cpp:483-545). Mutates only logs;
        threshold changes are returned for the caller to apply."""
        (scores, ids, da_status_all, da_oidx_all, tracked_all, f_m_valid,
         f_xs_l, f_ys_l, f_xs_r, f_m_r, f_pts) = pulled[:11]
        extras = (dict(zip(("raw_oidx", "distance", "residuals"), pulled[11:]))
                  if len(pulled) > 11 else None)
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

    def _kf_apply(self, d: dict, frame, res: StepResult, initial_rel: np.ndarray):
        """INSERT NEW KF (≙ .cpp:563-924) from a positive decision.
        ``initial_rel`` is the pose increment since the previous keyframe
        (for ``use_initial_pose``). Returns the keyframe's match IDs."""
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
                # land the insertion's window solves now (strict scheduling)
                self.rba.flush()
            except Exception as exc:
                # ≙ the reference's exception epilogue around
                # define_new_keyframe (.cpp:792-839)
                self.emergency_epilogue(exc)
                raise
        kf_id = info.kf_id
        new_global = self.rba.kf_global[kf_id].copy()
        self.store.append(frame, ids, new_global)
        self.bow.insert(frame.desc_l, frame.m_valid)
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
        self.store._write_row(frame, kf_id)  # the new KF's row is not in the store yet
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
        the invariant current_pose = last_kf_global ∘ incr_from_last_kf."""
        if not self._pose_dirty:
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
            self.rba._queued = []  # failed solves are not committable
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
                poses, _c0, _c1, _ = optimize_pose_graph(
                    *(torch.as_tensor(a, device=dev) for a in
                      (poses0, np.arange(n_pad) < n, eu_a, ev_a, rel_a, e_valid)),
                    max_iters=25)
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


def bench_estimator(device="cuda") -> SRBAStereoSLAMEstimator:
    """The estimator of the bench workload (``utils/bench_workload.py``),
    initialized on ``device``."""
    from srba_slam_tpu_torch.utils import bench_workload as bw
    from srba_slam_tpu_torch.utils.camera import StereoCamera

    cam = StereoCamera.kitti()
    est = SRBAStereoSLAMEstimator(
        GeneralOptions(), SRBAStereoSLAMOptions(camera=cam, **bw.OPTIONS),
        VOOptions(**bw.VO_OPTIONS), capacity=bw.CAPACITY, max_kfs=bw.MAX_KFS,
        device=device)
    est.initialize()
    return est
