"""Whether the timed path's answers are right, against the plain reference
(``reference/``): the frontend and pose of frames, the place-recognition
query of keyframe checks, and window solves.

While the window runs, :class:`Recorder` keeps, for a share of the work
drawn from the seed, what the program produced on the timed path and what
it started from:

* frames: a batched scan's features and poses (``_dispatch_scan``), or a
  per-frame pass's (``process_stereo_pair``), with the FAST and ORB
  thresholds of the pass and the pose the solve started at. Only frames
  whose previous frame went through the same pass's thresholds are kept
  (a scan's frames after its first; every frame of per-frame stepping);
* keyframe checks: as each check is launched (``_kf_check``, synchronous;
  ``_dispatch_planned_checks``, a batch's deferred checks), the
  descriptors the program wrote into each database row it runs against
  (the rows before its row; every write of a row is followed:
  ``BoWDatabase.write_row`` and the deferred slots' own writes), its
  frame's descriptors, and its packed answer, whose four best scores and
  keyframe ids are read after the window;
* window solves: at each group of window solves (``SRBAEngine._solve_group``),
  one window's packed inputs, the solve options and the program's result
  row for it; and every window whose queued entry carries loop-closure
  checks (``entry["lc_checks"]``: the window of an insertion that created
  a loop-closure edge), up to ``MAX_CASES["windows"]``, kept apart, with
  no draw;
* the map's edges, where the log is a circuit with its ground truth: at
  the end of each session (the window's last included), a copy of every
  edge still standing, of every kind, and the session's step log, which
  gives each keyframe its frame (sessions replay the log from frame 0).

Once the window has closed, :func:`compare` works each drawn case out again:

* a frame: the reference frontend of the frame and of the frame before it
  from the benchmark's own copy of the frames, at those thresholds; then
  tracking and the two-stage robust pose solve from the same starting pose
  (the program's last increment: the one point where the frame's solve
  follows the program's state);
* a check: the BoW vector of the checked frame's descriptors and of
  each keyframe row from the descriptors written into it (the map is the
  program's state; the descriptors are judged with the frames), and the
  query's ranking, on the benchmark's own vocabulary;
* a window: the reference LM over the same window (its keyframes,
  landmarks and observations are the program's map, as the reference
  system's window is its map), in float64. The draw takes the windows with
  loop-closure checks first;
* an edge: its relative pose against the ground-truth relative pose of
  its two frames' left cameras.

Compared, each with its limit from the configuration (``limits``):

* ``keypoints_differ``: the share of the frames' left and right keypoints
  whose validity or position differs, or (left) whose stereo match differs;
* ``descriptor_bits_differ``: the share of descriptor bits that differ
  among keypoints valid at the same position on both sides;
* ``pose_gap_m_p90``, ``pose_gap_rad_p90``: the 90th percentile over the
  frames (nearest rank: the second widest of 16) of the distance between
  the program's and the reference's translation, and of the angle between
  their rotations (a frame that one side solves and the other does not
  counts as infinite). One frame in some hundreds, whose stage-1 residuals
  straddle the inlier threshold, may keep another inlier set on one side;
  a fault on two frames of 16 fails;
* ``bow_score_gap``: over the checks and the four ranks, the larger of the
  program's score against the reference's score of the id the program
  ranked there, and that score against the reference's own score at that
  rank (a wrong id, or a wrong score);
* ``window_pose_gap_m``, ``window_pose_gap_rad``: over the windows and
  their free keyframes, the distance between the program's and the
  reference's optimized poses;
* ``edge_gap_m_max``, ``edge_gap_rad_max``, ``loop_edges`` (a circuit's
  log only): over every edge standing at a session's end, the largest
  distance between its translation and the ground truth's, and the largest
  angle between its rotation and the ground truth's; and the loop edges (of
  any kind, whose two frames lie more than ``LOOP_PATH_M`` of driven path
  apart) standing at the end of a session that walked the whole log, the
  fewest over such sessions (the last session's where none did). They are
  held to ``limits["edge_gap_m"]``, ``["edge_gap_rad"]`` and
  ``["loop_edges_min"]`` only where the configuration names those.

The control (``control_dtype``) puts the reference computed in a lower
type in the program's place (the map's edges stay the program's).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from slam_bench import stats
from slam_bench.reference import bow as ref_bow, frontend, vo as ref_vo, window as ref_window

NUMBERS = ("keypoints_differ", "descriptor_bits_differ", "pose_gap_m_p90", "pose_gap_rad_p90",
           "bow_score_gap", "window_cost_excess")
# the least number of cases of each kind a run compares, and the most
MIN_CASES = dict(frames=8, checks=2, windows=2)
MAX_CASES = dict(frames=16, checks=4, windows=4)
# the share of frames, checks and window groups kept while the window runs
SHARE = 0.05
# the most sampled checks kept while the window runs (each holds a copy of
# the keyframe rows it saw)
CHECK_KEEP = 12
N_QUERY = 4
# an edge whose two frames lie farther apart than this along the driven path
# closes a loop: a window's own edges span a few submaps (tens of metres)
LOOP_PATH_M = 100.0


class Recorder:
    """Wraps the program's entries while installed and keeps the drawn
    cases (references to the program's own outputs, or host copies)."""

    def __init__(self, seed: int, share: float = SHARE, keep_db: bool = False,
                 keep_checks: int = CHECK_KEEP, poses: np.ndarray | None = None):
        self.rng = np.random.default_rng([seed, 7])
        self.share = share
        self.session = 0
        self.frame = -1           # per-frame stepping: the frame being stepped
        self.scans: list = []
        self.frames: dict = {}     # (session, frame) -> per-frame record
        self.thresholds: dict = {}  # (session, frame) -> (fast, orb) of its last pass
        self.checks: list = []
        self.n_checks = 0
        self.keep_db = keep_db  # calibration: keep the database rows a check saw too
        self.keep_checks = keep_checks
        self.windows: list = []
        self.lc_windows: list = []   # windows with loop-closure checks, kept with no draw
        self.n_lc_windows = 0
        self._lc_ints: set = set()   # the packed ints of the queued windows with them
        # the log's ground-truth poses [N, 6], where it is a circuit; then
        # each session's standing edges, as copied when it ended
        self.poses = poses
        self.graphs: list = []
        self._undo = []

    def install(self):
        from srba_slam_tpu_torch.models import bow, estimator, srba, vo

        rec = self
        orig_dispatch = estimator.SRBAStereoSLAMEstimator._dispatch_scan
        orig_pass = vo.StereoVOEngine.process_stereo_pair
        orig_group = srba.SRBAEngine._solve_group
        orig_queued = srba.SRBAEngine._dispatch_queued
        orig_check = estimator.SRBAStereoSLAMEstimator._kf_check
        orig_planned = estimator.SRBAStereoSLAMEstimator._dispatch_planned_checks
        orig_row = bow.BoWDatabase.write_row
        written: dict = {}   # (session, row) -> the descriptors the database's row holds

        def row_write(db, desc, valid, row):
            written[(rec.session, int(row))] = (desc.clone(), valid.clone())
            return orig_row(db, desc, valid, row)

        def keep(est, n, feats, j, blob):
            """A sampled check into the reservoir: the rows it saw copied
            (on the device, in stream order: the state it ran on), its frame
            and its answer."""
            if not rec.rng.random() < rec.share:
                return
            rec.n_checks += 1
            slot = (len(rec.checks) if len(rec.checks) < rec.keep_checks else
                    int(rec.rng.integers(rec.n_checks)))
            if slot >= rec.keep_checks:
                return
            a = est.store.arrays
            c = dict(session=rec.session, n=n, blob=blob, k=est.capacity,
                     q_desc=feats.desc_l[j].clone(), q_valid=feats.m_valid[j].clone(),
                     rows=[written.get((rec.session, i)) for i in range(n)],
                     desc=a.desc_l[:n].clone(), valid=a.m_valid[:n].clone())
            if rec.keep_db:
                c["db"] = est.bow._db[:n].clone()
            if slot < len(rec.checks):
                rec.checks[slot] = c
            else:
                rec.checks.append(c)

        def check(est, frame):
            # a synchronous check against the keyframes stored when it runs
            n = est.store.n_kfs
            pulled = orig_check(est, frame)
            if n >= 1:
                keep(est, n, type(frame)(*(x[None] for x in frame)), 0, pulled[0])
            return pulled

        def planned(est):
            # the deferred checks of a batch: a slot sees the rows before its
            # speculative row, which the slots after it do not write
            plan = list(est._check_plan)
            for p in plan:
                # each slot writes its frame into the database at its row
                j = int(p["j"])
                written[(rec.session, int(p["row"]))] = (p["feats"].desc_l[j].clone(),
                                                         p["feats"].m_valid[j].clone())
            out = orig_planned(est)
            for p in plan:
                if p["row"] >= 1 and p["spec"]["handles"] is not None:
                    keep(est, int(p["row"]), p["feats"], int(p["j"]), p["spec"]["handles"][0])
            return out

        def dispatch(est, item, chain=None):
            fast, orb = est.vo.thresholds()
            init0 = chain["last_inc"] if chain else np.asarray(est.vo._last_pose_inc, np.float32)
            disp = orig_dispatch(est, item, chain)
            for j in range(disp["b"]):
                rec.thresholds[(rec.session, disp["f0"] + j)] = (fast, orb)
            picked = [j for j in range(1, disp["b"]) if rec.rng.random() < rec.share]
            if picked:
                rec.scans.append(dict(session=rec.session, f0=disp["f0"], picked=picked,
                                      fast=fast, orb=orb, outs=disp["outs"], init0=init0))
            return disp

        def one_pass(eng, left, right):
            fast, orb = eng.thresholds()
            init = np.array(eng.initial_increment(), np.float32)
            had_prev = eng._prev is not None
            out = orig_pass(eng, left, right)
            key = (rec.session, rec.frame)
            rec.thresholds[key] = (fast, orb)
            if had_prev and rec.frame >= 1:
                if key not in rec.frames and rec.rng.random() >= rec.share:
                    rec.frames[key] = None
                if rec.frames.get(key, 0) is not None:
                    rec.frames[key] = dict(session=rec.session, f=rec.frame, fast=fast, orb=orb,
                                           feats=eng._prev, pose=np.array(out.pose_increment),
                                           valid=bool(out.valid), init=init)
            return out

        def queued(eng):
            rec._lc_ints = {id(q["ints"]) for q in eng._queued if q["entry"].get("lc_checks")}
            return orig_queued(eng)

        def group(eng, windows, key, capture_only=False):
            out = orig_group(eng, windows, key, capture_only)
            if capture_only:
                return out
            for j, w in enumerate(windows):
                if id(w[0]) not in rec._lc_ints:
                    continue
                rec.n_lc_windows += 1
                if len(rec.lc_windows) < MAX_CASES["windows"]:
                    rec.lc_windows.append(dict(ints=w[0], floats=w[1], key=key,
                                               kw=eng._solve_kw(), row=out[j]))
            if rec.rng.random() < rec.share * 2:
                j = int(rec.rng.integers(len(windows)))
                rec.windows.append(dict(ints=windows[j][0], floats=windows[j][1], key=key,
                                        kw=eng._solve_kw(), row=out[j]))
            return out

        estimator.SRBAStereoSLAMEstimator._dispatch_scan = dispatch
        vo.StereoVOEngine.process_stereo_pair = one_pass
        estimator.SRBAStereoSLAMEstimator._kf_check = check
        estimator.SRBAStereoSLAMEstimator._dispatch_planned_checks = planned
        srba.SRBAEngine._solve_group = group
        srba.SRBAEngine._dispatch_queued = queued
        bow.BoWDatabase.write_row = row_write
        self._undo = [(estimator.SRBAStereoSLAMEstimator, "_dispatch_scan", orig_dispatch),
                      (vo.StereoVOEngine, "process_stereo_pair", orig_pass),
                      (estimator.SRBAStereoSLAMEstimator, "_kf_check", orig_check),
                      (estimator.SRBAStereoSLAMEstimator, "_dispatch_planned_checks",
                       orig_planned),
                      (srba.SRBAEngine, "_solve_group", orig_group),
                      (srba.SRBAEngine, "_dispatch_queued", orig_queued),
                      (bow.BoWDatabase, "write_row", orig_row)]

    def session_end(self, est, full: bool):
        """Copy a session's standing edges, of every kind, and keep its step
        log (``full``: the session walked the whole log); nothing without
        the ground truth. The frames are looked up after the window."""
        if self.poses is None:
            return
        rba = est.rba
        ok = rba.edge_valid
        self.graphs.append(dict(session=self.session, full=full, log=est.step_log,
                                u=rba.edge_u[ok].copy(), v=rba.edge_v[ok].copy(),
                                kind=rba._edge_kind[:rba.n_edges][ok].copy(),
                                pose=rba.edge_pose[ok].copy()))

    def uninstall(self):
        for owner, name, fn in self._undo:
            setattr(owner, name, fn)
        self._undo = []

    def cases(self, rng, n: int | None = None) -> dict:
        """Up to ``n`` (else ``MAX_CASES``) cases of each kind drawn by ``rng``:
        ``frames`` (frame, thresholds of it and of its previous frame, the
        program's features as numpy, its pose [6], whether valid, the
        starting pose [6]), ``checks`` (frame, thresholds, stored keyframes'
        descriptors, the program's scores and ids) and ``windows`` (packed
        inputs, bucket, options, the program's result row as numpy; those
        with loop-closure checks first, and ``lc_windows_met``, how many
        the window met); with the ground truth, ``edges`` (each session's
        standing edges: session, whether it walked the whole log, kind,
        keyframes, their frames, pose) and the ``poses``."""
        frames = []
        for s in self.scans:
            outs = s["outs"]
            feats, poses, valid = outs[0], outs[3].cpu().numpy(), outs[4].cpu().numpy()
            start = np.asarray(s["init0"].cpu().numpy() if isinstance(s["init0"], torch.Tensor)
                               else s["init0"], np.float32)
            inits = []
            for j in range(poses.shape[0]):
                inits.append(start.copy())
                if valid[j]:
                    start = poses[j]
            for j in s["picked"]:
                frames.append(dict(f=s["f0"] + j, th=(s["fast"], s["orb"]),
                                   th_prev=(s["fast"], s["orb"]),
                                   feats={k: getattr(feats, k)[j].cpu().numpy() for k in feats._fields},
                                   pose=poses[j].astype(np.float64), valid=bool(valid[j]),
                                   init=inits[j]))
        for (session, f), r in self.frames.items():
            prev = self.thresholds.get((session, f - 1))
            if r is None or prev is None:
                continue
            frames.append(dict(f=f, th=(r["fast"], r["orb"]), th_prev=prev,
                               feats={k: getattr(r["feats"], k).cpu().numpy()
                                      for k in r["feats"]._fields},
                               pose=r["pose"].astype(np.float64), valid=r["valid"], init=r["init"]))
        checks = [dict(c, **answer(c["blob"], c["k"])) for c in self.checks]
        windows = [dict(w, row=w["row"].cpu().numpy()) for w in self.windows]
        lc_windows = [dict(w, row=w["row"].cpu().numpy(), lc=True) for w in self.lc_windows]

        def draw(xs, kind):
            k = MAX_CASES[kind] if n is None else n
            if len(xs) > k:
                xs = [xs[i] for i in sorted(rng.choice(len(xs), k, replace=False))]
            return xs

        out = dict(frames=draw(frames, "frames"), checks=draw(checks, "checks"))
        # the windows with loop-closure checks first, then the drawn ones
        drawn = [w for w in draw(windows, "windows")
                 if not any(w["ints"] is x["ints"] for x in lc_windows)]
        out.update(windows=(lc_windows + drawn)[:MAX_CASES["windows"] if n is None else n],
                   lc_windows_met=self.n_lc_windows)
        if self.poses is not None:
            edges = []
            for g in self.graphs:
                frame_of = {r.inserted_kf: r.frame_idx for r in g["log"]
                            if r.inserted_kf is not None}
                edges += [dict(session=g["session"], full=g["full"], kind=int(k), kf_u=int(u),
                               kf_v=int(v), u=frame_of[int(u)], v=frame_of[int(v)], pose=pose)
                          for u, v, k, pose in zip(g["u"], g["v"], g["kind"], g["pose"])]
            out.update(edges=edges, poses=self.poses)
        return out


def answer(blob, k: int, similar: int = 5) -> dict:
    """The query's answer in a check's packed output (an int32 row on the
    device or the host): its ``N_QUERY`` keyframe ids first, then the
    cascade's statuses and matched indices [similar, k] and counts
    [similar], the frame's five stereo columns [k], and the scores bitcast
    from float32."""
    b = np.ascontiguousarray(blob.cpu().numpy() if isinstance(blob, torch.Tensor)
                             else np.asarray(blob)).view(np.int32)
    at = N_QUERY + 2 * similar * k + similar + 5 * k
    return dict(ids=b[:N_QUERY].astype(np.int64),
                scores=b[at:at + N_QUERY].view(np.float32).astype(np.float64))


def rotvec_to_R(w) -> np.ndarray:
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    W = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if th < 1e-12:
        return np.eye(3) + W
    return np.eye(3) + np.sin(th) / th * W + (1 - np.cos(th)) / th**2 * (W @ W)


def _angle(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """The angle of Ra^T Rb, from its skew and symmetric parts (exact for
    small angles, where an arccos of the trace is not)."""
    D = Ra.T @ Rb
    v = np.array([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]])
    return float(np.arctan2(np.linalg.norm(v) / 2.0, (np.trace(D) - 1.0) / 2.0))


def _popcount(x: np.ndarray) -> int:
    return int(np.unpackbits(np.ascontiguousarray(x).view(np.uint8)).sum())


class Setup:
    """What the reference needs of a configuration: the camera, the maps of
    a raw rig, the capacity, the VO options, the vocabulary."""

    def __init__(self, config: dict, device, vocabulary: dict | None = None):
        self.cam = config["camera"]
        self.k = config["capacity"]
        self.device = device
        self.maps = None
        if not config["vo_options"].get("rectified_images", True):
            c = self.cam
            self.maps = (
                frontend.build_maps(c["width"], c["height"], c["fx_l"], c["fy_l"], c["cx_l"],
                                    c["cy_l"], config["dist_l"], device),
                frontend.build_maps(c["width"], c["height"], c["fx_r"], c["fy_r"], c["cx_r"],
                                    c["cy_r"], config["dist_r"], device))
        vo = config["vo_options"]
        self.solve = dict(kernel_param=vo.get("kernel_param", 3.0),
                          residual_threshold=vo.get("residual_threshold", 15.0),
                          min_mod=vo.get("min_mod_out_vector", 1e-3),
                          max_iters_initial=vo.get("initial_max_iters", 30),
                          max_iters=vo.get("max_iters", 30),
                          min_inliers=vo.get("bad_tracking_th", 5),
                          max_incr_cost=vo.get("max_incr_cost", 3))
        self.voc = None
        if vocabulary is not None:
            self.voc = (torch.as_tensor(np.asarray(vocabulary["leaf_bits"])).to(device),
                        torch.as_tensor(np.asarray(vocabulary["weights"])).to(device))

    def features(self, lefts, rights, f: int, th, dtype):
        left = torch.as_tensor(np.asarray(lefts[f])).to(self.device)
        right = torch.as_tensor(np.asarray(rights[f])).to(self.device)
        return frontend.frontend(left, right, self.cam, th[0], th[1], self.k, maps=self.maps,
                                 dtype=dtype)

    def pose(self, cur, prev, init, orb, dtype):
        R0 = ref_vo.so3_exp(torch.as_tensor(init[:3], dtype=torch.float64)).to(self.device)
        t0 = torch.as_tensor(init[3:], dtype=torch.float64, device=self.device)
        R, t, ok = ref_vo.solve(cur, prev, self.cam, R0, t0, orb, dtype=dtype, **self.solve)
        return R.cpu().numpy(), t.cpu().numpy(), ok


def _as_numpy(f: frontend.Features) -> dict:
    return {k: (lambda x: (x.float() if x.is_floating_point() else x).cpu().numpy())(getattr(f, k))
            for k in f._fields}


def _frames(cases, setup: Setup, lefts, rights, control_dtype, out: dict):
    kp_bad = kp_all = bit_bad = bit_all = 0
    gaps_m, gaps_rad, off = [], [], []
    for c in cases:
        f = c["f"]
        ref_prev = setup.features(lefts, rights, f - 1, c["th_prev"], torch.float32)
        ref_cur = setup.features(lefts, rights, f, c["th"], torch.float32)
        R_ref, t_ref, ok_ref = setup.pose(ref_cur, ref_prev, c["init"], c["th"][1], torch.float32)
        if control_dtype is None:
            got, R, t, ok = c["feats"], rotvec_to_R(c["pose"][:3]), c["pose"][3:], c["valid"]
        else:
            cp = setup.features(lefts, rights, f - 1, c["th_prev"], control_dtype)
            cc = setup.features(lefts, rights, f, c["th"], control_dtype)
            R, t, ok = setup.pose(cc, cp, c["init"], c["th"][1], control_dtype)
            got = _as_numpy(cc)
        ref = _as_numpy(ref_cur)
        for side in ("l", "r"):
            v_g, v_r = got[f"valid_{side}"], ref[f"valid_{side}"]
            same = (v_g == v_r) & ((got[f"ys_{side}"] == ref[f"ys_{side}"])
                                   & (got[f"xs_{side}"] == ref[f"xs_{side}"]) | ~v_r)
            if side == "l":
                same &= got["m_valid"] == ref["m_valid"]
                same &= (got["m_r_idx"] == ref["m_r_idx"]) | ~ref["m_valid"]
            kp_bad += int((~same & (v_g | v_r)).sum())
            kp_all += int((v_g | v_r).sum())
            both = same & v_g & v_r
            bit_bad += _popcount(np.bitwise_xor(got[f"desc_{side}"][both], ref[f"desc_{side}"][both]))
            bit_all += int(both.sum()) * 256
        if ok != ok_ref:
            gm = gr = math.inf
        elif ok:
            gm = float(np.linalg.norm(np.asarray(t, np.float64) - t_ref))
            gr = _angle(np.asarray(R, np.float64), R_ref)
        else:
            continue
        gaps_m.append(gm)
        gaps_rad.append(gr)
        off.append(dict(f=f, th=c["th"], th_prev=c["th_prev"], init=np.asarray(c["init"]).tolist(),
                        gap_m=gm, gap_rad=gr, ok=bool(ok), ok_ref=bool(ok_ref),
                        t=np.asarray(t, np.float64).tolist(), t_ref=np.asarray(t_ref).tolist()))
    out.update(keypoints_differ=kp_bad / max(kp_all, 1),
               descriptor_bits_differ=bit_bad / max(bit_all, 1),
               pose_gap_m_p90=stats.percentile(gaps_m, 0.9) if gaps_m else math.inf,
               pose_gap_rad_p90=stats.percentile(gaps_rad, 0.9) if gaps_rad else math.inf,
               pose_widest_gap_m=max(gaps_m, default=math.inf),
               pose_widest_gap_rad=max(gaps_rad, default=math.inf),
               frames=len(cases))
    # the inputs of the frame with the widest gap, to replay it
    out["widest_frame"] = max(off, key=lambda d: (d["gap_m"], d["gap_rad"]), default=None)


def _checks(cases, setup: Setup, lefts, rights, control_dtype, out: dict):
    leaf_bits, weights = setup.voc
    gap = 0.0
    cache: dict = {}

    def vecs(c, cur, dt):
        key = (id(c["desc"]), dt)
        if key not in cache:
            # each stored keyframe's vector from the descriptors the program
            # wrote into the database at its row (the store's, where none)
            rows = c.get("rows") or [None] * c["n"]
            desc = torch.stack([r[0] if r is not None else c["desc"][i] for i, r in enumerate(rows)])
            valid = torch.stack([r[1] if r is not None else c["valid"][i]
                                 for i, r in enumerate(rows)])
            cache[key] = ref_bow.vectors(desc.to(setup.device), valid.to(setup.device),
                                         leaf_bits, weights, dt)
        q = ref_bow.vectors(cur[0][None], cur[1][None], leaf_bits, weights, dt)[0]
        return ref_bow.scores(q, cache[key]).double().cpu()

    for c in cases:
        cur = (c["q_desc"].to(setup.device), c["q_valid"].to(setup.device))
        s_ref = vecs(c, cur, torch.float64)
        best, _ids = ref_bow.rank(s_ref, N_QUERY)
        if control_dtype is None:
            ids, s_got = c["ids"], c["scores"]
        else:
            # the lower type's own ranking and scores
            s_got, ids = ref_bow.rank(vecs(c, cur, control_dtype), N_QUERY)
        worst = 0.0
        for r in range(min(len(ids), len(best))):
            i = int(ids[r])
            at = float(s_ref[i]) if 0 <= i < s_ref.shape[0] else math.inf
            worst = max(worst, abs(float(s_got[r]) - at), abs(at - float(best[r])))
        if worst >= gap:
            diag = {}
            if "db" in c and control_dtype is None:
                # which side differs: the program's rows against the
                # reference's vectors of the stored descriptors
                mine = cache[(id(c["desc"]), torch.float64)]
                prog = c["db"].to(setup.device).double()[:, :mine.shape[1]]
                l1 = (prog - mine).abs().sum(-1)
                q = ref_bow.vectors(cur[0][None], cur[1][None], leaf_bits, weights)[0]
                diag = dict(rows_differ=int((l1 > 1e-6).sum()), row_l1_max=float(l1.max()),
                            rows_over=[int(i) for i in torch.nonzero(l1 > 1e-6)[:8, 0]],
                            scores_on_program_rows=[float(torch.minimum(prog[int(i)], q).sum())
                                                    if 0 <= int(i) < prog.shape[0] else None
                                                    for i in ids])
            rows = c.get("rows") or []
            diag["rows_from_store"] = sum(r is None for r in rows)
            # keyframe rows whose stored descriptors are not those written
            # into the database
            diag["store_rows_differ"] = [
                i for i, r in enumerate(rows) if r is not None and not (
                    torch.equal(r[0].cpu(), c["desc"][i].cpu())
                    and torch.equal(r[1].cpu(), c["valid"][i].cpu()))][:8]
            out["widest_check"] = dict(diag, n=c["n"], ids=[int(i) for i in ids],
                                       scores=[float(x) for x in s_got],
                                       ref_at_ids=[float(s_ref[int(i)]) if 0 <= int(i) < s_ref.shape[0]
                                                   else None for i in ids],
                                       ref_best=[float(x) for x in best], ref_ids=_ids.tolist())
        gap = max(gap, worst)
    out.update(bow_score_gap=gap if cases else math.inf, checks=len(cases))


def _windows(cases, setup: Setup, control_dtype, out: dict):
    gm = gr = excess = share = 0.0
    for c in cases:
        C, L, O = c["key"]
        win = ref_window.unpack(c["ints"], c["floats"], C, L, O, device=setup.device)
        kw = dict(c["kw"])
        pose_ref, lm_ref, cost0, cost_ref = ref_window.solve(win, setup.cam, **kw)
        if control_dtype is None:
            row = torch.as_tensor(c["row"], dtype=torch.float64, device=setup.device)
            pose, lm = row[:C * 6].reshape(C, 6), row[C * 6:C * 6 + L * 3].reshape(L, 3)
        else:
            pose, lm = (x.double() for x in
                        ref_window.solve(win, setup.cam, dtype=control_dtype, **kw)[:2])
        pb = ref_window.Problem(win, setup.cam, kw["kernel_param"], kw["w_prior_rot"],
                                kw["w_prior_trans"])
        cost = float(pb.cost(pose, lm, kw["use_kernel"]))
        if not math.isfinite(cost):
            exc = short = math.inf
        else:
            exc = (cost - cost_ref) / max(cost_ref, cost0 - cost_ref, 1e-30)
            short = (cost - cost_ref) / max(cost0 - cost_ref, 1e-30)
        excess, share = max(excess, exc), max(share, short)
        out.setdefault("window_cases", []).append(dict(
            c, excess=exc, shortfall=short, cost0=cost0, cost_ref=cost_ref, cost=cost,
            valid_cams=int(win.cam_valid.sum()), obs=int(win.obs_valid.sum())))
        pose, pose_ref = pose.cpu().numpy(), pose_ref.cpu().numpy()
        free = win.cam_valid.cpu().numpy() & (np.arange(C) != 0)
        for i in np.flatnonzero(free):
            if not np.isfinite(pose[i]).all():
                gm = gr = math.inf
                continue
            gm = max(gm, float(np.linalg.norm(pose[i, 3:] - pose_ref[i, 3:])))
            gr = max(gr, _angle(rotvec_to_R(pose[i, :3]), rotvec_to_R(pose_ref[i, :3])))
    none = math.inf
    out.update(window_cost_excess=excess if cases else none,
               window_cost_shortfall=share if cases else none,
               window_pose_gap_m=gm if cases else none,
               window_pose_gap_rad=gr if cases else none, windows=len(cases))


def _edges(edges, poses: np.ndarray, out: dict):
    """Each edge's pose (keyframe ``v``'s in keyframe ``u``'s frame) against
    the ground truth's relative pose of the two frames' left cameras; the
    loop edges (their frames over ``LOOP_PATH_M`` of driven path apart)
    counted per session."""
    path = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(poses[:, 3:], axis=0),
                                                           axis=1))])
    rows = []
    for e in edges:
        R_u, R_v = rotvec_to_R(poses[e["u"], :3]), rotvec_to_R(poses[e["v"], :3])
        t = R_u.T @ (poses[e["v"], 3:] - poses[e["u"], 3:])
        pose = np.asarray(e["pose"], np.float64)
        rows.append((float(np.linalg.norm(pose[3:] - t)), _angle(rotvec_to_R(pose[:3]), R_u.T @ R_v),
                     bool(abs(path[e["v"]] - path[e["u"]]) > LOOP_PATH_M), e))
    # the loop edges standing at each session's end
    per, full = {}, set()
    for _m, _r, far, e in rows:
        per[e["session"]] = per.get(e["session"], 0) + far
        if e["full"]:
            full.add(e["session"])
    if full:
        loops = min(per[s] for s in full)
    else:
        loops = per[max(per)] if per else 0
    out.update(edges=len(rows), loop_edges=loops, loop_edges_by_session=per,
               edge_gap_m_max=max((m for m, *_ in rows), default=0.0),
               edge_gap_rad_max=max((r for _m, r, *_ in rows), default=0.0))
    # medians and maxima by kind and reach, and the widest edges to find
    # them again: (m, rad, session, kind, loop, keyframes, frames)
    by = {}
    for m, r, far, e in rows:
        by.setdefault(f"kind{e['kind']}{' loop' if far else ''}", []).append((m, r))
    out["edge_gap_by_kind"] = {k: dict(n=len(v), m_median=float(np.median([m for m, _ in v])),
                                       m_max=max(m for m, _ in v), rad_max=max(r for _, r in v))
                               for k, v in sorted(by.items())}
    out["edge_widest"] = sorted(((m, r, e["session"], e["kind"], far, e["kf_u"], e["kf_v"],
                                  e["u"], e["v"]) for m, r, far, e in rows), reverse=True)[:8]


def compare(cases: dict, setup: Setup, lefts, rights, control_dtype=None) -> dict:
    """The numbers over ``cases`` (:meth:`Recorder.cases`), the program
    against the reference; with ``control_dtype`` the reference in that
    type stands in the program's place. Also the count of each kind of
    case compared."""
    out: dict = {}
    _frames(cases["frames"], setup, lefts, rights, control_dtype, out)
    _checks(cases["checks"], setup, lefts, rights, control_dtype, out)
    _windows(cases["windows"], setup, control_dtype, out)
    out["lc_windows"] = sum(bool(w.get("lc")) for w in cases["windows"])
    if "edges" in cases:
        _edges(cases["edges"], cases["poses"], out)
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Whether every number is within its limit and enough cases of each
    kind were compared; and each number beside its limit. The map's edges
    count where ``limits`` names ``edge_gap_m``, ``edge_gap_rad`` or
    ``loop_edges_min``."""
    checks = {k: dict(value=numbers[k], limit=limits[k]) for k in NUMBERS}
    for kind, least in MIN_CASES.items():
        checks[kind] = dict(value=numbers[kind], limit=least)
    ok = (all(numbers[k] >= least for k, least in MIN_CASES.items())
          and all(numbers[k] <= limits[k] for k in NUMBERS))
    for name in ("edge_gap_m", "edge_gap_rad"):
        if name in limits:
            gap = numbers.get(f"{name}_max", math.inf)
            checks[f"{name}_max"] = dict(value=gap, limit=limits[name])
            ok = ok and gap <= limits[name]
    if "loop_edges_min" in limits:
        count = numbers.get("loop_edges", 0)
        checks["loop_edges"] = dict(value=count, limit=limits["loop_edges_min"])
        ok = ok and count >= limits["loop_edges_min"]
    return ok, checks


def dump_windows(numbers: dict, limit: float, prefix: str) -> list:
    """Keep each compared window whose cost excess is over ``limit`` (its
    packed inputs, options and the program's row) beside the run, so that
    it can be replayed; returns one line on each."""
    lines = []
    for i, w in enumerate(numbers.get("window_cases", [])):
        if not w["excess"] > limit:
            continue
        os.makedirs(os.path.dirname(prefix), exist_ok=True)
        import json

        np.savez(f"{prefix}{i}.npz", ints=w["ints"], floats=w["floats"], row=w["row"],
                 key=np.asarray(w["key"]), kw=json.dumps(w["kw"]))
        lines.append(f"window {i} {tuple(w['key'])} cams {w['valid_cams']} obs {w['obs']} "
                     f"cost0 {w['cost0']!r} ref {w['cost_ref']!r} program {w['cost']!r} "
                     f"(reports {w['row'][-4:].tolist()}) excess {w['excess']!r} "
                     f"shortfall {w['shortfall']!r}")
    return lines


def dump_widest(numbers: dict, path: str):
    """Keep the inputs of the frame with the widest pose gap beside the run
    (``_cache/out/``), so that it can be replayed."""
    w = numbers.get("widest_frame")
    if w is None:
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    import json

    with open(path, "w") as f:
        json.dump(w, f)
