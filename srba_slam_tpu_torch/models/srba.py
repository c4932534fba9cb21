"""Sparser Relative Bundle Adjustment engine (≙ mySRBA/RbaEngine).

Counterpart of ``srba_slam_tpu/models/srba.py``: the SRBA backend the
reference drives (reference src/srba-stereo-slam.h:30-310 and the
define_new_keyframe call sites src/CSRBAStereoSLAMEstimator.cpp:166-168,
782-784):

* keyframes linked by SE(3) kf2kf edges; landmarks parameterized relative to
  their base keyframe; per-insertion local optimization bounded to
  ``max_optimize_depth`` graph hops;
* the custom **submap edge-creation policy** (srba-stereo-slam.h:144-308):
  mid-submap KFs get a single edge to the current localmap center; submap-base
  KFs vote their observations per existing localmap and receive extra edges —
  including loop-closure edges when the topological distance is large and the
  shared-observation count passes ``min_obs_to_loop_closure``;
* loop-closure hooks ``loop_closure_detected`` / ``set_lc_old_id`` /
  ``set_initial_kf_pose`` (srba-stereo-slam.h:85-97), and the loop-closure
  validation layers A and B with their rollback and recovery.

The graph bookkeeping is the JAX package's host numpy, carried over. The
windowed LM + Schur + Cholesky solve runs on the engine's device
(``ops/window_ba.py``), each window padded to one of the JAX engine's
capacity buckets (``window_buckets``).

Solve scheduling is the JAX package's two-stage queue. An insertion builds
its window from the host state and queues it (``_queued``); once half a
group (``WINDOW_SLOTS // 2``) is queued, ``_dispatch_queued`` launches the
queued windows, grouped by bucket, as ``solve_window_group`` calls
(``_pending``; on a card one program replay a group), with no host read.
The results land when the owner reads the host next: ``pending_device_arrays()`` gives the groups' result
blobs to merge into that read, ``commit_pending()`` writes each solve
back through ``_commit_one``, recomputes the spanning tree once and calls
``on_commit``. ``flush()`` lands both stages. The estimator decides when
(its ``solve_sync`` and ``solve_flush_before_insert`` schedules); with
``lazy=False``, ``define_new_keyframe`` flushes before it returns.

With a device mesh (``mesh=``, ``parallel/batch.py``), each window solve
runs observation-sharded over the mesh (``ops/window_ba.py``
``shard_window_obs``; ≙ the JAX engine's mesh branch): one sequence's
bundle adjustment spread over the mesh's devices, its result on the lead
device. It launches at the insertion, a group of one: the window's host
arrays laid out on the host, one pinned upload a shard, and on a card
the solve's rounds as program replays (``window_ba.shard_key``: one set
of programs a bucket), with no host read.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from srba_slam_tpu_torch.models.vo import to_host
from srba_slam_tpu_torch.ops import cuda_graphs
from srba_slam_tpu_torch.ops.window_ba import (
    WINDOW_SLOTS, BAWindow, assembly_plan, optimize_window, optimize_window_blob, pack_window,
    shard_window_obs, solve_window_group,
)
from srba_slam_tpu_torch.utils import se3_np, trace
from srba_slam_tpu_torch.utils.camera import StereoCamera



@dataclass
class SRBAParams:
    """≙ rba.parameters.* + ecp.* (reference .cpp:1149-1160)."""

    submap_size: int = 10
    max_tree_depth: int = 4
    max_optimize_depth: int = 5
    min_obs_to_loop_closure: int = 50
    use_robust_kernel: bool = True
    # stage-1 (pose-only, new-edge refinement) kernel flag + iteration cap
    # (≙ rba.parameters.srba.use_robust_kernel_stage1, reference .cpp:1159)
    use_robust_kernel_stage1: bool = True
    stage1_iters: int = 2
    kernel_param: float = 1.5
    std_noise_pixels: float = 0.5
    max_kfs: int = 512
    # init-anchor prior weights (see ops/window_ba.py — a documented
    # deviation from the reference SRBA objective; 0 disables)
    anchor_prior_w_rot: float = 1000.0
    anchor_prior_w_trans: float = 100.0
    # window capacities (static shapes of the BA program); generous by
    # default — truncation silently weakens loop closures (observed: the
    # 25-KF loop test only snaps shut with all constraints kept)
    win_cams: int = 32
    win_lms: int = 8192
    win_obs: int = 16384
    # LM iteration cap of the window solve (the JAX package's value). The
    # loop exits early once accepted steps stop improving, so the cap only
    # binds on hard windows, and each bound iteration sits on the
    # per-insertion critical path.
    opt_iters: int = 8
    # ---- loop-closure validation (a framework EXTENSION: the reference's
    # only LC gate is tracked > 0.5*best at confirmation, reference
    # .cpp:482-521 — it has no defense against perceptual aliasing, where a
    # geometrically-consistent consensus of repeating-texture matches seeds
    # a long-range edge that folds the map). Two layers:
    #   A. creation-time odometry-consistency gate: a long-range edge's
    #      (geometric) pose seed must agree with the pose composed along the
    #      existing graph to within floor + frac * path_length — bounded
    #      accumulated VO drift is the one global invariant perceptual
    #      aliasing cannot fake (the aliased offset is a world-texture
    #      period, independent of path length).
    #   B. post-solve validation of the committed window: the new KF's
    #      observations of far-area landmarks must reproject within
    #      lc_chi2_px, and the optimized LC edge must stay inside the layer-A
    #      budget; a failure ROLLS BACK the solve (edge removed, window
    #      poses/landmarks restored, mis-associated observations re-based,
    #      window re-solved) and blacklists the area pair.
    lc_validate: bool = True
    lc_reject_drift_frac: float = 0.05
    lc_reject_floor_m: float = 0.35
    lc_chi2_px: float = 3.0
    verbose: bool = False


@dataclass
class NewKFInfo:
    """≙ TNewKeyFrameInfo (reference .cpp:178-181).

    The cost fields are NaN until ``flush()`` lands the window solve
    (``pending`` flips to False then).
    """

    kf_id: int
    created_edges: list
    cost_init: float
    cost_final: float
    obs_rmse: float
    n_window_kfs: int
    n_window_obs: int
    pending: bool = False
    truncated_obs: int = 0
    # ≙ optimize_results_stg1.obs_rmse (reference .cpp:790)
    obs_rmse_stg1: float = float("nan")


class SRBAEngine:
    def __init__(self, cam: StereoCamera, params: SRBAParams | None = None,
                 logger=None, on_commit=None, lazy: bool = False, device="cuda", mesh=None):
        self.cam = cam
        self.p = params or SRBAParams()
        # with a mesh, window solves run observation-sharded over it, on its
        # lead device (which is then the engine's device)
        self.mesh = mesh
        self.device = torch.device(device) if mesh is None else mesh.lead
        self.log = logger if logger is not None else (lambda level, msg: None)
        # called as on_commit(kf_id, old_root_global, new_root_global) after a
        # window solve lands, so the owner can re-anchor bookkeeping
        self.on_commit = on_commit

        self.n_kfs = 0
        # edges: (u, v, T_uv) with T_uv = pose of v in u's frame
        self._edge_cap = 64
        self._edge_u = np.zeros(self._edge_cap, np.int32)
        self._edge_v = np.zeros(self._edge_cap, np.int32)
        self._edge_kind = np.zeros(self._edge_cap, np.int8)
        self._edge_pose = np.zeros((self._edge_cap, 6), np.float64)
        # False = edge removed by a loop-closure rollback; slots are never
        # reused (rare), consumers filter via edge_valid / the adj lists
        self._edge_valid = np.ones(self._edge_cap, bool)
        self.n_edges = 0
        self.adj: dict[int, list[tuple[int, int]]] = {}  # kf -> [(nbr, edge)]
        self.kf_global = np.zeros((self.p.max_kfs, 6), np.float64)
        # landmarks (preallocated growing arrays)
        self._lm_cap = 4096
        self.lm_base = np.zeros(self._lm_cap, np.int32)
        self.lm_pos = np.zeros((self._lm_cap, 3), np.float64)
        # match id that minted each landmark (inverse of _lm_lookup; needed
        # to re-point a match id at a re-based landmark on LC rollback)
        self.lm_match_id = np.full(self._lm_cap, -1, np.int64)
        self.n_lms = 0
        self._lookup_cap = 8192
        self._lm_lookup = np.full(self._lookup_cap, -1, np.int32)  # lm id -> idx
        # observations
        self._obs_cap = 4096
        self.obs_kf = np.zeros(self._obs_cap, np.int32)
        self.obs_lm = np.zeros(self._obs_cap, np.int32)
        self.obs_px = np.zeros((self._obs_cap, 3), np.float64)
        self.n_obs = 0
        # loop-closure hooks (≙ srba-stereo-slam.h:85-97)
        self._lc_detected = False
        self._lc_old_id: int | None = None
        self._initial_rel_pose: np.ndarray | None = None
        self.localmap_center = np.full(self.p.max_kfs, -1, np.int32)
        # loop-closure validation state (see SRBAParams.lc_validate):
        # blacklisted unordered area pairs, last-insert creation-time
        # rejections [(target_center, new_kf)], and the owner's rollback
        # callback on_lc_reject(root_kf, target_center, stage) with stage
        # "create" (layer A) or "solve" (layer B)
        self.lc_blacklist: set[tuple[int, int]] = set()
        self.lc_rejects_last_insert: list[tuple[int, int]] = []
        self.on_lc_reject = None
        # lazy=True leaves built windows queued until the owner's flush();
        # lazy=False lands them before define_new_keyframe returns
        self.lazy = lazy
        self._queued: list[dict] = []   # built windows, not yet launched
        # the first packed window of each (C, L, O) bucket met (with a mesh:
        # its host arrays), for capture_window_programs
        self._met: dict = {}
        # launched groups: dict(blob=[WINDOW_SLOTS, row] on the device,
        # entries=the group's windows in slot order), oldest first
        self._pending: list[dict] = []

    # ------------------------------------------------------------------ hooks
    def loop_closure_detected(self, flag: bool = True):
        self._lc_detected = flag

    def set_lc_old_id(self, kf_id: int):
        self._lc_old_id = kf_id

    def set_initial_kf_pose(self, rel_pose: np.ndarray):
        """Initial guess for the new KF's pose relative to the PREVIOUS KF
        (≙ setInitialKFPose, used when use_initial_pose is on)."""
        self._initial_rel_pose = np.asarray(rel_pose, np.float64)

    # ------------------------------------------------------------ graph utils
    def _add_edge(self, u: int, v: int, pose_uv: np.ndarray,
                  kind: int = 0) -> int:
        """``kind``: 0 = mid-submap edge to the localmap center, 1 = submap
        base's top-voted area edge, 2 = loop-closure edge (topo-distance
        gated extra edge or the estimator-confirmed LC) — recorded for the
        annotated graph exports (≙ the diagnostic value of the reference's
        SRBA dot/graph exports, .cpp:801, :1094-1095)."""
        e = self.n_edges
        if e == self._edge_cap:
            self._edge_cap *= 2
            self._edge_u = np.concatenate(
                [self._edge_u, np.zeros_like(self._edge_u)])
            self._edge_v = np.concatenate(
                [self._edge_v, np.zeros_like(self._edge_v)])
            self._edge_pose = np.concatenate(
                [self._edge_pose, np.zeros_like(self._edge_pose)])
            self._edge_kind = np.concatenate(
                [self._edge_kind, np.zeros_like(self._edge_kind)])
            self._edge_valid = np.concatenate(
                [self._edge_valid, np.ones_like(self._edge_valid)])
        self._edge_u[e] = u
        self._edge_v[e] = v
        self._edge_pose[e] = np.asarray(pose_uv, np.float64)
        self._edge_kind[e] = kind
        self._edge_valid[e] = True
        self.adj.setdefault(u, []).append((v, e))
        self.adj.setdefault(v, []).append((u, e))
        self.n_edges += 1
        return e

    def spanning_tree(self, root: int, max_depth: int | None = None,
                      allow_stale: bool = False):
        """BFS tree: kf -> (hops, pose of kf in root's frame), composed along
        current edge estimates (≙ create_complete_spanning_tree +
        rba_state.spanning_tree topological distances). Pose composition is
        batched per BFS level.

        ``allow_stale=True`` skips flushing a pending window solve (poses may
        be one refinement old) — for callers that only need rough poses and
        must not force an extra device sync, e.g. DA seeding."""
        if not allow_stale:
            self.flush()
        out = {root: (0, np.zeros(6))}
        pose_of = {root: np.zeros(6)}
        frontier = [root]
        depth = 0
        while frontier and (max_depth is None or depth < max_depth):
            parents, edges, nbrs = [], [], []
            seen_this = set()
            for k in frontier:
                for nbr, e in self.adj.get(k, ()):
                    if nbr in out or nbr in seen_this:
                        continue
                    seen_this.add(nbr)
                    parents.append(k)
                    edges.append(e)
                    nbrs.append(nbr)
            if not nbrs:
                break
            eidx = np.asarray(edges, np.int64)
            rel = self._edge_pose[eidx]
            flip = self._edge_u[eidx] != np.asarray(parents)
            if flip.any():
                rel = np.where(flip[:, None], se3_np.inverse_batch(rel), rel)
            parent_poses = np.stack([pose_of[p] for p in parents])
            new_poses = se3_np.compose_batch(parent_poses, rel)
            depth += 1
            for nbr, pose in zip(nbrs, new_poses):
                out[nbr] = (depth, pose)
                pose_of[nbr] = pose
            frontier = nbrs
        return out

    def topo_distance(self, a: int, b: int, max_depth: int | None = None) -> int:
        """Graph hops between a and b (integer BFS only — no pose algebra);
        a large sentinel when unreachable within max_depth."""
        if a == b:
            return 0
        visited = {a}
        frontier = [a]
        depth = 0
        while frontier and (max_depth is None or depth < max_depth):
            depth += 1
            nxt = []
            for k in frontier:
                for nbr, _e in self.adj.get(k, ()):
                    if nbr in visited:
                        continue
                    if nbr == b:
                        return depth
                    visited.add(nbr)
                    nxt.append(nbr)
            frontier = nxt
        return 1 << 30

    # ------------------------------------------------- loop-closure validation
    def _path_pose_len(self, root: int, exclude: frozenset = frozenset()):
        """BFS from ``root`` returning {kf: (hops, pose_in_root_frame,
        path_translation_length_m)}; ``exclude`` = edge ids to skip. The
        per-edge translation norms accumulate into the drift budget of the
        loop-closure consistency gate."""
        out = {root: (0, np.zeros(6), 0.0)}
        frontier = [root]
        while frontier:
            nxt = []
            for k in frontier:
                _h, pk, lk = out[k]
                for nbr, e in self.adj.get(k, ()):
                    if nbr in out or e in exclude:
                        continue
                    rel = self._edge_pose[e]
                    if self._edge_u[e] != k:
                        rel = se3_np.inverse(rel)
                    out[nbr] = (out[k][0] + 1, se3_np.compose(pk, rel),
                                lk + float(np.linalg.norm(rel[3:])))
                    nxt.append(nbr)
            frontier = nxt
        return out

    def _alt_path_entry(self, u: int, kf: int,
                        exclude: frozenset = frozenset()):
        """The ALTERNATIVE (non-loop-closure) pose chain u->kf: the BFS path
        through the existing graph, or — when ``kf``'s only connection is
        the very edge under scrutiny (``exclude``d) — the path to kf-1 plus
        the odometry increment from the global pose chain. Returns
        (hops, pose_of_kf_in_u_frame, path_translation_length_m) or None
        when no chain reaches kf at all."""
        paths = self._path_pose_len(u, exclude)
        ent = paths.get(kf)
        if ent is None:
            prev = paths.get(kf - 1)
            if prev is None:
                return None
            rel_prev = se3_np.relative(self.kf_global[kf],
                                       self.kf_global[kf - 1])
            ent = (prev[0] + 1, se3_np.compose(prev[1], rel_prev),
                   prev[2] + float(np.linalg.norm(rel_prev[3:])))
        return ent

    def _lc_consistency(self, u: int, kf: int, pose_uv: np.ndarray,
                        exclude: frozenset = frozenset()):
        """Layer-A check: does a candidate long-range edge u->kf with pose
        seed ``pose_uv`` agree with the pose composed along the EXISTING
        graph (the odometry/graph chain), to within the accumulated-drift
        budget floor + frac * path_length?

        Perceptual aliasing produces edges offset by a world-texture period
        — a constant, independent of how far the camera travelled — while
        honest VO drift is bounded by a small fraction of path length, so
        the budget separates them globally where no per-match filter can
        (the aliased matches themselves are real and self-consistent).

        Returns (ok, info dict). Short paths (< max_optimize_depth hops)
        are trivially consistent — near edges compose from odometry.
        """
        ent = self._alt_path_entry(u, kf, exclude)
        if ent is None:
            return True, {}
        hops, alt, plen = ent
        if hops < self.p.max_optimize_depth:
            return True, {}
        d = float(np.linalg.norm(np.asarray(pose_uv)[3:] - alt[3:]))
        budget = self.p.lc_reject_floor_m + self.p.lc_reject_drift_frac * plen
        info = dict(disagreement_m=d, budget_m=budget, path_len_m=plen,
                    hops=hops, alt=alt)
        return d <= budget, info

    def _area_of(self, kf: int) -> int:
        c = int(self.localmap_center[kf])
        return c if c >= 0 else int(kf)

    def lc_budget(self, u: int, kf: int) -> float:
        """Drift budget (meters) for a loop closure between area(u) and kf
        along the current graph: floor + frac * path_length."""
        ent = self._alt_path_entry(self._area_of(u), kf)
        plen = ent[2] if ent is not None else 0.0
        return self.p.lc_reject_floor_m + self.p.lc_reject_drift_frac * plen

    def is_lc_blacklisted(self, a: int, b: int) -> bool:
        """Has a loop closure between these two areas been rejected before?"""
        return (min(a, b), max(a, b)) in self.lc_blacklist

    def _reject_lc_edge(self, u: int, kf: int, stage: str, info: dict):
        """Record + broadcast a loop-closure rejection (both layers)."""
        pair = (min(self._area_of(u), self._area_of(kf)),
                max(self._area_of(u), self._area_of(kf)))
        self.lc_blacklist.add(pair)
        self.lc_rejects_last_insert.append((u, kf))
        why = (
            "no coherent geometric seed from the shared observations"
            if info.get("no_geometric_seed") else
            f"pose disagrees with the graph chain by "
            f"{info.get('disagreement_m', float('nan')):.2f} m over a "
            f"{info.get('path_len_m', float('nan')):.1f} m path (budget "
            f"{info.get('budget_m', float('nan')):.2f} m"
            + (f", far-obs rmse {info['chi_px']:.2f} px"
               if 'chi_px' in info else "") + ")")
        print(
            f"WARNING kf{kf}: loop-closure edge to area {u} REJECTED at "
            f"{stage}: {why} — area pair {pair} blacklisted", flush=True)
        if self.on_lc_reject is not None:
            self.on_lc_reject(kf, u, stage)

    def _triangulate_np(self, px: np.ndarray) -> np.ndarray:
        """Host-side inverse stereo projection of px rows [N, 3] = (ul, vl,
        ur) — the projectMatchTo3D formula (reference utils.h:558-574)."""
        ul, vl, ur = px[..., 0], px[..., 1], px[..., 2]
        c = self.cam
        b_d = c.baseline / (c.fx_l * (c.cx_r - ur) + c.fx_r * (ul - c.cx_l))
        return np.stack([b_d * c.fx_r * (ul - c.cx_l),
                         b_d * c.fx_r * (vl - c.cy_l),
                         b_d * c.fx_l * c.fx_r * np.ones_like(ul)], axis=-1)

    def _rebase_far_obs(self, root: int, centers: set[int]) -> int:
        """After rejecting a loop closure root->center, the root keyframe's
        observations that were data-associated to landmarks of the rejected
        far area(s) are MIS-associations (the aliased consensus). Re-base
        each as a fresh landmark at root (position from its own stereo
        triangulation) and re-point the match id so FUTURE tracks of the
        feature observe the new landmark; the far landmark keeps its own
        history. Returns the number of re-based observations."""
        rows = np.nonzero(self.obs_kf[: self.n_obs] == root)[0]
        n_moved = 0
        for o in rows:
            li = int(self.obs_lm[o])
            base = int(self.lm_base[li])
            if base == root or self._area_of(base) not in centers:
                continue
            mid = int(self.lm_match_id[li])
            new_idx = self.n_lms
            if new_idx == self._lm_cap:
                self._lm_cap *= 2
                self.lm_base = np.concatenate(
                    [self.lm_base, np.zeros_like(self.lm_base)])
                self.lm_pos = np.concatenate(
                    [self.lm_pos, np.zeros_like(self.lm_pos)])
                self.lm_match_id = np.concatenate(
                    [self.lm_match_id,
                     np.full_like(self.lm_match_id, -1)])
            self.lm_base[new_idx] = root
            self.lm_pos[new_idx] = self._triangulate_np(self.obs_px[o])
            self.lm_match_id[new_idx] = mid
            if mid >= 0:
                self._lm_lookup[mid] = new_idx
            self.obs_lm[o] = new_idx
            self.n_lms += 1
            n_moved += 1
        return n_moved

    def reassociate_obs(self, root: int, id_pairs: list[tuple[int, int]],
                        target_area: int) -> int:
        """Loop-closure recovery: re-point ``root``'s observations minted
        under ``old_id`` onto the FAR landmark of ``new_id`` in
        ``target_area`` (the odometry-consistent re-check's winner). The
        rejection's ``_rebase_far_obs`` may have re-pointed ``new_id`` at a
        root-based stand-in, so the far landmark is resolved through
        ``lm_match_id`` + its base area, and the id mapping restored. The
        displaced stand-in landmark is orphaned — single-observation
        landmarks are inert in window solves. ``id_pairs`` =
        [(old_match_id, new_match_id)]; pairs with old == new re-point the
        re-based rows back onto the far landmark."""
        n_moved = 0
        for old_id, new_id in id_pairs:
            if new_id < 0 or new_id >= self._lookup_cap:
                continue
            cands = np.nonzero(self.lm_match_id[: self.n_lms] == new_id)[0]
            far = [c for c in cands
                   if int(self.lm_base[c]) != root
                   and self._area_of(int(self.lm_base[c])) == target_area]
            if far:
                new_lm = int(far[0])
            else:
                new_lm = int(self._lm_lookup[new_id])
                if new_lm < 0 or int(self.lm_base[new_lm]) == root:
                    continue  # no far geometry to re-attach to
            old_lm = int(self._lm_lookup[old_id]) if \
                0 <= old_id < self._lookup_cap else -1
            if old_lm < 0:
                continue
            rows = np.nonzero((self.obs_kf[: self.n_obs] == root)
                              & (self.obs_lm[: self.n_obs] == old_lm))[0]
            if not len(rows):
                continue
            self.obs_lm[rows] = new_lm
            self._lm_lookup[new_id] = new_lm
            if old_id != new_id:
                self._lm_lookup[old_id] = -1  # orphan the stand-in
            n_moved += len(rows)
        return n_moved

    def retry_lc_edge(self, root: int, target: int) -> bool:
        """Loop-closure recovery (step 3): after the odometry-seeded
        re-association, attempt the loop-closure edge target_area -> root
        again — geometric seed from the (now odometry-consistent) shared
        observations, layer-A gate, un-blacklist + window re-solve on
        success. Returns True when the edge was created."""
        u = self._area_of(target)
        if u == root:
            return False
        rows = np.nonzero(self.obs_kf[: self.n_obs] == root)[0]
        obs_lm_idx = self.obs_lm[rows]
        obs_pts = self._triangulate_np(self.obs_px[rows])
        pose = self._geometric_edge_seed(u, root, obs_lm_idx, obs_pts)
        if pose is None:
            return False
        ok, info = self._lc_consistency(u, root, pose)
        if not ok:
            self.log(1, f"kf{root}: recovery edge to area {u} still fails "
                        f"the consistency gate "
                        f"({info.get('disagreement_m', 0):.2f} m > "
                        f"{info.get('budget_m', 0):.2f} m)")
            return False
        e = self._add_edge(u, root, pose, kind=2)
        pair = (min(self._area_of(u), self._area_of(root)),
                max(self._area_of(u), self._area_of(root)))
        self.lc_blacklist.discard(pair)
        print(f"kf{root}: loop closure to area {u} RECOVERED via "
              f"odometry-seeded re-association (disagreement "
              f"{info.get('disagreement_m', 0):.2f} m within budget "
              f"{info.get('budget_m', 0):.2f} m)", flush=True)
        self._dispatch_window_opt(root, [e])
        return True

    # --------------------------------------------------- edge creation policy
    def _geometric_edge_seed(self, u: int, kf: int, obs_lm_idx: np.ndarray,
                             obs_pts: np.ndarray | None):
        """Initial pose for a long-range (loop-closure) edge u -> kf from the
        SHARED landmark geometry instead of the drift-accumulated globals.

        ≙ the reference's ``has_approx_init_val = false`` on loop-closure
        edges (srba-stereo-slam.h:279-281): SRBA estimates those initial
        relative poses from the observations. Here: Horn/Umeyama 3D-3D
        alignment between the common landmarks' positions in u's frame
        (composed along the spanning tree from their base KFs) and the new
        KF's triangulated observations of them, with one outlier-trim pass.
        Returns the edge pose T_uv (pose of kf in u's frame) or None when
        the geometry is too thin; callers fall back to the global-pose seed.
        A drift-consistent seed encodes no loop information — the robust
        kernel then treats the true loop residuals as outliers and the loop
        never closes."""
        if obs_pts is None or len(obs_lm_idx) < 8:
            return None
        bases = self.lm_base[obs_lm_idx]
        mask = (bases != kf) & np.isfinite(obs_pts).all(axis=1)
        # restrict to landmarks of u's OWN area: mixing in recent-chain
        # landmarks (placed via the drifted odometry tree) makes the two
        # point sets disagree by exactly the loop drift and the fit rejects
        base_centers = np.where(self.localmap_center[bases] >= 0,
                                self.localmap_center[bases], bases)
        own_area = mask & (base_centers == u)
        if own_area.sum() >= 8:
            mask = own_area
        if mask.sum() < 8:
            return None
        tree = self.spanning_tree(u, allow_stale=True)
        li = obs_lm_idx[mask]
        q = obs_pts[mask]
        p_u = np.zeros_like(q)
        ok = np.zeros(len(li), bool)
        for j, (lm, base) in enumerate(zip(li, bases[mask])):
            ent = tree.get(int(base))
            if ent is None:
                continue
            p_u[j] = se3_np.transform_point(ent[1], self.lm_pos[lm])
            ok[j] = True
        if ok.sum() < 8:
            return None
        from srba_slam_tpu_torch.utils.evaluation import align_se3

        p_sel, q_sel = p_u[ok], q[ok]
        R, t = align_se3(q_sel, p_sel)          # R q + t ~ p
        res = np.linalg.norm(q_sel @ R.T + t - p_sel, axis=1)
        keep = res <= max(3.0 * np.median(res), 1e-6)
        if keep.sum() >= 8:
            R, t = align_se3(q_sel[keep], p_sel[keep])
            res = np.linalg.norm(q_sel[keep] @ R.T + t - p_sel[keep], axis=1)
        if np.median(res) > 1.0:  # meters — geometry didn't agree
            return None
        return se3_np.log(R, t)

    def _edge_creation_policy(self, kf: int, obs_lm_idx: np.ndarray,
                              obs_pts: np.ndarray | None = None) -> list:
        """≙ mySRBA::edge_creation_policy (srba-stereo-slam.h:144-308)."""
        p = self.p
        created = []
        is_base = kf % p.submap_size == 0
        cur_center = (kf // p.submap_size) * p.submap_size

        def seed(u, v):
            return se3_np.relative(self.kf_global[v], self.kf_global[u])

        def lc_seed(u, v):
            g = self._geometric_edge_seed(u, v, obs_lm_idx, obs_pts)
            return g if g is not None else seed(u, v)

        def try_far_edge(u, v, kind):
            """Create a (potentially long-range) edge u->v, gated by the
            layer-A odometry-consistency check and the rejection blacklist
            (see SRBAParams.lc_validate). Returns the edge id or None."""
            if p.lc_validate and self.is_lc_blacklisted(self._area_of(u),
                                                        self._area_of(v)):
                self.log(1, f"kf{v}: skipping edge to blacklisted area {u}")
                self.lc_rejects_last_insert.append((u, v))
                return None
            g = self._geometric_edge_seed(u, v, obs_lm_idx, obs_pts)
            pose = g if g is not None else seed(u, v)
            if p.lc_validate:
                ok, info = self._lc_consistency(u, v, pose)
                if ok and info and g is None and kind == 2:
                    # long-range loop-closure edge with NO coherent
                    # geometric seed: the shared-observation geometry is
                    # internally inconsistent (a mixed/aliased consensus) —
                    # the drift-consistent fallback seed trivially passes
                    # the gate but the window solve then drags the edge to
                    # whatever the (wrong) observations agree on. Reject;
                    # the estimator's recovery pass re-associates from the
                    # odometry prior and retries with a clean seed.
                    ok = False
                    info = dict(info, no_geometric_seed=True)
                if not ok:
                    self._reject_lc_edge(u, v, "create", info)
                    return None
                if info:
                    self.log(1, f"kf{v}: far edge to area {u} within "
                                f"budget ({info['disagreement_m']:.2f} m <= "
                                f"{info['budget_m']:.2f} m)")
            return self._add_edge(u, v, pose, kind=kind)

        if not is_base:
            # mid-submap: single edge to the current localmap center
            self.localmap_center[kf] = cur_center
            created.append(self._add_edge(cur_center, kf, seed(cur_center, kf),
                                          kind=0))
        else:
            # new submap base: vote observations per existing localmap
            # center. Only landmarks with an EXISTING base keyframe vote —
            # in the reference, edges are created before the new KF's fresh
            # landmarks are initialized, so they have no base to count
            # (srba-stereo-slam.h:221 make_ordered_list_base_kfs); counting
            # them here would self-vote kf and isolate it behind a self-edge.
            self.localmap_center[kf] = kf
            bases = self.lm_base[obs_lm_idx] if len(obs_lm_idx) else \
                np.zeros(0, np.int32)
            bases = bases[bases != kf]
            if len(bases):
                centers = self.localmap_center[bases]
                centers = np.where(centers >= 0, centers, bases)
                counts = np.bincount(centers)
                order = np.argsort(-counts, kind="stable")
                ranked = [(int(c), int(counts[c])) for c in order if counts[c] > 0]
            else:
                prev_c = int(self.localmap_center[kf - 1])
                ranked = [(prev_c if prev_c >= 0 else kf - 1, 1)]
            # every base-KF area edge is estimated from the shared
            # observations (≙ has_approx_init_val=false on all edges of the
            # base branch, srba-stereo-slam.h:279-294) — the top-voted area
            # can be a far loop-closure target, where a drift-consistent
            # seed would hide the loop
            top_center = ranked[0][0]
            # annotation: the top-voted edge IS the loop-closure edge when
            # it lands on the estimator-confirmed LC target's area
            lc_target = (int(self.localmap_center[self._lc_old_id])
                         if self._lc_detected and self._lc_old_id is not None
                         else None)
            if lc_target is not None and lc_target < 0:
                lc_target = self._lc_old_id
            e0 = try_far_edge(top_center, kf,
                              2 if top_center == lc_target else 1)
            if e0 is None:
                # the top-voted (possibly aliased) area was rejected: anchor
                # the new base KF to the ODOMETRY predecessor's area instead
                # so the graph stays connected along the travelled chain
                fb = self._area_of(kf - 1)
                e0 = self._add_edge(fb, kf, seed(fb, kf), kind=1)
            created.append(e0)
            # extra edges: far-away well-supported areas => loop-closure edges
            for center, n in ranked[1:]:
                if n < p.min_obs_to_loop_closure:
                    continue
                if self.topo_distance(kf, center, p.max_optimize_depth + 1) \
                        >= p.max_optimize_depth:
                    e = try_far_edge(center, kf, 2)
                    if e is not None:
                        created.append(e)
        # explicit LC edge requested by the estimator's confirmation stage
        if self._lc_detected and self._lc_old_id is not None:
            target = int(self.localmap_center[self._lc_old_id])
            if target < 0:
                target = self._lc_old_id
            have = {int(self._edge_u[e]) for e in created} | \
                   {int(self._edge_v[e]) for e in created}
            if target not in have and target != kf:
                e = try_far_edge(target, kf, 2)
                if e is not None:
                    created.append(e)
        self._lc_detected = False
        self._lc_old_id = None
        return created

    # ------------------------------------------------------------- insertion
    def define_new_keyframe(self, observations, run_opt: bool = True) -> NewKFInfo:
        """Insert a keyframe.

        observations: either an iterable of (lm_id, ul, vl, ur,
        rel_pos3d_or_None) — ≙ the obs list built at reference .cpp:139-161 /
        685-728 — or a pre-vectorized tuple of arrays
        ``(lm_ids [N], px [N, 3], rel_pos [N, 3])`` (rows with non-finite
        rel_pos fall back to the default initialization).

        The window solve is queued: ``flush()`` lands it (the estimator
        calls it right after the insertion), or this call does before it
        returns when the engine is not ``lazy``.
        """
        kf = self.n_kfs
        assert kf < self.p.max_kfs
        self.n_kfs += 1
        self.lc_rejects_last_insert = []

        # initial global pose estimate
        if kf == 0:
            self.kf_global[0] = 0.0
        else:
            rel = (
                self._initial_rel_pose
                if self._initial_rel_pose is not None
                else np.zeros(6)
            )
            self.kf_global[kf] = se3_np.compose(self.kf_global[kf - 1], rel)
        self._initial_rel_pose = None

        lm_ids, px, rel_pos = _obs_as_arrays(observations)
        obs_lm_idx = self._register_observations(kf, lm_ids, px, rel_pos)

        created = [] if kf == 0 else self._edge_creation_policy(
            kf, obs_lm_idx, rel_pos)
        if self.lc_rejects_last_insert:
            # creation-time rejections: the DA consensus behind the rejected
            # edge is a mis-association — re-base those observations as
            # fresh landmarks at kf so they stop voting for the aliased area
            centers = {self._area_of(u)
                       for (u, v) in self.lc_rejects_last_insert if v == kf}
            moved = self._rebase_far_obs(kf, centers)
            if moved:
                self.log(1, f"kf{kf}: re-based {moved} observations off "
                            f"rejected area(s) {sorted(centers)}")

        if not run_opt or kf == 0:
            return NewKFInfo(kf, created, 0.0, 0.0, 0.0, 1, len(obs_lm_idx))
        info = self._dispatch_window_opt(kf, created)
        if not self.lazy:
            self.flush()
        return info

    def _register_observations(self, kf: int, lm_ids: np.ndarray,
                               px: np.ndarray, rel_pos: np.ndarray) -> np.ndarray:
        """Vectorized landmark registration + observation append. Returns the
        landmark indices of the new KF's observations."""
        n = len(lm_ids)
        if n == 0:
            return np.zeros(0, np.int64)
        max_id = int(lm_ids.max())
        if max_id >= self._lookup_cap:
            new_cap = max(self._lookup_cap * 2, max_id + 1)
            grown = np.full(new_cap, -1, np.int32)
            grown[: self._lookup_cap] = self._lm_lookup
            self._lm_lookup = grown
            self._lookup_cap = new_cap
        li = self._lm_lookup[lm_ids].astype(np.int64)
        new_mask = li < 0
        n_new = int(new_mask.sum())
        if n_new:
            while self.n_lms + n_new > self._lm_cap:
                self._lm_cap *= 2
                self.lm_base = np.concatenate(
                    [self.lm_base, np.zeros_like(self.lm_base)])
                self.lm_pos = np.concatenate(
                    [self.lm_pos, np.zeros_like(self.lm_pos)])
                self.lm_match_id = np.concatenate(
                    [self.lm_match_id, np.full_like(self.lm_match_id, -1)])
            new_idx = self.n_lms + np.arange(n_new)
            self._lm_lookup[lm_ids[new_mask]] = new_idx
            li[new_mask] = new_idx
            self.lm_base[new_idx] = kf
            self.lm_match_id[new_idx] = lm_ids[new_mask]
            rel_new = rel_pos[new_mask]
            ok = np.isfinite(rel_new).all(axis=1)
            self.lm_pos[new_idx] = np.where(
                ok[:, None], rel_new, np.array([0.0, 0.0, 10.0]))
            self.n_lms += n_new
        while self.n_obs + n > self._obs_cap:
            self._obs_cap *= 2
            self.obs_kf = np.concatenate([self.obs_kf, np.zeros_like(self.obs_kf)])
            self.obs_lm = np.concatenate([self.obs_lm, np.zeros_like(self.obs_lm)])
            self.obs_px = np.concatenate([self.obs_px, np.zeros_like(self.obs_px)])
        sl = slice(self.n_obs, self.n_obs + n)
        self.obs_kf[sl] = kf
        self.obs_lm[sl] = li
        self.obs_px[sl] = px
        self.n_obs += n
        return li

    # ----------------------------------------------------------- optimization
    def window_buckets(self) -> list[tuple[int, int, int]]:
        """The (C, L, O) capacities a window is padded to, smallest first
        (the JAX engine's ladder); the last is the engine's capacity."""
        p = self.p
        return [
            (min(8, p.win_cams), min(512, p.win_lms), min(1024, p.win_obs)),
            (min(8, p.win_cams), min(1024, p.win_lms), min(2048, p.win_obs)),
            (min(16, p.win_cams), min(1024, p.win_lms), min(2048, p.win_obs)),
            (p.win_cams, min(2048, p.win_lms), min(4096, p.win_obs)),
            (p.win_cams, p.win_lms, p.win_obs),
        ]

    def _dispatch_window_opt(self, root: int, created_edges) -> NewKFInfo:
        """Build the <= max_optimize_depth window from the current host state
        and queue it; ``flush()`` solves it."""
        p = self.p
        tree = self.spanning_tree(root, p.max_optimize_depth, allow_stale=True)
        # nearest-first, capped at the static capacity
        win_kfs = sorted(tree.keys(), key=lambda k: (tree[k][0], -k))[: p.win_cams]
        assert win_kfs[0] == root

        win_map = np.full(self.n_kfs, -1, np.int32)
        win_map[win_kfs] = np.arange(len(win_kfs))
        obs_kf = self.obs_kf[: self.n_obs]
        obs_lm = self.obs_lm[: self.n_obs]
        in_win = win_map[obs_kf] >= 0
        base_in_win = win_map[self.lm_base[obs_lm]] >= 0
        sel = np.nonzero(in_win & base_in_win)[0]
        # local landmark set; over capacity, keep the BEST-SUPPORTED
        # landmarks (most in-window observations; ties broken by id for
        # determinism) — an arbitrary id-prefix would silently drop exactly
        # the well-tracked landmarks a loop-closure window needs
        lms, lm_counts = np.unique(obs_lm[sel], return_counts=True)
        # prune single-observation landmarks: a landmark with ONE in-window
        # stereo observation has an invertible 3x3 J_l^T J_l, so the Schur
        # complement cancels its camera information EXACTLY (O(lambda) with
        # damping) — it cannot move any pose, and re-"optimizing" it only
        # adds damping noise to its estimate. Measured on the street
        # workload they are ~85% of window landmarks; pruning keeps windows
        # small (5-8x cheaper per LM iteration).
        n_pruned_single = 0
        multi = lm_counts >= 2
        if multi.any() and not multi.all():
            n_pruned_single = int(lm_counts[~multi].sum())
            lms, lm_counts = lms[multi], lm_counts[multi]
        if len(lms) > p.win_lms:
            keep = np.argsort(-lm_counts, kind="stable")[: p.win_lms]
            lms = np.sort(lms[keep])
        if len(sel) > p.win_obs:
            sel = sel[-p.win_obs:]  # favor recent observations
        lm_map = np.full(self.n_lms, -1, np.int32)
        lm_map[lms] = np.arange(len(lms))
        sel = sel[lm_map[obs_lm[sel]] >= 0]
        lms_in_sel = np.unique(obs_lm[sel])
        if len(lms_in_sel) < len(lms):
            lms = lms_in_sel
            lm_map[:] = -1
            lm_map[lms] = np.arange(len(lms))
        n_dropped = int((in_win & base_in_win).sum()) - len(sel) \
            - n_pruned_single
        if n_dropped > 0:
            # long-range (loop-closure-scale) edge inside the window =>
            # truncation directly weakens the closure: warn unconditionally
            eu_w = self._edge_u[: self.n_edges]
            ev_w = self._edge_v[: self.n_edges]
            both_in = (win_map[np.clip(eu_w, 0, self.n_kfs - 1)] >= 0) & \
                      (win_map[np.clip(ev_w, 0, self.n_kfs - 1)] >= 0)
            has_lc_edge = bool(
                (np.abs(eu_w - ev_w)[both_in] > p.submap_size).any())
            msg = (
                f"WARNING kf{root}: window capacity truncated {n_dropped} "
                f"observations (win_lms={p.win_lms}, win_obs={p.win_obs}) — "
                "loop-closure strength may suffer"
            )
            if has_lc_edge:
                print(msg + " [loop-closure edge in window]", flush=True)
            else:
                self.log(1, msg)

        # the JAX engine's capacity buckets: every window of a bucket solves
        # on the same shapes, so its LM blocks replay as CUDA graphs. The
        # ladder reflects post-pruning shapes: landmark/observation counts
        # stay small (multi-obs landmarks only), while deep spanning-tree
        # balls still raise the camera count.
        for C, L, O in self.window_buckets():
            if len(win_kfs) <= C and len(lms) <= L and len(sel) <= O:
                break
        win_arr = np.asarray(win_kfs)
        cam_pose = np.zeros((C, 6), np.float32)
        cam_valid = np.zeros(C, bool)
        # initialize window poses ALONG THE SPANNING TREE from the root (the
        # relative SRBA parameterization), not from global-pose differences:
        # a freshly created loop-closure edge with a geometric seed places
        # the far area correctly relative to the root, so the BA starts near
        # the reconciled geometry instead of the drifted one (where the
        # robust kernel would discard the true loop residuals as outliers)
        cam_pose[: len(win_kfs)] = np.stack([tree[k][1] for k in win_kfs])
        cam_valid[: len(win_kfs)] = True
        lm_pos = np.zeros((L, 3), np.float32)
        lm_base_loc = np.zeros(L, np.int32)
        lm_valid = np.zeros(L, bool)
        lm_pos[: len(lms)] = self.lm_pos[lms]
        lm_base_loc[: len(lms)] = win_map[self.lm_base[lms]]
        lm_valid[: len(lms)] = True
        oc = np.zeros(O, np.int32)
        ol = np.zeros(O, np.int32)
        opx = np.zeros((O, 3), np.float32)
        ov = np.zeros(O, bool)
        n_o = len(sel)
        oc[:n_o] = win_map[obs_kf[sel]]
        ol[:n_o] = lm_map[obs_lm[sel]]
        opx[:n_o] = self.obs_px[: self.n_obs][sel]
        ov[:n_o] = True

        # layer-B validation plan: fresh loop-closure edges of THIS insertion
        # get re-checked against the COMMITTED solve (post-solve edge pose vs
        # the layer-A alternative-path budget + reprojection rmse of the new
        # KF's far-area observations), with a full rollback on failure
        lc_checks = []
        lc_snap = None
        if p.lc_validate and created_edges:
            fresh_lc = [e for e in created_edges
                        if self._edge_kind[e] == 2 and self._edge_valid[e]
                        and int(self._edge_v[e]) == root]
            exclude = frozenset(fresh_lc)
            for e in fresh_lc:
                u = int(self._edge_u[e])
                u_loc = int(win_map[u]) if u < len(win_map) else -1
                if u_loc < 0:
                    continue  # capacity trimmed the far target: cannot check
                # alternative chain EXCLUDING the fresh LC edges — when the
                # LC edge is kf's only connection this rides the graph to
                # kf-1 and appends the odometry increment, exactly like the
                # creation-time gate did
                ent = self._alt_path_entry(u, root, exclude)
                if ent is None:
                    continue  # nothing reaches root at all: cannot check
                _hops, alt, plen = ent
                rows = sel[obs_kf[sel] == root]
                if len(rows):
                    area_u = self._area_of(u)
                    bases = self.lm_base[obs_lm[rows]]
                    own_c = np.where(self.localmap_center[bases] >= 0,
                                     self.localmap_center[bases], bases)
                    rows = rows[own_c == area_u]
                lc_checks.append(dict(
                    e=e, u=u, u_loc=u_loc, alt=alt, plen=plen,
                    budget=p.lc_reject_floor_m + p.lc_reject_drift_frac * plen,
                    chi_ll=lm_map[obs_lm[rows]].copy(),
                    chi_px=self.obs_px[rows].copy(),
                ))
            if lc_checks:
                eu_all = self._edge_u[: self.n_edges]
                ev_all = self._edge_v[: self.n_edges]
                hi = len(win_map) - 1
                both = (win_map[np.clip(eu_all, 0, hi)] >= 0) & \
                       (win_map[np.clip(ev_all, 0, hi)] >= 0) & \
                       self._edge_valid[: self.n_edges]
                snap_idx = np.nonzero(both)[0]
                lc_snap = (snap_idx, self._edge_pose[snap_idx].copy(),
                           self.lm_pos[lms].copy())

        info = NewKFInfo(
            kf_id=root,
            created_edges=created_edges,
            cost_init=float("nan"),
            cost_final=float("nan"),
            obs_rmse=float("nan"),
            n_window_kfs=len(win_kfs),
            n_window_obs=n_o,
            pending=True,
            truncated_obs=n_dropped,
        )
        entry = dict(
            root=root,
            C=C, L=L, O=O,
            win_arr=win_arr,
            win_map=win_map,
            lms=lms,
            info=info,
            old_root_global=self.kf_global[root].copy(),
            lc_checks=lc_checks,
            lc_snap=lc_snap,
            lm_base_loc=lm_base_loc.copy() if lc_checks else None,
            window=(cam_pose, cam_valid, lm_pos, lm_base_loc, lm_valid, oc, ol, opx, ov),
        )
        if self.mesh is not None:
            # the mesh branch launches the sharded solve now, a group of one
            self._met.setdefault((C, L, O), entry["window"])
            self._pending.append(dict(blob=self._solve_window(entry)[None], entries=[entry]))
            return info
        ints, floats = pack_window(*entry["window"])
        self._met.setdefault((C, L, O), (ints, floats))
        self._queued.append(dict(ints=ints, floats=floats, entry=entry))
        # eager half-group launch: the device solves while the host walks on
        if len(self._queued) >= WINDOW_SLOTS // 2:
            self._dispatch_queued()
        return info

    def _solve_kw(self) -> dict:
        p = self.p
        return dict(kernel_param=p.kernel_param, max_iters=p.opt_iters,
                    use_kernel=p.use_robust_kernel, w_prior_rot=p.anchor_prior_w_rot,
                    w_prior_trans=p.anchor_prior_w_trans, stage1_iters=p.stage1_iters,
                    use_kernel_stage1=p.use_robust_kernel_stage1)

    def _solve_window(self, entry: dict) -> torch.Tensor:
        """One queued window solved alone on the device: its result row
        (``window_ba.result_blob``), not read. Sharded over the mesh when
        the engine has one: laid out from the host arrays, one pinned upload
        a shard, then solved by the sharded programs (no kernel after them)."""
        _pose, _cv, _lp, lm_base_loc, _lv, oc, ol, _px, ov = entry["window"]
        if self.mesh is not None:
            win = shard_window_obs(BAWindow(*entry["window"]), self.mesh)
            return optimize_window_blob(win, self.cam, **self._solve_kw())
        dev = self.device
        win = BAWindow(*(torch.as_tensor(a, device=dev) for a in entry["window"]))
        plan = assembly_plan(oc, ol, lm_base_loc, ov, entry["C"], entry["L"], dev)
        return optimize_window_blob(win, self.cam, plan=plan, **self._solve_kw())

    def _solve(self, entry: dict) -> np.ndarray:
        """One queued window solved alone, its host blob ``[cam_pose (C*6)
        | lm_pos (L*3) | cost_init cost_final rmse rmse_stg1]`` (one copy
        back). The groups' solves give each window these bits."""
        return trace.to_numpy("srba.solve", self._solve_window(entry))

    def _dispatch_queued(self):
        """Launch every queued window, grouped by (C, L, O) bucket in
        queue order into groups of up to WINDOW_SLOTS, one
        ``solve_window_group`` a group (one upload; a padded slot holds a
        copy of the group's first window and launches nothing; on a card
        one program replay). No host read."""
        with trace.span("window dispatch"):
            q, self._queued = self._queued, []
            i = 0
            while i < len(q):
                key = _bucket(q[i])
                grp = [q[i]]
                i += 1
                while i < len(q) and len(grp) < WINDOW_SLOTS and _bucket(q[i]) == key:
                    grp.append(q[i])
                    i += 1
                blob = self._solve_group([(x["ints"], x["floats"]) for x in grp], key)
                self._pending.append(dict(blob=blob, entries=[x["entry"] for x in grp]))

    def _solve_group(self, windows: list, key: tuple, capture_only: bool = False):
        """``solve_window_group`` of the packed ``windows`` of bucket
        ``key`` at the front of a group of WINDOW_SLOTS (the host's part of
        laying the group out, the slots stacked, is the ``window plan``
        span; the gather tables are built on the device)."""
        pad = WINDOW_SLOTS - len(windows)
        with trace.span("window plan"):
            ints, floats = (np.stack([w[j] for w in windows] + [windows[0][j]] * pad)
                            for j in (0, 1))
        return solve_window_group(ints, floats, [True] * len(windows) + [False] * pad, *key,
                                  self.cam, self.device, capture_only=capture_only,
                                  solve=optimize_window, **self._solve_kw())

    def capture_window_programs(self) -> list[tuple]:
        """On a card, capture now the group programs that the engine's
        schedule launches (``window_ba.solve_window_group``): for each
        bucket met so far and each group size from 1 to WINDOW_SLOTS // 2
        (the half group at which the engine launches), on copies of the
        bucket's first window, the outputs dropped and the engine
        untouched. The bench harness calls it after its warm-up, so that no
        timed part captures a window program. With a mesh, the sharded
        window's programs (``window_ba.shard_key``) of each bucket met: one
        solve of its first window, its row dropped. Returns the (bucket,
        size) of the programs captured now (size 1 with a mesh)."""
        if self.device.type != "cuda":
            return []
        made = []
        if self.mesh is not None:
            for key, window in sorted(self._met.items()):
                before = cuda_graphs.capture_stats("window_shard")["captures"]
                self._solve_window(dict(window=window, C=key[0], L=key[1]))
                if cuda_graphs.capture_stats("window_shard")["captures"] > before:
                    made.append((key, 1))
            return made
        for key, window in sorted(self._met.items()):
            for n in range(1, WINDOW_SLOTS // 2 + 1):
                if self._solve_group([window] * n, key, capture_only=True):
                    made.append((key, n))
        return made

    def pending_device_arrays(self) -> tuple:
        """The result blobs of every launched group, oldest first, for the
        owner's next read (empty when nothing is in flight). Launches the
        queued windows first."""
        self._dispatch_queued()
        return tuple(p["blob"] for p in self._pending)

    def commit_pending(self, host_vals=None):
        """Write back every launched window solve in launch order: each
        through ``_commit_one``, then one spanning-tree recompute, then
        ``on_commit`` per solve. ``host_vals`` are the host copies of
        ``pending_device_arrays()`` from the owner's read; without them
        this reads the blobs itself (one copy)."""
        self._dispatch_queued()
        groups, self._pending = self._pending, []
        if not groups:
            return
        if host_vals is None:
            host_vals = to_host([g["blob"] for g in groups])
        assert len(host_vals) == len(groups)
        committed = []
        for grp, rows in zip(groups, host_vals):
            for r, entry in enumerate(grp["entries"]):
                self._commit_one(entry, np.asarray(rows[r]))
                committed.append(entry)
        # edges are the source of truth; only the final state is read
        for k, (_h, rel) in self.spanning_tree(0, allow_stale=True).items():
            self.kf_global[k] = rel
        if self.on_commit is not None:
            for entry in committed:
                self.on_commit(entry["root"], entry["old_root_global"],
                               self.kf_global[entry["root"]].copy())

    def flush(self):
        """Land every queued and launched window solve. Loops, because a
        loop-closure rollback queues its window again."""
        while self._pending or self._queued:
            self.commit_pending()

    def _commit_one(self, p: dict, blob: np.ndarray):
        """Write one window solve back into the edges and landmarks (the
        spanning tree and ``on_commit`` follow once per burst, in ``flush``)."""
        C, L = p["C"], p["L"]
        cam_opt_f = blob[: C * 6].reshape(C, 6)
        lm_opt_f = blob[C * 6: C * 6 + L * 3].reshape(L, 3)
        cost_init, cost_final, rmse, rmse_stg1 = blob[C * 6 + L * 3:]
        cam_opt = np.asarray(cam_opt_f, np.float64)
        win_map = p["win_map"]
        # keyframes inserted AFTER this solve dispatched are outside its
        # window: pad the dispatch-time map so their edges are ignored
        if len(win_map) < self.n_kfs:
            win_map = np.concatenate([
                win_map,
                np.full(self.n_kfs - len(win_map), -1, win_map.dtype),
            ])
        # Edges are the source of truth (the SRBA state): update every edge
        # whose endpoints are both in the window from the optimized
        # window-relative poses, then DERIVE all global poses by composing the
        # spanning tree from KF0 — the anchor can never move (the window's
        # internal gauge, root frozen, is irrelevant to the extracted relative
        # information).
        eu = self._edge_u[: self.n_edges]
        ev = self._edge_v[: self.n_edges]
        wu = win_map[eu]
        wv = win_map[ev]
        m = (wu >= 0) & (wv >= 0) & self._edge_valid[: self.n_edges]
        if m.any():
            self._edge_pose[np.nonzero(m)[0]] = se3_np.relative_batch(
                cam_opt[wv[m]], cam_opt[wu[m]])
        lms = p["lms"]
        self.lm_pos[lms] = np.asarray(lm_opt_f, np.float64)[: len(lms)]
        if p.get("lc_checks"):
            self._validate_committed_lc(p, cam_opt,
                                        np.asarray(lm_opt_f, np.float64))
        info = p["info"]
        info.cost_init = float(cost_init)
        info.cost_final = float(cost_final)
        info.obs_rmse = float(rmse)
        info.obs_rmse_stg1 = float(rmse_stg1)
        info.pending = False

    def _remove_edge(self, e: int):
        """Invalidate edge ``e`` (loop-closure rollback). The slot stays
        allocated (rare event, and pending window entries reference edge
        ids); adjacency and all exports drop it immediately."""
        if not self._edge_valid[e]:
            return
        self._edge_valid[e] = False
        u, v = int(self._edge_u[e]), int(self._edge_v[e])
        self.adj[u] = [t for t in self.adj.get(u, []) if t[1] != e]
        self.adj[v] = [t for t in self.adj.get(v, []) if t[1] != e]

    def _validate_committed_lc(self, entry: dict, cam_opt: np.ndarray,
                               lm_opt: np.ndarray):
        """Layer-B check on the COMMITTED window solve (see SRBAParams):
        each fresh loop-closure edge must (a) stay inside the layer-A
        odometry-disagreement budget after optimization, (b) leave the
        new KF's far-area observations reprojecting within ``lc_chi2_px``,
        and (c) not DRAG the far area's own landmarks: the median base-frame
        displacement of the checked landmarks must stay inside the same
        drift budget. (c) closes the absorption hole in (a)+(b): a
        per-landmark-consistent wrong consensus moves the LANDMARKS to fit
        the new observations (the robust kernel downweights the far area's
        own history), leaving pose and residuals clean while the area's map
        silently folds. Failures roll the solve back. Runs on the
        window-local result (the window is rooted at the new KF, so the
        root sits at identity)."""
        failed = []
        snap_lm = entry["lc_snap"][2]
        for chk in entry["lc_checks"]:
            if not self._edge_valid[chk["e"]]:
                continue
            t_u_root = se3_np.inverse(cam_opt[chk["u_loc"]])
            d = float(np.linalg.norm(t_u_root[3:]
                                     - np.asarray(chk["alt"])[3:]))
            chi = 0.0
            drag = 0.0
            ll = chk["chi_ll"]
            if len(ll):
                wb = entry["lm_base_loc"][ll]
                pts = se3_np.transform_points_by_pose(cam_opt[wb], lm_opt[ll])
                c = self.cam
                z = np.maximum(pts[:, 2], 1e-6)
                ul = c.cx_l + c.fx_l * pts[:, 0] / z
                vl = c.cy_l + c.fy_l * pts[:, 1] / z
                ur = c.cx_r + c.fx_r * (pts[:, 0] - c.baseline) / z
                r = np.stack([ul, vl, ur], -1) - chk["chi_px"]
                chi = float(np.sqrt(np.mean(r ** 2)))
                # (c): base-frame motion of the checked far landmarks
                # (lm_pos and lm_opt are both in each landmark's BASE frame,
                # so honest closures — which only re-pose CAMERAS — barely
                # move them)
                drag = float(np.median(np.linalg.norm(
                    lm_opt[ll] - snap_lm[ll], axis=1)))
            if d > chk["budget"] or chi > self.p.lc_chi2_px \
                    or drag > chk["budget"]:
                failed.append((chk, dict(
                    disagreement_m=d, budget_m=chk["budget"],
                    path_len_m=chk["plen"], chi_px=chi, lm_drag_m=drag)))
        if failed:
            self._rollback_lc(entry, failed)

    def _rollback_lc(self, entry: dict, failed: list):
        """Undo a committed window solve whose loop-closure edge failed
        layer-B validation: restore the pre-solve edge poses + landmark
        positions, remove the offending edge(s), re-base the
        mis-associated observations, blacklist the area pair, and re-solve
        the window without the edge."""
        root = entry["root"]
        snap_idx, snap_pose, snap_lm = entry["lc_snap"]
        keep = self._edge_valid[snap_idx]
        self._edge_pose[snap_idx[keep]] = snap_pose[keep]
        self.lm_pos[entry["lms"]] = snap_lm
        centers = set()
        for chk, info in failed:
            self._remove_edge(chk["e"])
            centers.add(self._area_of(chk["u"]))
            self._reject_lc_edge(chk["u"], root, "solve", info)
        if not self.adj.get(root):
            fb = self._area_of(root - 1)
            self._add_edge(
                fb, root,
                se3_np.relative(self.kf_global[root], self.kf_global[fb]),
                kind=1)
        moved = self._rebase_far_obs(root, centers)
        if moved:
            self.log(1, f"kf{root}: re-based {moved} observations after "
                        f"post-solve loop-closure rollback")
        # re-solve the (restored) window without the rejected edge; the
        # result lands at the next flush()
        self._dispatch_window_opt(root, [])

    # -------------------------------------------------------------- exports
    def get_global_graphslam_problem(self):
        """kf2kf constraint list for the final pose-graph solve
        (≙ get_global_graphslam_problem, reference .cpp:946-947)."""
        self.flush()
        m = self._edge_valid[: self.n_edges]
        return (
            self._edge_u[: self.n_edges][m].copy(),
            self._edge_v[: self.n_edges][m].copy(),
            self._edge_pose[: self.n_edges][m].copy(),
        )

    def save_graph_as_dot(self, path: str):
        """≙ save_graph_as_dot (reference .cpp:801, 1094-1095): annotated
        like the reference's SRBA exports — nodes carry their current
        global pose estimate (submap-center nodes doubled), edges carry
        their relative pose seed and type (solid = submap/base edges,
        bold red = loop-closure edges)."""
        kinds = {0: "submap", 1: "base", 2: "lc"}
        with open(path, "w") as f:
            f.write("graph srba {\n")
            f.write("  node [shape=circle fontsize=9];\n")
            for k in range(self.n_kfs):
                p = self.kf_global[k]
                shape = ("doublecircle"
                         if int(self.localmap_center[k]) == k else "circle")
                f.write(
                    f'  {k} [shape={shape} label="{k}" '
                    f'pose="{p[3]:.3f} {p[4]:.3f} {p[5]:.3f}"];\n')
            for e in range(self.n_edges):
                if not self._edge_valid[e]:
                    continue
                kind = kinds.get(int(self._edge_kind[e]), "submap")
                rel = self._edge_pose[e]
                style = (' color=red penwidth=2' if kind == "lc" else "")
                f.write(
                    f"  {self._edge_u[e]} -- {self._edge_v[e]} "
                    f'[kind="{kind}"{style} '
                    f'rel="{rel[3]:.3f} {rel[4]:.3f} {rel[5]:.3f}"];\n')
            f.write("}\n")

    # ------------------------------------------------------------ accessors
    @property
    def edge_u(self) -> np.ndarray:
        return self._edge_u[: self.n_edges]

    @property
    def edge_v(self) -> np.ndarray:
        return self._edge_v[: self.n_edges]

    @property
    def edge_pose(self) -> np.ndarray:
        return self._edge_pose[: self.n_edges]

    @property
    def edge_valid(self) -> np.ndarray:
        """False where a loop-closure rollback removed the edge (the raw
        edge arrays above keep their slots; filter with this mask)."""
        return self._edge_valid[: self.n_edges]

def _obs_as_arrays(observations):
    """Normalize either obs format to (lm_ids [N], px [N,3], rel_pos [N,3])."""
    if isinstance(observations, tuple) and len(observations) == 3 \
            and isinstance(observations[0], np.ndarray):
        lm_ids, px, rel = observations
        return (np.asarray(lm_ids, np.int64), np.asarray(px, np.float64),
                np.asarray(rel, np.float64))
    rows = list(observations)
    n = len(rows)
    lm_ids = np.zeros(n, np.int64)
    px = np.zeros((n, 3), np.float64)
    rel = np.full((n, 3), np.nan)
    for i, (lm_id, ul, vl, ur, rel_pos) in enumerate(rows):
        lm_ids[i] = lm_id
        px[i] = (ul, vl, ur)
        if rel_pos is not None:
            rel[i] = rel_pos
    return lm_ids, px, rel


def _bucket(q: dict) -> tuple[int, int, int]:
    """The (C, L, O) bucket of a queued window."""
    e = q["entry"]
    return e["C"], e["L"], e["O"]
