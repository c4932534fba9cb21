"""Configuration system reading the reference's ``.ini`` schema.

Host-side replacement for MRPT ``CConfigFile`` plus the two option structs
``TGeneralOptions`` (reference src/srba-stereo-slam_utils.h:87-216) and
``TSRBAStereoSLAMOptions`` (src/srba-stereo-slam_utils.h:221-487). Section and
key names are kept identical so the reference demo configs
(demo/config_imgdir_kitti_srba.ini, demo/config_img_dir_example.ini) load
unmodified. Every option keeps the reference's default.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any

from srba_slam_tpu_torch.utils.camera import StereoCamera


# ---------------------------------------------------------------------------
# .ini parsing (MRPT-style: `;` full-line and `//` inline comments, [sections],
# vector values like `[1226 370]`)
# ---------------------------------------------------------------------------

class IniFile:
    def __init__(self, path_or_text: str, *, is_text: bool = False):
        text = path_or_text if is_text else open(path_or_text, "r", encoding="utf-8", errors="replace").read()
        self.sections: dict[str, dict[str, str]] = {}
        current: dict[str, str] | None = None
        for raw in text.splitlines():
            line = raw.strip()
            if not line or line.startswith(";") or line.startswith("#"):
                continue
            # strip inline comments (`//` and `;` outside of values we care about)
            line = re.split(r"\s//", line)[0].strip()
            if line.startswith("[") and line.endswith("]") and "=" not in line:
                name = line[1:-1].strip()
                current = self.sections.setdefault(name, {})
                continue
            if "=" in line and current is not None:
                key, _, val = line.partition("=")
                current[key.strip()] = val.strip()

    def get(self, section: str, key: str, default: Any = None) -> Any:
        return self.sections.get(section, {}).get(key, default)

    def read_bool(self, section: str, key: str, default: bool) -> bool:
        v = self.get(section, key)
        if v is None:
            return default
        return str(v).strip().lower() in ("1", "true", "yes", "on")

    def read_int(self, section: str, key: str, default: int) -> int:
        v = self.get(section, key)
        return default if v is None else int(float(str(v).split()[0]))

    def read_float(self, section: str, key: str, default: float) -> float:
        v = self.get(section, key)
        return default if v is None else float(str(v).split()[0])

    def read_string(self, section: str, key: str, default: str) -> str:
        v = self.get(section, key)
        return default if v is None else str(v)

    def read_vector(self, section: str, key: str, default: list[float]) -> list[float]:
        v = self.get(section, key)
        if v is None:
            return list(default)
        body = str(v).strip()
        if body.startswith("["):
            body = body[1:]
        if body.endswith("]"):
            body = body[:-1]
        parts = [p for p in re.split(r"[,\s]+", body.strip()) if p]
        return [float(p) for p in parts]


# ---------------------------------------------------------------------------
# Option structs (defaults match the reference)
# ---------------------------------------------------------------------------

@dataclass
class GeneralOptions:
    """≙ TGeneralOptions (reference utils.h:87-216). Sections APP_OPTIONS / IMG_SOURCE."""

    # APP_OPTIONS
    out_dir: str = "out"
    debug: bool = False
    show3D: bool = False
    enable_logger: bool = False
    verbose_level: int = 0
    pause_at_each_iteration: bool = False
    pause_after_show_op: bool = False
    max_num_kfs: int = 0            # 0 = unlimited
    from_step: int = 0
    to_step: int = 0                # 0 = unlimited
    save_state_to_file: bool = False
    save_at_iteration: int = 0      # 0 = save at end of run; N = stop+save
    load_state_from_file: bool = False
    state_file: str = ""
    # IMG_SOURCE
    cap_src: str = "image_dir"      # grabber_type
    image_dir_url: str = ""
    left_format: str = ""
    right_format: str = ""
    start_index: int = 0
    end_index: int = 0              # 0 = unlimited
    rawlog_file: str = ""

    @staticmethod
    def from_config(cfg: IniFile) -> "GeneralOptions":
        o = GeneralOptions()
        s = "APP_OPTIONS"
        o.out_dir = cfg.read_string(s, "out_dir", o.out_dir)
        o.debug = cfg.read_bool(s, "debug", o.debug)
        o.show3D = cfg.read_bool(s, "show3D", o.show3D)
        o.enable_logger = cfg.read_bool(s, "enable_logger", o.enable_logger)
        o.verbose_level = cfg.read_int(s, "verbose_level", o.verbose_level)
        o.pause_at_each_iteration = cfg.read_bool(s, "pause_at_each_iteration", o.pause_at_each_iteration)
        o.pause_after_show_op = cfg.read_bool(s, "pause_after_show_op", o.pause_after_show_op)
        o.max_num_kfs = cfg.read_int(s, "max_num_kfs", o.max_num_kfs)
        o.from_step = cfg.read_int(s, "from_step", o.from_step)
        o.to_step = cfg.read_int(s, "to_step", o.to_step)
        # mutual-exclusion rule ≙ reference utils.h:157-165: saving wins —
        # load_state_from_file is only honored when save_state_to_file is off
        o.save_state_to_file = cfg.read_bool(s, "save_state_to_file", o.save_state_to_file)
        if o.save_state_to_file:
            o.load_state_from_file = False
        else:
            o.load_state_from_file = cfg.read_bool(s, "load_state_from_file", o.load_state_from_file)
        o.save_at_iteration = cfg.read_int(
            s, "save_at_iteration", o.save_at_iteration)
        o.state_file = cfg.read_string(s, "state_file", o.state_file)
        # capture_source (≙ utils.h:167-172: int 0=rawlog 1=image_dir) sets
        # the default grabber; IMG_SOURCE/grabber_type overrides when present
        aux = cfg.read_int(s, "capture_source",
                           0 if o.cap_src == "rawlog" else 1)
        o.cap_src = "rawlog" if aux == 0 else "image_dir"
        s = "IMG_SOURCE"
        o.cap_src = cfg.read_string(s, "grabber_type", o.cap_src)
        o.image_dir_url = cfg.read_string(s, "image_dir_url", o.image_dir_url)
        o.left_format = cfg.read_string(s, "left_format", o.left_format).replace("\\%", "%")
        o.right_format = cfg.read_string(s, "right_format", o.right_format).replace("\\%", "%")
        o.start_index = cfg.read_int(s, "start_index", o.start_index)
        o.end_index = cfg.read_int(s, "end_index", o.end_index)
        o.rawlog_file = cfg.read_string(s, "rawlog_file", o.rawlog_file)
        return o


@dataclass
class SRBAStereoSLAMOptions:
    """≙ TSRBAStereoSLAMOptions (reference utils.h:221-487).

    Sections SRBA_GENERAL / SRBA_DETECT / SRBA_DATA_ASSOCIATION /
    SRBA_KF_CREATION / CAMERA_LEFT / CAMERA_RIGHT / CAMERA_LEFT2RIGHT_POSE,
    defaults per utils.h:286-320.
    """

    # SRBA_GENERAL
    voc_filename: str = ""
    srba_max_tree_depth: int = 3
    srba_max_optimize_depth: int = 3
    srba_submap_size: int = 15
    srba_use_robust_kernel: bool = True
    srba_use_robust_kernel_stage1: bool = True
    srba_kernel_param: float = 3.0
    # SRBA_GENERAL also carries its own pause_after_show_op (the reference
    # pauses after dumping the SRBA options, utils.h:369/:482)
    pause_after_show_op: bool = False
    # SRBA_DETECT
    n_feats: int = 500
    n_levels: int = 1
    detect_method: int = 0          # ORB
    detect_fast_th: int = 5
    orb_adaptive_fast_th: bool = False
    adaptive_th_min_matches: int = 100
    min_pts_distance: int = 5       # NMS radius
    # SRBA_DATA_ASSOCIATION
    da_stage2_method: int = 2       # 0 none / 1 fund matrix / 2 change pose / 3 both
    max_orb_distance_da: float = 60.0
    max_y_diff_epipolar: float = 1.5
    ransac_fit_prob: float = 0.95
    residual_th: float = 50.0
    query_score_th: float = 0.04    # "lost camera?" warning floor (utils.h:256)
    da_filter_by_direction: bool = True
    # the other three DA-cascade gates (≙ reference utils.h:398-401 and
    # their `if(srba_options.da_filter_by_*)` uses at .cpp:1500/:1589/:1617;
    # defaults per utils.h:303-305). NOTE: in the reference these BOOLEANS
    # gate the cascade stages — da_stage2_method only decides whether the
    # change-in-pose solves get a pose-prior seed (.cpp:1372-1380)
    da_filter_by_orb_distance: bool = True
    da_filter_by_fund_matrix: bool = True
    da_filter_by_pose_change: bool = True
    # stereo matching (VO MATCH section mirrors)
    max_y_diff: float = 2.0
    orb_max_distance: int = 60
    # SRBA_KF_CREATION
    max_rotation: float = 15.0      # degrees
    max_translation: float = 0.3    # meters
    updated_matches_th: int = 50
    up_matches_th_plus: int = 25
    lc_distance: int = 2
    vo_id_tracking_th: int = 40
    use_initial_pose: bool = True
    # SRBA engine parameters mapped in at init (reference .cpp:1149-1160)
    min_obs_to_loop_closure: int = 50
    std_noise_pixels: float = 0.5
    # framework extension (documented deviation from the reference SRBA
    # objective): window-BA init-anchor prior weights; 0 disables — see
    # ops/window_ba.py
    anchor_prior_w_rot: float = 1000.0
    anchor_prior_w_trans: float = 100.0
    # framework extension: with no voc_filename, the fallback vocabulary is
    # trained from the descriptors of the first N processed frames (the
    # reference requires a prebuilt voc.yml.gz; training happens lazily at
    # the first keyframe check so it never blocks the pipeline start)
    voc_train_frames: int = 8
    # framework extension: loop-closure edge validation against the
    # accumulated-odometry drift budget (floor + frac * path length) plus a
    # post-solve reprojection check with rollback — the global defense
    # against perceptual aliasing the reference lacks (its only LC gate is
    # tracked > 0.5*best, reference .cpp:482-521). See SRBAParams.lc_validate
    lc_validate: bool = True
    lc_reject_drift_frac: float = 0.05
    lc_reject_floor_m: float = 0.35
    lc_chi2_px: float = 3.0
    # camera
    camera: StereoCamera = field(default_factory=StereoCamera.kitti)
    camera_pose_on_robot: list[float] = field(default_factory=lambda: [0.0] * 6)
    # radial-tangential distortion [k1 k2 p1 p2 k3] per eye (MRPT TCamera
    # ``dist`` rows of the CAMERA_LEFT/CAMERA_RIGHT sections); consumed by
    # the RECTIFY stage when rectified_images=false
    camera_dist_l: list[float] = field(default_factory=lambda: [0.0] * 5)
    camera_dist_r: list[float] = field(default_factory=lambda: [0.0] * 5)

    @staticmethod
    def from_config(cfg: IniFile) -> "SRBAStereoSLAMOptions":
        o = SRBAStereoSLAMOptions()
        s = "SRBA_GENERAL"
        o.voc_filename = cfg.read_string(s, "voc_filename", o.voc_filename)
        o.voc_train_frames = cfg.read_int(s, "voc_train_frames", o.voc_train_frames)
        o.srba_max_tree_depth = cfg.read_int(s, "srba_max_tree_depth", o.srba_max_tree_depth)
        o.srba_max_optimize_depth = cfg.read_int(s, "srba_max_optimize_depth", o.srba_max_optimize_depth)
        o.srba_submap_size = cfg.read_int(s, "srba_submap_size", o.srba_submap_size)
        o.srba_use_robust_kernel = cfg.read_bool(s, "srba_use_robust_kernel", o.srba_use_robust_kernel)
        o.srba_use_robust_kernel_stage1 = cfg.read_bool(s, "srba_use_robust_kernel_stage1", o.srba_use_robust_kernel_stage1)
        o.srba_kernel_param = cfg.read_float(s, "srba_kernel_param", o.srba_kernel_param)
        o.pause_after_show_op = cfg.read_bool(
            s, "pause_after_show_op", o.pause_after_show_op)
        o.anchor_prior_w_rot = cfg.read_float(s, "anchor_prior_w_rot", o.anchor_prior_w_rot)
        o.anchor_prior_w_trans = cfg.read_float(s, "anchor_prior_w_trans", o.anchor_prior_w_trans)
        o.lc_validate = cfg.read_bool(s, "lc_validate", o.lc_validate)
        o.lc_reject_drift_frac = cfg.read_float(
            s, "lc_reject_drift_frac", o.lc_reject_drift_frac)
        o.lc_reject_floor_m = cfg.read_float(
            s, "lc_reject_floor_m", o.lc_reject_floor_m)
        o.lc_chi2_px = cfg.read_float(s, "lc_chi2_px", o.lc_chi2_px)
        s = "SRBA_DETECT"
        o.n_feats = cfg.read_int(s, "n_feats", o.n_feats)
        o.detect_fast_th = cfg.read_int(s, "detect_fast_th", o.detect_fast_th)
        o.orb_adaptive_fast_th = cfg.read_bool(s, "orb_adaptive_fast_th", o.orb_adaptive_fast_th)
        o.adaptive_th_min_matches = cfg.read_int(s, "adaptive_th_min_matches", o.adaptive_th_min_matches)
        s = "SRBA_DATA_ASSOCIATION"
        o.da_stage2_method = cfg.read_int(s, "da_stage2_method", o.da_stage2_method)
        o.max_orb_distance_da = cfg.read_float(s, "max_orb_distance_da", o.max_orb_distance_da)
        o.max_y_diff_epipolar = cfg.read_float(s, "max_y_diff_epipolar", o.max_y_diff_epipolar)
        o.ransac_fit_prob = cfg.read_float(s, "ransac_fit_prob", o.ransac_fit_prob)
        o.residual_th = cfg.read_float(s, "residual_th", o.residual_th)
        o.query_score_th = cfg.read_float(s, "query_score_th", o.query_score_th)
        o.da_filter_by_direction = cfg.read_bool(s, "da_filter_by_direction", o.da_filter_by_direction)
        o.da_filter_by_orb_distance = cfg.read_bool(
            s, "da_filter_by_orb_distance", o.da_filter_by_orb_distance)
        o.da_filter_by_fund_matrix = cfg.read_bool(
            s, "da_filter_by_fund_matrix", o.da_filter_by_fund_matrix)
        o.da_filter_by_pose_change = cfg.read_bool(
            s, "da_filter_by_pose_change", o.da_filter_by_pose_change)
        s = "SRBA_KF_CREATION"
        o.max_rotation = cfg.read_float(s, "max_rotation", o.max_rotation)
        o.max_translation = cfg.read_float(s, "max_translation", o.max_translation)
        o.updated_matches_th = cfg.read_int(s, "updated_matches_th", o.updated_matches_th)
        o.up_matches_th_plus = cfg.read_int(s, "up_matches_th_plus", o.up_matches_th_plus)
        o.lc_distance = cfg.read_int(s, "lc_distance", o.lc_distance)
        o.vo_id_tracking_th = cfg.read_int(s, "vo_id_tracking_th", o.vo_id_tracking_th)
        o.use_initial_pose = cfg.read_bool(s, "use_initial_pose", o.use_initial_pose)
        # VO MATCH section (stereo gating) — passed through to the VO engine
        s = "MATCH"
        o.max_y_diff = cfg.read_float(s, "max_y_diff", o.max_y_diff)
        o.orb_max_distance = cfg.read_int(s, "orb_max_distance", o.orb_max_distance)
        s = "DETECT"
        o.min_pts_distance = cfg.read_int(s, "min_distance", o.min_pts_distance)
        # camera
        o.camera = _camera_from_config(cfg)
        o.camera_pose_on_robot = cfg.read_vector("GENERAL", "camera_pose_on_robot", o.camera_pose_on_robot)
        o.camera_dist_l = cfg.read_vector("CAMERA_LEFT", "dist", o.camera_dist_l)
        o.camera_dist_r = cfg.read_vector("CAMERA_RIGHT", "dist", o.camera_dist_r)
        return o


def _camera_from_config(cfg: IniFile) -> StereoCamera:
    res = cfg.read_vector("CAMERA_LEFT", "resolution", [0, 0])
    l2r = cfg.read_vector("CAMERA_LEFT2RIGHT_POSE", "pose_quaternion", [0.0] * 7)
    return StereoCamera(
        fx_l=cfg.read_float("CAMERA_LEFT", "fx", 1.0),
        fy_l=cfg.read_float("CAMERA_LEFT", "fy", 1.0),
        cx_l=cfg.read_float("CAMERA_LEFT", "cx", 0.0),
        cy_l=cfg.read_float("CAMERA_LEFT", "cy", 0.0),
        fx_r=cfg.read_float("CAMERA_RIGHT", "fx", 1.0),
        fy_r=cfg.read_float("CAMERA_RIGHT", "fy", 1.0),
        cx_r=cfg.read_float("CAMERA_RIGHT", "cx", 0.0),
        cy_r=cfg.read_float("CAMERA_RIGHT", "cy", 0.0),
        baseline=l2r[0] if l2r else 0.0,
        width=int(res[0]),
        height=int(res[1]),
    )


@dataclass
class VOOptions:
    """Visual-odometry engine options (≙ stereo-vo config sections
    RECTIFY/DETECT/MATCH/IF-MATCH/LEAST_SQUARES passed through at
    reference .cpp:1122-1142, with the same forced modes: ORB detection,
    row-by-row descriptor stereo matching, brute-force inter-frame matching).
    """

    n_octaves: int = 1
    min_distance: int = 5
    non_maximal_suppression: bool = True
    fast_th: int = 20
    n_feats: int = 500
    # upright descriptors are more stable for stereo/tracking; oriented ones
    # add in-plane rotation invariance for place recognition
    orb_oriented: bool = False
    # MATCH
    max_y_diff: float = 2.0
    orb_max_distance: int = 60
    enable_robust_1to1_match: bool = False
    rectified_images: bool = True
    # IF-MATCH
    filter_fund_matrix: bool = False
    window_width: int = 16
    window_height: int = 16
    # LEAST_SQUARES
    initial_max_iters: int = 30
    max_iters: int = 30
    max_incr_cost: int = 3
    residual_threshold: float = 15.0
    min_mod_out_vector: float = 1e-3
    bad_tracking_th: int = 5
    use_robust_kernel: bool = True
    kernel_param: float = 3.0
    use_previous_pose_as_initial: bool = True
    vo_use_matches_ids: bool = True

    @staticmethod
    def from_config(cfg: IniFile) -> "VOOptions":
        o = VOOptions()
        o.n_octaves = cfg.read_int("RECTIFY", "nOctaves", o.n_octaves)
        o.min_distance = cfg.read_int("DETECT", "min_distance", o.min_distance)
        o.non_maximal_suppression = cfg.read_bool("DETECT", "non_maximal_suppression", o.non_maximal_suppression)
        o.max_y_diff = cfg.read_float("MATCH", "max_y_diff", o.max_y_diff)
        o.orb_max_distance = cfg.read_int("MATCH", "orb_max_distance", o.orb_max_distance)
        o.enable_robust_1to1_match = cfg.read_bool("MATCH", "enable_robust_1to1_match", o.enable_robust_1to1_match)
        o.rectified_images = cfg.read_bool("MATCH", "rectified_images", o.rectified_images)
        o.filter_fund_matrix = cfg.read_bool("IF-MATCH", "filter_fund_matrix", o.filter_fund_matrix)
        o.window_width = cfg.read_int("IF-MATCH", "window_width", o.window_width)
        o.window_height = cfg.read_int("IF-MATCH", "window_height", o.window_height)
        s = "LEAST_SQUARES"
        o.initial_max_iters = cfg.read_int(s, "initial_max_iters", o.initial_max_iters)
        o.max_iters = cfg.read_int(s, "max_iters", o.max_iters)
        o.max_incr_cost = cfg.read_int(s, "max_incr_cost", o.max_incr_cost)
        o.residual_threshold = cfg.read_float(s, "residual_threshold", o.residual_threshold)
        o.min_mod_out_vector = cfg.read_float(s, "min_mod_out_vector", o.min_mod_out_vector)
        o.bad_tracking_th = cfg.read_int(s, "bad_tracking_th", o.bad_tracking_th)
        o.use_robust_kernel = cfg.read_bool(s, "use_robust_kernel", o.use_robust_kernel)
        o.kernel_param = cfg.read_float(s, "kernel_param", o.kernel_param)
        o.use_previous_pose_as_initial = cfg.read_bool(s, "use_previous_pose_as_initial", o.use_previous_pose_as_initial)
        o.vo_use_matches_ids = cfg.read_bool("GENERAL", "vo_use_matches_ids", o.vo_use_matches_ids)
        # SRBA_DETECT overrides (reference .cpp:1140-1142)
        o.fast_th = cfg.read_int("SRBA_DETECT", "detect_fast_th", o.fast_th)
        o.n_feats = cfg.read_int("SRBA_DETECT", "n_feats", o.n_feats)
        return o


def load_config(path: str):
    """Load (GeneralOptions, SRBAStereoSLAMOptions, VOOptions) from one .ini."""
    cfg = IniFile(path)
    return GeneralOptions.from_config(cfg), SRBAStereoSLAMOptions.from_config(cfg), VOOptions.from_config(cfg)


def dump_options(*opts) -> str:
    """Console dump of option structs (≙ reference dumpToConsole, utils.h:184-214,424-483)."""
    lines = []
    for o in opts:
        lines.append(f"[{type(o).__name__}]")
        for f in dataclasses.fields(o):
            lines.append(f"  {f.name} = {getattr(o, f.name)}")
    return "\n".join(lines)
