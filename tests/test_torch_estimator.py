"""Port parity of the whole per-frame path: ``SRBAStereoSLAMEstimator.step()``
of the port (on the CPU) against the JAX package's ``step()``, both with
``solve_sync = True`` (every window solve lands right after its insertion).

Two sequences:

* the small-geometry sequence of ``tests/test_estimator.py`` (320x200, 30
  frames, step 0.12, the same options);
* a loop-closure circuit (``tests/test_long_trajectory.py``'s 256x144
  ground-plane world, 2.25 laps in 220 frames), where aliased closures are
  rejected at edge creation (layer A) and after the solve (layer B), and
  ``_lc_recovery`` fires twice, once re-creating the edge and once not.

Tolerance: the step log's decisions, the keyframe match ids, the BoW query
ids, the per-insertion feature counts, the graph's edges and the loop-
closure blacklist are identical; keyframe poses within 1e-4 (small) and
1e-3 (circuit; observed 6e-5) — the f32 solves sum in another order than
XLA's; BoW scores within 1e-6.
"""

import os

import numpy as np
import pytest
import torch

from srba_slam_tpu.config import (
    GeneralOptions as JGeneral, SRBAStereoSLAMOptions as JOptions, VOOptions as JVO,
)
from srba_slam_tpu.models.estimator import SRBAStereoSLAMEstimator as JEstimator
from srba_slam_tpu.utils.camera import StereoCamera as JCam
from srba_slam_tpu_torch.config import GeneralOptions, SRBAStereoSLAMOptions, VOOptions
from srba_slam_tpu_torch.models.estimator import SRBAStereoSLAMEstimator
from srba_slam_tpu_torch.utils.bench_workload import decisions
from srba_slam_tpu_torch.utils.camera import StereoCamera
from srba_slam_tpu_torch.utils.framesource import SyntheticSource

from torch_parity_inputs import SMALL_CAM, small_frames

# one CPU thread per test process: the ops here are small, and the parallel
# test workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

OUTPUT_FILES = ("out_kf_poses.txt", "time_new_kf.txt", "profiler.csv", "final_graph.dot")

SMALL_OPTIONS = dict(
    orb_adaptive_fast_th=True, n_feats=256, detect_fast_th=12, adaptive_th_min_matches=40,
    max_translation=0.5, max_rotation=10.0, updated_matches_th=40, vo_id_tracking_th=30,
    srba_submap_size=5, srba_max_optimize_depth=3, da_filter_by_direction=False,
    residual_th=10.0)
SMALL = dict(cam=SMALL_CAM, options=SMALL_OPTIONS, vo=dict(fast_th=12, n_feats=256),
             capacity=256, max_kfs=64)

CIRCUIT_CAM = dict(fx_l=160.0, fy_l=160.0, cx_l=128.0, cy_l=72.0, fx_r=160.0, fy_r=160.0,
                   cx_r=128.0, cy_r=72.0, baseline=0.5, width=256, height=144)
CIRCUIT = dict(
    cam=CIRCUIT_CAM,
    options=dict(orb_adaptive_fast_th=True, n_feats=192, detect_fast_th=10,
                 adaptive_th_min_matches=40, max_translation=0.8, max_rotation=15.0,
                 updated_matches_th=35, vo_id_tracking_th=30, srba_submap_size=5,
                 srba_max_tree_depth=4, srba_max_optimize_depth=4,
                 da_filter_by_direction=False, residual_th=10.0, lc_distance=4),
    vo=dict(fast_th=10, n_feats=192), capacity=192, max_kfs=96)


def _run(cfg, frames, port: bool):
    """Step one estimator over ``frames``; records its ``_lc_recovery``
    calls (frame index, result)."""
    if port:
        est = SRBAStereoSLAMEstimator(
            GeneralOptions(), SRBAStereoSLAMOptions(camera=StereoCamera(**cfg["cam"]),
                                                    **cfg["options"]),
            VOOptions(**cfg["vo"]), capacity=cfg["capacity"], max_kfs=cfg["max_kfs"],
            device="cpu")
    else:
        est = JEstimator(
            JGeneral(), JOptions(camera=JCam(**cfg["cam"]), **cfg["options"]),
            JVO(**cfg["vo"]), capacity=cfg["capacity"], max_kfs=cfg["max_kfs"])
    est.initialize()
    est.solve_sync = True
    recoveries = []
    recover = est._lc_recovery

    def counted(*args):
        ok = recover(*args)
        recoveries.append((est.frame_idx, ok))
        return ok

    est._lc_recovery = counted
    for left, right in frames:
        est.step(left, right)
    return est, recoveries


@pytest.fixture(scope="module")
def small_pair():
    frames, _gt = small_frames()
    return _run(SMALL, frames, port=False), _run(SMALL, frames, port=True)


@pytest.fixture(scope="module")
def circuit_pair():
    frames = list(SyntheticSource(StereoCamera(**CIRCUIT_CAM), n_frames=220, seed=5, step=0.12,
                                  loop=True, scene="ground", laps=2.25))
    return _run(CIRCUIT, frames, port=False), _run(CIRCUIT, frames, port=True)


def _assert_same_run(j, t, pose_tol):
    assert decisions(t.step_log) == decisions(j.step_log)
    n = j.store.n_kfs
    assert t.store.n_kfs == n and t.rba.n_kfs == n and t.bow.n_kfs == n
    np.testing.assert_array_equal(t.store.match_ids[:n], j.store.match_ids[:n])
    assert [(s.number_kfs, s.number_feats_new, s.number_feats_common) for s in t.kf_stats] \
        == [(s.number_kfs, s.number_feats_new, s.number_feats_common) for s in j.kf_stats]
    assert [(f, list(i)) for f, _s, i in t.query_log] \
        == [(f, [int(x) for x in i]) for f, _s, i in j.query_log]
    for (_f, st, _i), (_g, sj, _k) in zip(t.query_log, j.query_log):
        np.testing.assert_allclose(st, np.asarray(sj), atol=1e-6)
    np.testing.assert_allclose(t.rba.kf_global[:n], j.rba.kf_global[:n], atol=pose_tol)
    np.testing.assert_allclose(t.current_pose, j.current_pose, atol=pose_tol)
    assert t.next_match_id == j.next_match_id


def test_small_sequence_matches_jax(small_pair, tmp_path):
    (j, _), (t, _) = small_pair
    assert j.store.n_kfs >= 3 and any(r.kf_check and r.inserted_kf is None
                                      for r in j.step_log)
    _assert_same_run(j, t, 1e-4)
    fj = j.finalize(out_dir=str(tmp_path / "jax"))
    ft = t.finalize(out_dir=str(tmp_path / "port"))
    np.testing.assert_allclose(ft, fj, atol=1e-4)
    np.testing.assert_allclose(t.final_poses_cam, j.final_poses_cam, atol=1e-4)
    for name in OUTPUT_FILES:
        pj, pt = tmp_path / "jax" / name, tmp_path / "port" / name
        assert os.path.getsize(pt) > 0, name
        lj, lt = pj.read_text().splitlines(), pt.read_text().splitlines()
        assert len(lt) == len(lj), name
    rows_j = np.loadtxt(tmp_path / "jax" / "out_kf_poses.txt")
    rows_t = np.loadtxt(tmp_path / "port" / "out_kf_poses.txt")
    np.testing.assert_allclose(rows_t, rows_j, atol=2e-4)
    # time_new_kf.txt: the same counts per insertion (the times differ)
    stats_j = np.loadtxt(tmp_path / "jax" / "time_new_kf.txt")[:, 1:]
    stats_t = np.loadtxt(tmp_path / "port" / "time_new_kf.txt")[:, 1:]
    np.testing.assert_array_equal(stats_t, stats_j)
    # the graph file: the same nodes and edges, in the same order
    def graph_ids(p):
        return [ln.split("[")[0] for ln in p.read_text().splitlines()]
    assert graph_ids(tmp_path / "port" / "final_graph.dot") == \
        graph_ids(tmp_path / "jax" / "final_graph.dot")
    # profiler.csv: the sections the reference names
    names = {ln.split(",")[0] for ln in (tmp_path / "port" / "profiler.csv").read_text()
             .splitlines()[1:]}
    assert {"queryDB", "performDA", "define_kf", "global_posegraph"} <= names


def test_circuit_loop_closures_match_jax(circuit_pair):
    (j, rec_j), (t, rec_t) = circuit_pair
    # the recovery path really runs, and both of its outcomes occur
    assert rec_t == rec_j
    assert {ok for _f, ok in rec_t} == {True, False}
    assert any(r.loop_closure_with is not None for r in t.step_log)
    assert any(r.lc_rejected_with is not None for r in t.step_log)
    _assert_same_run(j, t, 1e-3)
    assert t.rba.lc_blacklist == j.rba.lc_blacklist and len(t.rba.lc_blacklist) >= 2
    for name in ("edge_u", "edge_v", "edge_valid"):
        np.testing.assert_array_equal(getattr(t.rba, name), getattr(j.rba, name))
    assert not t.rba.edge_valid.all()       # a layer-B rollback removed an edge
    np.testing.assert_allclose(t.rba.edge_pose, j.rba.edge_pose, atol=1e-3)
    t.finalize()
    j.finalize()
    np.testing.assert_allclose(t.final_poses_cam, j.final_poses_cam, atol=1e-3)


@pytest.mark.slow
def test_circuit_on_the_card_rotation_route(circuit_pair, monkeypatch):
    """The circuit with the card's Horn seed rotation (Jacobi sweeps) forced
    on the CPU against JAX's SVD Kabsch run: the same decisions, queries,
    edges and poses; one match ID of the keyframe store differs (keyframe
    34, frame 203, feature 116: ID 226 in place of JAX's 335). Its cause:
    the seeds differ by f32 rounding (~1e-5), and the change-in-pose solve
    of one aliased candidate of frame 203's check ends 0.08 apart from
    them, which moves two features across its residual threshold; the ID
    walk then takes feature 116's ID from that candidate. A known
    difference of the card's route (ROADMAP)."""
    from srba_slam_tpu_torch.models import data_association as da

    (j, rec_j), _port = circuit_pair
    monkeypatch.setattr(da, "_kabsch_rotation", da._horn_rotation)
    frames = list(SyntheticSource(StereoCamera(**CIRCUIT_CAM), n_frames=220, seed=5, step=0.12,
                                  loop=True, scene="ground", laps=2.25))
    t, rec_t = _run(CIRCUIT, frames, port=True)
    assert rec_t == rec_j
    assert decisions(t.step_log) == decisions(j.step_log)
    n = j.store.n_kfs
    assert t.store.n_kfs == n
    moved = np.argwhere(t.store.match_ids[:n] != j.store.match_ids[:n])
    print(f"match IDs that differ from JAX's: {moved.tolist()} of "
          f"{int((j.store.match_ids[:n] >= 0).sum())}")
    assert moved.tolist() == [[34, 116]]
    assert (int(t.store.match_ids[34, 116]), int(j.store.match_ids[34, 116])) == (226, 335)
    np.testing.assert_allclose(t.rba.kf_global[:n], j.rba.kf_global[:n], atol=1e-3)
    assert t.rba.lc_blacklist == j.rba.lc_blacklist
    np.testing.assert_array_equal(t.rba.edge_valid, j.rba.edge_valid)


def _port_small(**general):
    est = SRBAStereoSLAMEstimator(
        GeneralOptions(**general),
        SRBAStereoSLAMOptions(camera=StereoCamera(**SMALL_CAM), **SMALL_OPTIONS),
        VOOptions(**SMALL["vo"]), capacity=SMALL["capacity"], max_kfs=SMALL["max_kfs"],
        device="cpu")
    est.initialize()
    return est


def test_perform_stereo_slam_honours_to_step_and_max_num_kfs(small_pair):
    _, (t, _) = small_pair
    frames, _gt = small_frames()
    est = _port_small(to_step=12)
    assert decisions(est.perform_stereo_slam(frames)) == decisions(t.step_log)[:13]
    est = _port_small(max_num_kfs=2)
    log = est.perform_stereo_slam(frames)
    assert est.store.n_kfs == 2 and log[-1].inserted_kf == 1


@pytest.mark.parametrize("flag", ["debug", "show3D"])
def test_unported_options_raise(flag, tmp_path):
    """The options that were once refused initialise and run now
    (tests/test_torch_debug_viz.py holds their files to the JAX package's)."""
    est = _port_small(out_dir=str(tmp_path), **{flag: True})
    frames, _gt = small_frames()
    for left, right in frames[:2]:
        est.step(left, right)
    made = "debug" if flag == "debug" else "live_map.json"
    assert os.path.exists(tmp_path / made)
    assert est.debug.enabled == (flag == "debug")


def test_exception_epilogue_saves_artifacts(tmp_path):
    """A failing insertion saves the graph, the trajectory so far, the
    timing stats, the profile and a resumable checkpoint to
    ``<out_dir>/crash/`` before the error propagates; ``error.txt`` is
    written first and names the failure."""
    est = _port_small(out_dir=str(tmp_path))
    define = est.rba.define_new_keyframe
    calls = []

    def failing(*args, **kw):
        calls.append(1)
        if len(calls) >= 3:
            raise RuntimeError("injected SRBA failure")
        return define(*args, **kw)

    est.rba.define_new_keyframe = failing
    frames, _gt = small_frames()
    with pytest.raises(RuntimeError, match="injected"):
        est.perform_stereo_slam(frames)
    crash = tmp_path / "crash"
    for name in ("error.txt", "emergency_state.npz", *OUTPUT_FILES):
        assert (crash / name).exists(), name
    assert (crash / "error.txt").read_text() == "RuntimeError: injected SRBA failure\n"
    assert len((crash / "out_kf_poses.txt").read_text().splitlines()) == est.store.n_kfs == 2
    # the checkpoint resumes: the state of the two keyframes that were in
    from srba_slam_tpu_torch.utils.checkpoint import load_state
    from srba_slam_tpu_torch.utils.compare import compare_estimator_state

    resumed = _port_small()
    load_state(resumed, str(crash / "emergency_state.npz"))
    assert resumed.store.n_kfs == 2 and compare_estimator_state(est, resumed) == []
    # a failure inside the epilogue still leaves error.txt
    est.general.out_dir = str(tmp_path / "again")
    est.finalize = est.save_trajectory = None
    est.emergency_epilogue(ValueError("second"))
    assert (tmp_path / "again" / "crash" / "error.txt").read_text() == "ValueError: second\n"


def test_from_config_reads_the_demo_file():
    from srba_slam_tpu_torch.config import load_config

    ini = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "demo",
                       "config_synthetic_small.ini")
    est = SRBAStereoSLAMEstimator.from_config(ini, capacity=128, max_kfs=8, device="cpu")
    general, opts, vo = load_config(ini)
    assert (est.general, est.opts, est.vo_opts) == (general, opts, vo)
    assert (est.capacity, est.max_kfs, est.device.type) == (128, 8, "cpu")
