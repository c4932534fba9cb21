"""The port's device mesh against the JAX package's, on the CPU.

The JAX side runs over the 8 virtual CPU devices of tests/conftest.py; the
port over a mesh that repeats the CPU device (``make_mesh(devices=...)``):
the same shards, run one after the other.

* ``make_mesh()`` without a card raises; ``shard_batch`` refuses a batch
  that does not divide and round-trips one that does.
* ``batched_vo_step`` over 8 sequences on ``["cpu"] * 8`` against JAX's over
  ``make_mesh(8)``, with tests/test_torch_parallel.py's contract: integer
  fields identical, poses and fleet means within 1e-4.
* ``shard_window_obs`` + ``optimize_window`` on ``["cpu"] * 8``, the window of
  tests/test_window_ba.py's sharded test: against JAX's sharded solve, poses
  within 1e-4 and landmarks within 2e-3 (tests/test_torch_window_ba.py's
  bounds); against the port's unsharded solve, within 1e-3 (the JAX dry
  run's bound for a sharded solve: the order of f32 sums differs only).
* ``SRBAEngine(mesh=)`` on tests/test_window_ba.py's six-keyframe sequence
  against JAX's engine on its mesh: keyframe poses within 1e-3.
* ``FleetSLAM`` over ``["cpu"] * 2`` on tests/test_torch_parallel.py's
  two-sequence workload: every decision identical to the mesh-less fleet's
  and to the solo runs', poses within 1e-5; against the JAX fleet (over 2
  of its devices) within that test's 5e-3. K1 and K2 launch once per shard
  per lockstep attempt.
* The CLI's ``--fleet 2`` prints its mesh line.
* ``dryrun_multichip(2, devices=["cpu", "cpu"])`` runs its asserts: marked
  slow (~33 s on one CPU thread, most of it the four solves of the
  loop-closure-bucket window).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from srba_slam_tpu.models.srba import SRBAEngine as JEngine, SRBAParams as JParams
from srba_slam_tpu.ops import window_ba as jwb
from srba_slam_tpu.parallel import batch as jbatch
from srba_slam_tpu.parallel import fleet as jfleet
from srba_slam_tpu.utils.camera import StereoCamera as JCam
from srba_slam_tpu_torch.__main__ import main
from srba_slam_tpu_torch.models import vo
from srba_slam_tpu_torch.models.bow import Vocabulary
from srba_slam_tpu_torch.models.srba import SRBAEngine, SRBAParams
from srba_slam_tpu_torch.ops import window_ba as twb
from srba_slam_tpu_torch.parallel import batch, fleet
from srba_slam_tpu_torch.parallel.multichip import dryrun_multichip
from srba_slam_tpu_torch.utils import se3_np
from srba_slam_tpu_torch.utils.bench_workload import decisions
from srba_slam_tpu_torch.utils.camera import StereoCamera

from test_torch_cli import _ini
from test_torch_parallel import (
    CAM, FLEET_OPTIONS, _assert_same_features, _port_estimator, _sources, _vocab_desc,
    shared_blur,  # noqa: F401  (a fixture)
)
from test_window_ba import _make_window

torch.set_num_threads(1)

POSE_TOL = 1e-4
LM_TOL = 2e-3
SHARDED_TOL = 1e-3


def _cpu_mesh(n: int, axis: str = batch.BATCH_AXIS) -> batch.Mesh:
    return batch.make_mesh(devices=["cpu"] * n, axis=axis)


def _jax_mesh(n: int, axis: str) -> JMesh:
    devs = np.array(jax.devices()[:n])
    assert len(devs) == n, "tests/conftest.py provides 8 virtual CPU devices"
    return JMesh(devs, (axis,))


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        batch.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        batch.make_mesh(2)
    mesh = batch.make_mesh(devices=["cpu", "cpu"])
    assert mesh.devices == (torch.device("cpu"),) * 2 and not mesh.distinct
    assert batch.fleet_mesh(4, "cpu") == batch.make_mesh(devices=["cpu"])


def test_shard_batch_round_trips_and_refuses_a_ragged_batch():
    mesh = _cpu_mesh(4)
    feats = batch.empty_features(8, 16, device="cpu")
    feats = feats._replace(ys_l=torch.arange(8 * 16, dtype=torch.int32).reshape(8, 16))
    tree = (np.arange(24, dtype=np.float32).reshape(8, 3), feats, None)
    shards = batch.shard_batch(mesh, tree)
    assert len(shards) == 4
    assert torch.equal(shards[1][0], torch.tensor([[6.0, 7, 8], [9, 10, 11]]))
    assert isinstance(shards[2][1], vo.FrameFeatures) and shards[2][2] is None
    assert torch.equal(shards[3][1].ys_l, feats.ys_l[6:])
    back = batch.gather_batch(mesh, shards)
    assert torch.equal(back[0], torch.from_numpy(tree[0]))
    for a, b in zip(back[1], feats):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="does not split"):
        batch.shard_batch(mesh, torch.zeros(6, 2))
    with pytest.raises(ValueError, match="does not split"):
        batch.shard_batch(_cpu_mesh(3), (torch.zeros(3), torch.zeros(4)))


def test_batched_vo_step_on_a_mesh_matches_jax(shared_blur):  # noqa: F811
    rng = np.random.default_rng(0)
    b, h, w, k = 8, 96, 160, 64
    lefts = rng.uniform(0, 255, (b, h, w)).astype(np.float32)
    rights = np.roll(lefts, -3, axis=-1)
    init = np.zeros((b, 6), np.float32)
    jmesh, mesh = jbatch.make_mesh(8), _cpu_mesh(8)
    jprev, tprev = jbatch.empty_features(b, k), batch.empty_features(b, k, device="cpu")
    for _step in range(2):
        jout = jax.device_get(jbatch.batched_vo_step(
            jmesh, jnp.asarray(lefts), jnp.asarray(rights), jprev, jnp.asarray(init),
            JCam(**CAM), fast_th=8.0, k=k))
        tout = batch.batched_vo_step(mesh, lefts, rights, tprev, init, StereoCamera(**CAM),
                                     fast_th=8.0, k=k)
        _assert_same_features(tout[0], jout[0])
        np.testing.assert_array_equal(tout[2].numpy(), jout[2])
        np.testing.assert_allclose(tout[1].numpy(), jout[1], atol=POSE_TOL)
        np.testing.assert_allclose(float(tout[3]), float(jout[3]), atol=POSE_TOL)
        assert float(tout[4]) == float(jout[4])
        jprev, tprev = jout[0], tout[0]
    assert float(tout[4]) > 0.9 and float(tout[1].abs().max()) < 0.05


def test_sharded_window_matches_jax_and_unsharded():
    win, _gt_cam, _ = _make_window(np.random.default_rng(0), px_noise=0.3)
    kw = dict(kernel_param=1.5, max_iters=10)
    rj = jwb.optimize_window(jwb.shard_window_obs(win, _jax_mesh(8, "obs")), JCam.kitti(), **kw)
    twin = twb.BAWindow(*(torch.from_numpy(np.array(a)) for a in win))
    sharded = twb.shard_window_obs(twin, _cpu_mesh(8, "obs"))
    assert len(sharded.shards) == 8 and sharded.shards[3].obs_px.shape[0] == 64
    rt = twb.optimize_window(sharded, StereoCamera.kitti(), **kw)
    r1 = twb.optimize_window(twin, StereoCamera.kitti(), **kw)
    valid = np.asarray(win.lm_valid)
    np.testing.assert_allclose(rt.cam_pose.numpy(), np.asarray(rj.cam_pose), atol=POSE_TOL)
    np.testing.assert_allclose(rt.lm_pos.numpy()[valid], np.asarray(rj.lm_pos)[valid],
                               atol=LM_TOL)
    np.testing.assert_allclose(rt.cam_pose.numpy(), r1.cam_pose.numpy(), atol=SHARDED_TOL)
    np.testing.assert_allclose(rt.lm_pos.numpy()[valid], r1.lm_pos.numpy()[valid],
                               atol=SHARDED_TOL)
    assert abs(float(rt.obs_rmse) - float(r1.obs_rmse)) < 1e-2
    # one shard is the unsharded solve, bit for bit
    r_one = twb.optimize_window(twb.shard_window_obs(twin, _cpu_mesh(1, "obs")),
                                StereoCamera.kitti(), **kw)
    for name, x, y in zip(r1._fields, r_one, r1):
        assert torch.equal(x, y), name


def _engine_run(engine) -> np.ndarray:
    """tests/test_window_ba.py's engine sequence: six keyframes 0.8 m apart
    over 80 landmarks, then the keyframes' global poses."""
    cam = StereoCamera.kitti()
    rng = np.random.default_rng(5)
    lms_w = np.stack([rng.uniform(-6, 6, 80), rng.uniform(-2, 2, 80),
                      rng.uniform(8, 25, 80)], -1)
    for kf in range(6):
        inv = se3_np.inverse(np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.8 * kf]))
        ids, px, rel = [], [], []
        for j, pw in enumerate(lms_w):
            pc = se3_np.transform_point(inv, pw)
            if pc[2] < 2.0:
                continue
            ids.append(j)
            px.append([cam.cx_l + cam.fx_l * pc[0] / pc[2], cam.cy_l + cam.fy_l * pc[1] / pc[2],
                       cam.cx_r + cam.fx_r * (pc[0] - cam.baseline) / pc[2]])
            rel.append(pc)
        if kf:
            engine.set_initial_kf_pose(np.array([0, 0, 0, 0, 0, 0.8]))
        engine.define_new_keyframe((np.asarray(ids, np.int64), np.asarray(px, np.float64),
                                    np.asarray(rel, np.float64)), run_opt=kf > 0)
    engine.flush()
    return engine.kf_global[:6].copy()


def test_srba_engine_on_a_mesh_matches_jax():
    p = dict(submap_size=4, max_optimize_depth=3, max_kfs=16, win_cams=8, win_lms=1024,
             win_obs=2048, opt_iters=6)
    ref = _engine_run(JEngine(JCam.kitti(), JParams(**p), mesh=_jax_mesh(8, "obs")))
    eng = SRBAEngine(StereoCamera.kitti(), SRBAParams(**p), mesh=_cpu_mesh(8, "obs"))
    assert eng.device == torch.device("cpu")
    np.testing.assert_allclose(_engine_run(eng), ref, atol=SHARDED_TOL)


@pytest.fixture(scope="module")
def fleets():
    """(JAX fleet, port fleet without a mesh, port fleet on ["cpu"] * 2, the
    solo runs, lockstep attempts and K1/K2 launches of the mesh fleet)."""
    from srba_slam_tpu.config import (
        GeneralOptions as JGeneral, SRBAStereoSLAMOptions as JOptions, VOOptions as JVO,
    )
    from srba_slam_tpu.models.bow import Vocabulary as JVocabulary
    from srba_slam_tpu.models.estimator import SRBAStereoSLAMEstimator as JEstimator

    sources = _sources()
    jvoc = JVocabulary.train(_vocab_desc(), k=8, L=2, seed=0)
    jests = []
    for _ in sources:
        e = JEstimator(JGeneral(), JOptions(camera=JCam(**CAM), **FLEET_OPTIONS),
                       JVO(fast_th=12, n_feats=128), capacity=128, max_kfs=32)
        e.initialize(vocabulary=jvoc)
        jests.append(e)
    jfleet.FleetSLAM(jests, mesh=jbatch.make_mesh(2)).run(sources)

    voc = Vocabulary.train(_vocab_desc(), k=8, L=2, seed=0)
    solo = [_port_estimator(voc) for _ in sources]
    for est, frames in zip(solo, sources):
        est.perform_stereo_slam(frames)
    plain = [_port_estimator(voc) for _ in sources]
    fleet.FleetSLAM(plain).run(sources)
    meshed = [_port_estimator(voc) for _ in sources]
    flt = fleet.FleetSLAM(meshed, mesh=_cpu_mesh(2))
    counts = {"fast_nms": 0, "orb_descriptors": 0, "shard_attempts": 0}
    mp = pytest.MonkeyPatch()
    for name in ("fast_nms", "orb_descriptors"):
        fn = getattr(vo, name)
        mp.setattr(vo, name, lambda *a, _fn=fn, _n=name, **k: (
            counts.__setitem__(_n, counts[_n] + 1), _fn(*a, **k))[1])
    batch_fn = fleet.extract_and_match_batch
    mp.setattr(fleet, "extract_and_match_batch", lambda *a, **k: (
        counts.__setitem__("shard_attempts", counts["shard_attempts"] + 1), batch_fn(*a, **k))[1])
    try:
        flt.run(sources)
    finally:
        mp.undo()
    return jests, plain, meshed, solo, flt, counts


def test_fleet_on_a_mesh_makes_the_solo_decisions(fleets):
    _jests, plain, meshed, solo, flt, counts = fleets
    assert len(flt.mesh.devices) == 2 and flt.shards == [[0], [1]]
    for m, p, s in zip(meshed, plain, solo):
        for other in (p, s):
            assert decisions(m.step_log) == decisions(other.step_log)
            assert [r.n_stereo_matches for r in m.step_log] == [r.n_stereo_matches
                                                                for r in other.step_log]
            n = other.store.n_kfs
            assert m.store.n_kfs == n >= 2
            np.testing.assert_array_equal(m.store.match_ids[:n], other.store.match_ids[:n])
            m.rba.flush(), other.rba.flush()   # the same solves in flight land
            np.testing.assert_allclose(m.rba.kf_global[:n], other.rba.kf_global[:n], atol=1e-5)
            assert (m.vo.fast_th, m.vo.orb_th, m._da_seed) == (other.vo.fast_th,
                                                              other.vo.orb_th, other._da_seed)
    # the first frame bootstraps each sequence; then one K1 and one K2
    # launch per shard per lockstep attempt
    assert counts["shard_attempts"] >= 2 * 13
    assert counts["fast_nms"] == counts["orb_descriptors"] == counts["shard_attempts"] + 2


def test_fleet_on_a_mesh_matches_jax_fleet(fleets):
    jests, _plain, meshed, _solo, _flt, _counts = fleets
    for j, t in zip(jests, meshed):
        assert t.store.n_kfs == j.store.n_kfs >= 2
        j.rba.flush()
        t.rba.flush()   # both schedules are pipelined: land the solves in flight
        n = t.store.n_kfs
        np.testing.assert_allclose(t.rba.kf_global[:n], j.rba.kf_global[:n], atol=5e-3)
        assert (t.rba.n_lms, t.rba.n_edges) == (j.rba.n_lms, j.rba.n_edges)


def test_fleet_refuses_a_mesh_its_estimators_are_not_on(fleets):
    _jests, _plain, meshed, *_ = fleets
    with pytest.raises(ValueError, match="do not split"):
        fleet.FleetSLAM(meshed, mesh=_cpu_mesh(3))
    meta = batch.make_mesh(devices=["cpu", "meta"])
    with pytest.raises(AssertionError, match="live on its device"):
        fleet.FleetSLAM(meshed, mesh=meta)


def test_cli_fleet_prints_its_mesh(tmp_path, capsys):
    ini, _out = _ini(tmp_path, "mesh")
    assert main([ini, "--cpu", "--synthetic", "3", "--fleet", "2"]) == 0
    assert "fleet: 2 sequences x 3 frames on a 1-device mesh" in capsys.readouterr().out


@pytest.mark.slow
def test_dryrun_multichip_on_two_cpu_devices():
    out = dryrun_multichip(2, devices=["cpu", "cpu"])
    assert out["devices"] == ["cpu", "cpu"] and not out["distinct"]
    assert out["sharded_err"] < 1e-3 and out["lc_err"] < 1e-3
    assert all(n >= 2 for n in out["kfs_per_shard"]) and out["checks"] >= 2
