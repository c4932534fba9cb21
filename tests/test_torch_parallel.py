"""``parallel/`` of the port against the JAX package's, on the CPU.

The small camera of tests/test_parallel.py (160x96). The JAX side runs over
the virtual CPU devices tests/conftest.py sets up (``make_mesh``); the port
over a mesh of the one CPU device (tests/test_torch_mesh.py shards).

* ``batched_vo_step`` over 8 sequences (random frames, the right image the
  left rolled by 3 px), twice, the second step tracking the first's
  features: every integer field of the features and the validity
  identical, poses within 1e-4, the fleet means within 1e-4. Both packages
  blur with the JAX package's ``gauss_blur7`` here (the port's own differs
  in the last bit at a few pixels, tests/test_torch_orb.py).
* ``empty_features``: the JAX package's shapes, the uint32 words as int32.
* ``feature_budget_sweep`` at budgets 64 and 128 (shared blur): equal
  match and track means, trajectories within 1e-4.
* ``FleetSLAM`` on tests/test_parallel.py's workload (two sequences, seeds
  11 and 23, 14 frames, a shared vocabulary): against the JAX fleet, the
  keyframe counts, landmark and edge counts equal, keyframe poses within
  the JAX test's own 5e-3; against the port's solo runs of the same
  sequences, every decision identical and poses within 1e-5; K1 and K2
  launch once per lockstep attempt.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srba_slam_tpu.models.bow import Vocabulary as JVocabulary
from srba_slam_tpu.ops.orb import gauss_blur7 as jblur
from srba_slam_tpu.parallel import batch as jbatch
from srba_slam_tpu.parallel import fleet as jfleet
from srba_slam_tpu.parallel import sweep as jsweep
from srba_slam_tpu.utils.camera import StereoCamera as JCam
from srba_slam_tpu_torch.config import GeneralOptions, SRBAStereoSLAMOptions, VOOptions
from srba_slam_tpu_torch.models import vo
from srba_slam_tpu_torch.models.bow import Vocabulary
from srba_slam_tpu_torch.models.estimator import SRBAStereoSLAMEstimator
from srba_slam_tpu_torch.ops import hopper_fast, orb
from srba_slam_tpu_torch.parallel import batch, fleet, sweep
from srba_slam_tpu_torch.utils.bench_workload import decisions
from srba_slam_tpu_torch.utils.camera import StereoCamera
from srba_slam_tpu_torch.utils.framesource import SyntheticSource

torch.set_num_threads(1)

CAM = dict(fx_l=90.0, fy_l=90.0, cx_l=80.0, cy_l=48.0, fx_r=90.0, fy_r=90.0, cx_r=80.0,
           cy_r=48.0, baseline=0.5, width=160, height=96)
INT_FIELDS = ("ys_l", "xs_l", "valid_l", "desc_l", "ys_r", "xs_r", "valid_r", "desc_r",
              "m_r_idx", "m_valid", "octave")
FLEET_OPTIONS = dict(orb_adaptive_fast_th=True, n_feats=128, detect_fast_th=12,
                     adaptive_th_min_matches=30, max_translation=0.5, max_rotation=10.0,
                     updated_matches_th=30, vo_id_tracking_th=25, srba_submap_size=5,
                     srba_max_optimize_depth=3, da_filter_by_direction=False, residual_th=10.0)


def _jax_blur(img: torch.Tensor) -> torch.Tensor:
    fn = jblur
    for _ in range(img.dim() - 2):
        fn = jax.vmap(fn)
    return torch.from_numpy(np.array(fn(jnp.asarray(img.numpy(), jnp.float32))))


@pytest.fixture
def shared_blur(monkeypatch):
    monkeypatch.setattr(orb, "gauss_blur7", _jax_blur)
    monkeypatch.setattr(hopper_fast, "gauss_blur7", _jax_blur)


def _assert_same_features(t, j):
    for name in INT_FIELDS:
        b = np.asarray(getattr(j, name))
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      b.view(np.int32) if b.dtype == np.uint32 else b,
                                      err_msg=name)
    np.testing.assert_allclose(t.pts3d.numpy(), np.asarray(j.pts3d), rtol=1e-5, atol=1e-5)


def test_batched_vo_step_matches_jax(shared_blur):
    rng = np.random.default_rng(0)
    b, h, w, k = 8, 96, 160, 64
    lefts = rng.uniform(0, 255, (b, h, w)).astype(np.float32)
    rights = np.roll(lefts, -3, axis=-1)
    init = np.zeros((b, 6), np.float32)
    mesh = jbatch.make_mesh(len(jax.devices()))
    jprev, tprev = jbatch.empty_features(b, k), batch.empty_features(b, k, device="cpu")
    for _step in range(2):
        jout = jax.device_get(jbatch.batched_vo_step(
            mesh, jnp.asarray(lefts), jnp.asarray(rights), jprev, jnp.asarray(init),
            JCam(**CAM), fast_th=8.0, k=k))
        tout = batch.batched_vo_step(batch.make_mesh(devices=["cpu"]), lefts, rights, tprev,
                                     init, StereoCamera(**CAM), fast_th=8.0, k=k)
        _assert_same_features(tout[0], jout[0])
        np.testing.assert_array_equal(tout[2].numpy(), jout[2])
        np.testing.assert_allclose(tout[1].numpy(), jout[1], atol=1e-4)
        np.testing.assert_allclose(float(tout[3]), float(jout[3]), atol=1e-4)
        assert float(tout[4]) == float(jout[4])
        jprev, tprev = jout[0], tout[0]
    # the second step tracked identical frames: every sequence, no motion
    assert float(tout[4]) > 0.9 and float(tout[1].abs().max()) < 0.05


def test_empty_features_match_jax():
    j = jbatch.empty_features(3, 16)
    t = batch.empty_features(3, 16, device="cpu")
    for name in vo.FrameFeatures._fields:
        a, b = getattr(t, name), np.asarray(getattr(j, name))
        assert tuple(a.shape) == b.shape, name
        assert a.numpy().dtype == (np.int32 if b.dtype == np.uint32 else b.dtype), name
        assert not a.any()


def test_feature_budget_sweep_matches_jax(shared_blur):
    frames = list(SyntheticSource(StereoCamera(**CAM), n_frames=5, seed=3, step=0.08))
    ref = jsweep.feature_budget_sweep(frames, JCam(**CAM), budgets=(64, 128), fast_th=10.0)
    got = sweep.feature_budget_sweep(frames, StereoCamera(**CAM), budgets=(64, 128),
                                     fast_th=10.0, device="cpu")
    assert [r.n_feats for r in got] == [r.n_feats for r in ref] == [64, 128]
    for g, r in zip(got, ref):
        assert (g.mean_stereo_matches, g.mean_tracked) == (r.mean_stereo_matches, r.mean_tracked)
        assert g.trajectory.shape == r.trajectory.shape == (5, 6)
        np.testing.assert_allclose(g.trajectory, r.trajectory, atol=1e-4)
    assert got[1].mean_stereo_matches >= got[0].mean_stereo_matches


def _sources():
    return [list(SyntheticSource(StereoCamera(**CAM), n_frames=14, seed=s, step=0.12))
            for s in (11, 23)]


def _vocab_desc():
    rng = np.random.default_rng(0)
    return rng.integers(0, 2**32, (512, 8), dtype=np.uint64).astype(np.uint32)


def _port_estimator(voc):
    est = SRBAStereoSLAMEstimator(
        GeneralOptions(), SRBAStereoSLAMOptions(camera=StereoCamera(**CAM), **FLEET_OPTIONS),
        VOOptions(fast_th=12, n_feats=128), capacity=128, max_kfs=32, device="cpu")
    est.initialize(vocabulary=voc)
    return est


@pytest.fixture(scope="module")
def fleets():
    """(JAX fleet estimators, port fleet estimators, port solo estimators,
    K1/K2 launches and lockstep attempts of the port's fleet)."""
    from srba_slam_tpu.config import (
        GeneralOptions as JGeneral, SRBAStereoSLAMOptions as JOptions, VOOptions as JVO,
    )
    from srba_slam_tpu.models.estimator import SRBAStereoSLAMEstimator as JEstimator

    sources = _sources()
    jvoc = JVocabulary.train(_vocab_desc(), k=8, L=2, seed=0)
    jests = []
    for _ in sources:
        e = JEstimator(JGeneral(), JOptions(camera=JCam(**CAM), **FLEET_OPTIONS),
                       JVO(fast_th=12, n_feats=128), capacity=128, max_kfs=32)
        e.initialize(vocabulary=jvoc)
        jests.append(e)
    jfleet.FleetSLAM(jests).run(sources)

    voc = Vocabulary.train(_vocab_desc(), k=8, L=2, seed=0)
    solo = [_port_estimator(voc) for _ in sources]
    for est, frames in zip(solo, sources):
        est.perform_stereo_slam(frames)
    tests = [_port_estimator(voc) for _ in sources]
    flt = fleet.FleetSLAM(tests)
    counts = {"fast_nms": 0, "orb_descriptors": 0, "attempts": 0}
    mp = pytest.MonkeyPatch()
    for name in ("fast_nms", "orb_descriptors"):
        fn = getattr(vo, name)
        mp.setattr(vo, name, lambda *a, _fn=fn, _n=name, **k: (
            counts.__setitem__(_n, counts[_n] + 1), _fn(*a, **k))[1])
    batch_fn = fleet.extract_and_match_batch
    mp.setattr(fleet, "extract_and_match_batch", lambda *a, **k: (
        counts.__setitem__("attempts", counts["attempts"] + 1), batch_fn(*a, **k))[1])
    try:
        flt.run(sources)
    finally:
        mp.undo()
    return jests, tests, solo, counts


def test_fleet_matches_jax_fleet(fleets):
    jests, tests, _solo, _counts = fleets
    for j, t in zip(jests, tests):
        assert t.store.n_kfs == j.store.n_kfs >= 2
        j.rba.flush()
        t.rba.flush()   # both schedules are pipelined: land the solves in flight
        n = t.store.n_kfs
        np.testing.assert_allclose(t.rba.kf_global[:n], j.rba.kf_global[:n], atol=5e-3)
        assert t.rba.n_lms == j.rba.n_lms
        assert t.rba.n_edges == j.rba.n_edges


def test_fleet_matches_solo_runs(fleets):
    _jests, tests, solo, counts = fleets
    for t, s in zip(tests, solo):
        assert decisions(t.step_log) == decisions(s.step_log)
        assert [r.n_stereo_matches for r in t.step_log] == [r.n_stereo_matches
                                                            for r in s.step_log]
        n = s.store.n_kfs
        np.testing.assert_array_equal(t.store.match_ids[:n], s.store.match_ids[:n])
        t.rba.flush(), s.rba.flush()   # the same solves in flight land
        np.testing.assert_allclose(t.rba.kf_global[:n], s.rba.kf_global[:n], atol=1e-5)
        assert (t.vo.fast_th, t.vo.orb_th, t._da_seed) == (s.vo.fast_th, s.vo.orb_th,
                                                          s._da_seed)
    # the first frame bootstraps each sequence (one launch each); then one
    # launch of K1 and of K2 per lockstep attempt, not one per sequence
    assert counts["attempts"] >= 13
    assert counts["fast_nms"] == counts["orb_descriptors"] == counts["attempts"] + len(tests)


def test_fleet_state_continues_solo(fleets):
    """After ``run`` each estimator holds its own tracking state: stepping
    one more frame alone works, and a mixed lifecycle is refused."""
    _jests, tests, _solo, _counts = fleets
    assert all(t.vo._prev is not None and t.vo._prev.desc_l._base is None for t in tests)
    fresh = _port_estimator(tests[0].bow.voc)
    with pytest.raises(AssertionError, match="lifecycle"):
        fleet.FleetSLAM([tests[0], fresh]).step([_sources()[0][0]] * 2)
