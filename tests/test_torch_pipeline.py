"""The port's default schedule against the JAX package's, on the CPU.

``perform_stereo_slam_batched`` on the small-geometry sequence of
tests/test_batch_mode.py (320x200, seed 11, step 0.12, 25 frames, batch
6, its estimator options), with the JAX package's default schedule on both
sides: window solves pipelined (``solve_sync = False``), keyframe checks
deferred and speculated on, one read a batch. One case for each JAX test
of that file:

* pipelined: decisions identical to the JAX package's pipelined run, and
  to the port's per-frame run; keyframe poses within 1e-3 of JAX's (the
  solves land at the same reads; f32 sums in another order) and within
  1e-6 of the port's per-frame run;
* declined checks (a check every ~2 frames, most not inserting), and the
  same with ``updated_matches_th = 190``, where threshold shrinks make the
  predictions miss and replay: decisions, best-tracked counts and the
  final thresholds identical to JAX's, poses within 1e-3, decisions
  identical to per-frame stepping;
* ``solve_sync``: strict batched against strict per-frame within 1e-3
  (and JAX's strict batched run's decisions);
* ``solve_flush_before_insert``: the strict run's decisions, poses no
  farther from strict than pipelined's and within 0.05 m, JAX's decisions;
* ``max_num_kfs = 4`` with checks planned in flight: the run stops at the
  per-frame run's frame;
* every deferred check predicted to insert (``_da_dead`` poisoned): the
  misses replay exactly; decisions identical to JAX's poisoned run and to
  per-frame stepping, poses within 1e-3; the engine's IDs of the tracks
  chained to the last keyframe equal per-frame stepping's;
* the device-resident loop (``perform_stereo_slam_device``; the JAX
  package's ``bench.py`` drives ``_dispatch_scan``/``_process_scan`` so):
  7 frames through the batched loop, then the 18 others as chunks already
  on the device, of 18 (one scan) and of 6: decisions identical to JAX's
  run of the same chunks, poses within 1e-3;
* the frame uploader's worker against the main thread, thread switches
  every microsecond: every frame once, in order;
* the one-read contract: at most one ``to_host`` per batch in the loop
  (plus one to finish, and the one-off read that trains the vocabulary at
  the first check), two more for the epilogue, and no
  ``Tensor.item``/``bool`` read in the loop.

Slow (``-m slow``): the port of tests/test_shrink_replay.py, the bench
street workload through the device-resident loop, the fast shrink replay
against the classic one.
"""

import numpy as np
import pytest
import torch

from srba_slam_tpu.config import (
    GeneralOptions as JGeneral, SRBAStereoSLAMOptions as JOptions, VOOptions as JVO,
)
from srba_slam_tpu.models import estimator as jest_mod
from srba_slam_tpu.utils.camera import StereoCamera as JCam
from srba_slam_tpu_torch.config import GeneralOptions, SRBAStereoSLAMOptions, VOOptions
from srba_slam_tpu_torch.models import estimator as test_mod
from srba_slam_tpu_torch.models import srba as srba_mod
from srba_slam_tpu_torch.utils.bench_workload import decisions
from srba_slam_tpu_torch.utils.camera import StereoCamera
from srba_slam_tpu_torch.utils.framesource import SyntheticSource

from test_torch_batched_solve import _count_host_reads
from test_torch_estimator import SMALL_OPTIONS
from torch_parity_inputs import SMALL_CAM

torch.set_num_threads(1)

BATCH = 6
# tests/test_batch_mode.py's declined-check scenario
MISS_OPTIONS = dict(SMALL_OPTIONS, max_translation=0.18, updated_matches_th=12,
                    vo_id_tracking_th=8)
# its keyframe-capacity scenario (max_num_kfs = 4)
CAP_OPTIONS = dict(SMALL_OPTIONS, max_translation=0.18)


def _frames():
    return list(SyntheticSource(StereoCamera(**SMALL_CAM), n_frames=25, seed=11, step=0.12))


def _make(port: bool, options=SMALL_OPTIONS, sync=False, mid=False, max_num_kfs=0):
    if port:
        est = test_mod.SRBAStereoSLAMEstimator(
            GeneralOptions(max_num_kfs=max_num_kfs),
            SRBAStereoSLAMOptions(camera=StereoCamera(**SMALL_CAM), **options),
            VOOptions(fast_th=12, n_feats=256), capacity=256, max_kfs=64, device="cpu")
    else:
        est = jest_mod.SRBAStereoSLAMEstimator(
            JGeneral(max_num_kfs=max_num_kfs), JOptions(camera=JCam(**SMALL_CAM), **options),
            JVO(fast_th=12, n_feats=256), capacity=256, max_kfs=64)
    est.initialize()
    est.solve_sync = sync
    est.solve_flush_before_insert = mid
    return est


def _batched(port: bool, frames, batch=BATCH, **kw):
    est = _make(port, **kw)
    est.perform_stereo_slam_batched(frames, batch=batch)
    est.rba.flush()
    return est


def _per_frame(port: bool, frames, **kw):
    est = _make(port, **kw)
    for left, right in frames:
        est.step(left, right)
        if est.general.max_num_kfs and est.store.n_kfs >= est.general.max_num_kfs:
            break
    est.rba.flush()
    return est


def _log(est):
    return [(r.frame_idx, r.kf_check, r.inserted_kf, r.best_tracked, r.n_stereo_matches,
             r.tracked_from_last_kf) for r in est.step_log]


def _poses(est):
    return est.rba.kf_global[:est.store.n_kfs]


@pytest.fixture(scope="module")
def small():
    frames = _frames()
    return dict(jax=_batched(False, frames), port=_batched(True, frames),
                per_frame=_per_frame(True, frames))


@pytest.fixture(scope="module")
def strict():
    frames = _frames()
    return dict(jax=_batched(False, frames, sync=True), port=_batched(True, frames, sync=True),
                per_frame=_per_frame(True, frames, sync=True))


def test_batched_matches_per_frame_pipeline(small):
    j, t, pf = small["jax"], small["port"], small["per_frame"]
    assert j.store.n_kfs >= 3 and not t.solve_sync
    assert _log(t) == _log(j)
    assert decisions(t.step_log) == decisions(pf.step_log)
    n = j.store.n_kfs
    np.testing.assert_array_equal(t.store.match_ids[:n], j.store.match_ids[:n])
    np.testing.assert_allclose(_poses(t), _poses(j), atol=1e-3)
    np.testing.assert_allclose(_poses(t), _poses(pf), atol=1e-6)
    assert len(t.step_log) == 25 and t.frame_idx == 24
    # the latency log: one entry a batch, one a resolved check
    assert len(t.lat["batches"]) == len(j.lat["batches"]) == 4
    assert len(t.lat["checks"]) == len(j.lat["checks"])
    assert [u["n"] for u in t.lat["uploads"]] == [6, 6, 6, 6]


@pytest.mark.parametrize("matches_th", [12, 190])
def test_speculation_miss_replays_exactly(monkeypatch, matches_th):
    frames = _frames()
    options = dict(MISS_OPTIONS, updated_matches_th=matches_th)
    misses = []
    cls = test_mod.SRBAStereoSLAMEstimator
    run_miss, run_dem = cls._miss_recover, cls._demote_shrink_miss

    def counted(self, c, d):
        misses.append(("replayed", c["res"].frame_idx))
        return run_miss(self, c, d)

    def demoted(self, c, d):
        out = run_dem(self, c, d)
        if out:
            misses.append(("demoted", c["res"].frame_idx))
        return out

    monkeypatch.setattr(cls, "_miss_recover", counted)
    monkeypatch.setattr(cls, "_demote_shrink_miss", demoted)
    t = _batched(True, frames, options=options)
    monkeypatch.undo()
    j = _batched(False, frames, options=options)
    checks = sum(r.kf_check for r in t.step_log)
    # declined checks; at 190 the best-tracked counts (~185-225) fall in
    # the threshold-shrink band, and the predictions miss
    assert checks > t.store.n_kfs, (checks, t.store.n_kfs)
    assert matches_th < 190 or len(misses) >= 2, misses
    assert t.store.n_kfs == j.store.n_kfs
    assert [(f, c, i, b) for f, c, i, b, *_ in _log(t)] \
        == [(f, c, i, b) for f, c, i, b, *_ in _log(j)]
    assert (t.updated_translation_th, t.updated_rotation_th) \
        == (j.updated_translation_th, j.updated_rotation_th)
    np.testing.assert_allclose(_poses(t), _poses(j), atol=1e-3)
    pf = _per_frame(True, frames, options=options)
    assert decisions(pf.step_log) == decisions(t.step_log)


def test_solve_sync_strict_pose_equivalence(strict):
    j, t, pf = strict["jax"], strict["port"], strict["per_frame"]
    assert t.solve_sync and decisions(t.step_log) == decisions(j.step_log)
    assert [r.inserted_kf for r in t.step_log] == [r.inserted_kf for r in pf.step_log]
    np.testing.assert_allclose(_poses(t), _poses(pf), atol=1e-3)
    np.testing.assert_allclose(_poses(t), _poses(j), atol=1e-3)


def test_flush_before_insert_between_pipelined_and_strict(small, strict):
    frames = _frames()
    ref, pipe = strict["port"], small["port"]
    mid = _batched(True, frames, mid=True)
    jmid = _batched(False, frames, mid=True)
    assert [r.inserted_kf for r in mid.step_log] == [r.inserted_kf for r in ref.step_log]
    assert decisions(mid.step_log) == decisions(jmid.step_log)
    n = ref.store.n_kfs
    assert mid.store.n_kfs == n

    def dmax(e):
        return float(np.max(np.linalg.norm(e.rba.kf_global[:n, 3:] - ref.rba.kf_global[:n, 3:],
                                           axis=1)))

    d_mid, d_pipe = dmax(mid), dmax(pipe)
    assert d_mid <= max(d_pipe, 1e-6) + 1e-9, (d_mid, d_pipe)
    assert d_mid < 0.05, d_mid
    np.testing.assert_allclose(_poses(mid), _poses(jmid), atol=1e-3)


def test_kf_capacity_guard_with_planned_checks():
    frames = _frames()
    a = _per_frame(False, frames, options=CAP_OPTIONS, max_num_kfs=4)
    b = _batched(True, frames, batch=5, options=CAP_OPTIONS, max_num_kfs=4)
    assert b.store.n_kfs == a.store.n_kfs == 4
    # the stop is per-frame exact: the log ends at the frame per-frame mode stopped on
    assert [(r.frame_idx, r.kf_check, r.inserted_kf) for r in b.step_log] \
        == [(r.frame_idx, r.kf_check, r.inserted_kf) for r in a.step_log]
    assert not b._spec and not b._check_plan


def _poison(mod, monkeypatch, recoveries):
    cls = mod.SRBAStereoSLAMEstimator
    run_defer, run_miss = cls._defer_check, cls._miss_recover

    def bad_predict(self, res, force, batch_rec, j):
        self._da_dead = True  # every check predicts an insert
        return run_defer(self, res, force, batch_rec, j)

    def counted(self, c, d):
        recoveries.append(c["snap"]["frame_idx"])
        return run_miss(self, c, d)

    monkeypatch.setattr(cls, "_defer_check", bad_predict)
    monkeypatch.setattr(cls, "_miss_recover", counted)


def test_forced_mispredictions_replay_exactly(small, monkeypatch):
    frames = _frames()
    rec_t, rec_j = [], []
    _poison(test_mod, monkeypatch, rec_t)
    _poison(jest_mod, monkeypatch, rec_j)
    t = _batched(True, frames)
    j = _batched(False, frames)
    monkeypatch.undo()
    assert rec_t and rec_t == rec_j
    assert _log(t) == _log(j)
    pf = small["per_frame"]
    assert [x[:3] + x[4:] for x in _log(t)] == [x[:3] + x[4:] for x in _log(pf)]
    np.testing.assert_allclose(_poses(t), _poses(j), atol=1e-3)
    np.testing.assert_allclose(_poses(t), _poses(pf), atol=1e-3)
    # the engine's IDs of the tracks chained to the last keyframe are the
    # per-frame run's (fresh IDs of unchained tracks may differ)
    last = t.store.match_ids[t.store.n_kfs - 1]
    kf_ids = set(int(v) for v in last[last >= 0])
    ids_t, ids_p = np.asarray(t.vo._prev_ids), np.asarray(pf.vo._prev_ids)
    sel_t = np.asarray([int(v) in kf_ids for v in ids_t])
    sel_p = np.asarray([int(v) in kf_ids for v in ids_p])
    np.testing.assert_array_equal(sel_t, sel_p)
    assert sel_t.any()
    np.testing.assert_array_equal(ids_t[sel_t], ids_p[sel_t])
    assert t.vo._kf_id_set == kf_ids


def jax_device_loop(est, chunks):
    """The device-resident loop of the JAX package's ``bench.py``: each
    chunk one scan, the next dispatched from inside the read of the one
    before (``_dispatch_scan``/``_process_scan``)."""
    disp = est._dispatch_scan(*chunks[0])
    i = 0
    while disp is not None:
        nf = None
        if i + 1 < len(chunks):
            nf = (lambda cd, c=chunks[i + 1]: est._dispatch_scan(*c, chain=cd))
        disp = est._process_scan(disp, nf)
        i += 1
    est._finish_batched()


@pytest.mark.parametrize("chunk", [18, 6])
def test_device_resident_loop_matches_jax(chunk):
    import jax.numpy as jnp

    frames = _frames()
    warm, rest = frames[:7], frames[7:]
    runs = []
    for port in (True, False):
        est = _make(port)
        est.perform_stereo_slam_batched(warm, batch=BATCH)
        est.rba.flush()
        stack = torch.from_numpy if port else jnp.asarray
        chunks = [(stack(np.stack([f[0] for f in rest[c:c + chunk]])),
                   stack(np.stack([f[1] for f in rest[c:c + chunk]])))
                  for c in range(0, len(rest), chunk)]
        if port:
            est.perform_stereo_slam_device(chunks)
        else:
            jax_device_loop(est, chunks)
        est.rba.flush()
        runs.append(est)
    t, j = runs
    assert j.store.n_kfs >= 3 and len(t.step_log) == 25
    assert _log(t) == _log(j)
    n = j.store.n_kfs
    np.testing.assert_array_equal(t.store.match_ids[:n], j.store.match_ids[:n])
    np.testing.assert_allclose(_poses(t), _poses(j), atol=1e-3)


def test_batched_single_read_per_batch(monkeypatch):
    frames = _frames()
    est = _make(True)
    est.step(*frames[0])                   # the first frame bootstraps outside
    calls = []
    run = test_mod.to_host

    def counting(tensors):
        calls.append(len(tensors))
        return run(tensors)

    monkeypatch.setattr(test_mod, "to_host", counting)
    monkeypatch.setattr(srba_mod, "to_host", counting)
    trained = []
    run_voc = test_mod.SRBAStereoSLAMEstimator.ensure_vocabulary
    monkeypatch.setattr(test_mod.SRBAStereoSLAMEstimator, "ensure_vocabulary",
                        lambda self, **k: (trained.append(self.bow is None),
                                           run_voc(self, **k))[1])
    reads = _count_host_reads(monkeypatch)
    est.perform_stereo_slam_batched(frames[1:], batch=BATCH)
    loop_calls, loop_reads = len(calls), reads[0]
    est.rba.flush()
    est._finish_batched()
    monkeypatch.undo()
    n_batches = -(-24 // BATCH)
    # one read a batch and one to finish, plus the one-off read of the
    # training descriptors where the first check trains the vocabulary
    # (no vocabulary file here)
    assert sum(trained) == 1
    assert loop_calls <= n_batches + 1 + sum(trained), calls
    assert len(calls) <= loop_calls + 2, calls
    assert loop_reads == 0, loop_reads
    assert est.store.n_kfs >= 3


def test_frame_uploader_keeps_every_frame_in_order():
    """The uploader's worker against the main thread with a thread switch
    every microsecond: the batches taken and the ones drained at a stop
    hold every frame of the source up to where the worker got, in order,
    none twice, and the worker has ended."""
    import sys
    import time

    from srba_slam_tpu_torch.models.estimator import _FrameUploader

    frames = [(np.full((2, 3), i, np.int32), np.full((2, 3), -i, np.int32)) for i in range(300)]
    keep = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        up = _FrameUploader(iter(frames), 7, "cpu", 100, depth=3)
        taken = []
        for _ in range(20):
            item = up.next()
            assert item["f0"] == 100 + sum(len(t["frames"]) for t in taken)
            np.testing.assert_array_equal(item["lefts"][:, 0, 0].numpy(),
                                          [f[0][0, 0] for f in item["frames"]])
            taken.append(item)
            up.release(item)
            time.sleep(0.001)
        rest = up.drain_and_stop()
    finally:
        sys.setswitchinterval(keep)
    assert not up._t.is_alive()
    got = [int(f[0][0, 0]) for item in taken + rest for f in item["frames"]]
    assert got == list(range(len(got))) and len(got) >= 140
    assert all(int(f[1][0, 0]) == -int(f[0][0, 0]) for item in taken + rest
               for f in item["frames"])


@pytest.mark.slow
def test_fast_shrink_replay_decisions_match_classic(monkeypatch):
    """The port of tests/test_shrink_replay.py: the bench street workload
    through the device-resident loop (21 warm-up frames at batch 20, then
    chunks of 60), the classic replay forced on every miss and then the
    fast path: the same decisions, poses within 1e-3, and the fast path
    and the demotion fired."""
    from srba_slam_tpu_torch.models.estimator import bench_estimator
    from srba_slam_tpu_torch.utils import bench_workload as bw

    cam = StereoCamera.kitti()
    frames = list(SyntheticSource(cam, **bw.SOURCE))
    warm = 21

    def run():
        est = bench_estimator("cpu")
        est.perform_stereo_slam_batched(frames[:warm], batch=20)
        est.rba.flush()
        rest = frames[warm:]
        chunks = [(torch.from_numpy(np.stack([f[0] for f in rest[c:c + 60]])),
                   torch.from_numpy(np.stack([f[1] for f in rest[c:c + 60]])))
                  for c in range(0, len(rest), 60)]
        est.perform_stereo_slam_device(chunks)
        est.rba.flush()
        return est

    cls = test_mod.SRBAStereoSLAMEstimator
    counts = {"fast": 0, "classic": 0, "demoted": 0}
    monkeypatch.setattr(cls, "_shrink_tail_ok", lambda self, c, d: False)
    classic = run()
    monkeypatch.undo()
    run_miss, run_dem = cls._miss_recover, cls._demote_shrink_miss

    def spy_miss(self, c, d):
        before = self._replay_flag
        out = run_miss(self, c, d)
        counts["classic" if self._replay_flag and not before else "fast"] += 1
        return out

    def spy_dem(self, c, d):
        out = run_dem(self, c, d)
        counts["demoted"] += int(out)
        return out

    monkeypatch.setattr(cls, "_miss_recover", spy_miss)
    monkeypatch.setattr(cls, "_demote_shrink_miss", spy_dem)
    fast = run()
    assert [r.frame_idx for r in fast.step_log if r.inserted_kf] \
        == [r.frame_idx for r in classic.step_log if r.inserted_kf]
    assert [r.frame_idx for r in fast.step_log if r.kf_check] \
        == [r.frame_idx for r in classic.step_log if r.kf_check]
    assert decisions(fast.step_log) == bw.load_fingerprint()["decisions"]
    n = fast.store.n_kfs
    dpos = np.max(np.linalg.norm(fast.rba.kf_global[:n, 3:] - classic.rba.kf_global[:n, 3:],
                                 axis=1))
    assert dpos < 1e-3, dpos
    assert counts["fast"] >= 1 and counts["demoted"] >= 1, counts
