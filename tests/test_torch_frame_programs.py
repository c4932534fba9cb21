"""The per-frame programs' bodies against the JAX package, on the CPU.

On a card a frame's ``extract_and_match`` is one replay of the frame
program and its tracking one of the track program (``models/vo.py``
``FRAME_PROGRAMS``, one per ``frame_key`` / ``track_key``), the thresholds
and the initial increments their device inputs. Here the same bodies run
eagerly (tests/test_torch_cuda.py holds the programs to the eager route on
the card). Small camera (160x96, tests/test_torch_vo_scan.py's), frames
rendered with seed 11, capacity 128; both packages blur and remap with the
JAX package's functions, so everything downstream compares bit for bit.

* The frame body (``extract_and_match`` with its thresholds as f32
  tensors, as the program takes them) against JAX's ``extract_and_match``
  at the same values: plain at the thresholds an adaptive retry and a
  drift move to (FAST 22 -> 12 -> 5, ORB 60 -> 70, then 17 / 65), and at
  FAST 12 / ORB 60 with ``n_levels=2``, ``margin=3``, ``robust_1to1``,
  ``rect_maps`` and all of them at once. Every integer field identical,
  ``pts3d`` and the scores within 1e-5. ``oriented=True`` (alone and with
  the others): keypoints identical, descriptor rows that differ under 2%
  (the angle's last bit, tests/test_torch_vo_options.py).
* The track body (``track_frame``, and ``solve_tracks``' packed words read
  on the host) against JAX's ``track_and_solve`` on JAX's features of
  frames 0 and 1, from a nonzero increment, at ORB 60 and 70, with and
  without ``filter_fund_matrix``: track indices and masks, pose validity,
  inlier and iteration counts identical; poses within 1e-5, mean residuals
  within 1e-4 px.
* Both bodies with ``Tensor.item``, ``tolist``, ``cpu``, ``numpy``,
  ``__bool__``, ``__int__`` and ``__float__`` made to raise, under
  ``no_exit_reads`` as in a capture: the same outputs, so neither reads the
  host.
* ``frame_key`` and ``track_key``: another shape, dtype, camera or option
  gives another key; inputs that differ only in their thresholds or
  increments give the same program key (no threshold is in a key).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from srba_slam_tpu.models import vo as jvo
from srba_slam_tpu.ops import rectify as jrectify
from srba_slam_tpu.utils.camera import StereoCamera as JCam
from srba_slam_tpu_torch import VOOptions
from srba_slam_tpu_torch.models import vo
from srba_slam_tpu_torch.models.vo import frame_features_from_numpy
from srba_slam_tpu_torch.ops import cuda_graphs, hopper_fast, orb, rectify, robust_lm
from srba_slam_tpu_torch.utils.camera import StereoCamera
from srba_slam_tpu_torch.utils.framesource import SyntheticSource

from test_torch_vo_scan import CAM, INIT, INT_FIELDS, K, _jax_blur, _jax_remap, _maps

torch.set_num_threads(1)

POSE_TOL = 1e-5
KEYPOINT_FIELDS = ("ys_l", "xs_l", "valid_l", "ys_r", "xs_r", "valid_r", "octave")
_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__")
# FAST / ORB thresholds: the start, an adaptive retry's two moves (FAST -10
# to its floor of 5, then ORB +10) and a drift (FAST +5 from 12, ORB +5)
THRESHOLDS = [(22.0, 60), (12.0, 60), (5.0, 70), (17.0, 65)]
OPTIONS = {
    "n_levels2": dict(n_levels=2), "margin3": dict(margin=3),
    "robust_1to1": dict(robust_1to1=True), "rect_maps": dict(rect_maps=True),
    "oriented": dict(oriented=True),
    "every_option": dict(n_levels=2, margin=3, robust_1to1=True, rect_maps=True,
                         oriented=True),
}


@pytest.fixture(scope="module")
def frames():
    return list(SyntheticSource(StereoCamera(**CAM), n_frames=2, seed=11, step=0.12))


@pytest.fixture
def shared_ops(monkeypatch):
    """Both packages blur and remap with the JAX package's functions."""
    monkeypatch.setattr(orb, "gauss_blur7", _jax_blur)
    monkeypatch.setattr(hopper_fast, "gauss_blur7", _jax_blur)
    monkeypatch.setattr(vo, "remap_bilinear", _jax_remap)


def _frontends(pair, fast, orb_th, **kw):
    """(the port's frame body at tensor thresholds, JAX's extract_and_match
    on the host) of one pair."""
    maps = kw.pop("rect_maps", False)
    jkw = dict(kw, rect_maps=_maps(jrectify)) if maps else kw
    tkw = dict(kw, rect_maps=_maps(rectify, device="cpu")) if maps else kw
    ref = jvo.extract_and_match(jnp.asarray(pair[0]), jnp.asarray(pair[1]), JCam(**CAM),
                                jnp.float32(fast), jnp.int32(orb_th), k=K, **jkw)
    got = vo.extract_and_match(pair[0], pair[1], StereoCamera(**CAM), torch.tensor(fast),
                               torch.tensor(float(orb_th)), k=K, device="cpu", **tkw)
    return got, jax.device_get(ref)


def _assert_frame_equal(got, ref, oriented: bool = False):
    for name in (KEYPOINT_FIELDS if oriented else INT_FIELDS):
        b = np.asarray(getattr(ref, name))
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      b.view(np.int32) if b.dtype == np.uint32 else b,
                                      err_msg=name)
    np.testing.assert_allclose(got.score_l.numpy(), np.asarray(ref.score_l), atol=1e-5)
    if oriented:
        for name in ("desc_l", "desc_r"):
            a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name)).view(np.int32)
            assert (a != b).any(axis=-1).mean() < 0.02, name
        return
    np.testing.assert_allclose(got.pts3d.numpy(), np.asarray(ref.pts3d), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fast,orb_th", THRESHOLDS, ids=["start", "retry_fast", "retry_orb",
                                                         "drift"])
def test_frame_body_matches_jax_at_moved_thresholds(frames, shared_ops, fast, orb_th):
    got, ref = _frontends(frames[1], fast, orb_th)
    _assert_frame_equal(got, ref)
    assert int(got.m_valid.sum()) > 30


@pytest.mark.parametrize("name", list(OPTIONS))
def test_frame_body_matches_jax_with_options(frames, shared_ops, name):
    kw = dict(OPTIONS[name])
    got, ref = _frontends(frames[1], 12.0, 60, **kw)
    _assert_frame_equal(got, ref, oriented=kw.get("oriented", False))
    assert int(got.m_valid.sum()) > 30
    if kw.get("n_levels", 1) > 1:
        assert bool((got.m_valid & (got.octave > 0)).any())


def _jax_prev(frames):
    return jax.device_get(jvo.extract_and_match(
        jnp.asarray(frames[0][0]), jnp.asarray(frames[0][1]), JCam(**CAM), jnp.float32(12.0),
        jnp.int32(60), k=K))


def _jax_cur(frames):
    return jax.device_get(jvo.extract_and_match(
        jnp.asarray(frames[1][0]), jnp.asarray(frames[1][1]), JCam(**CAM), jnp.float32(12.0),
        jnp.int32(60), k=K))


def _assert_track_equal(got: list, ref):
    """``got``: track_idx, track_valid, pose, valid, num_inliers, iters,
    mean_residual (numpy)."""
    ti, tv, pose, ok, n_in, iters, res = got
    np.testing.assert_array_equal(ti, np.asarray(ref.track_idx))
    np.testing.assert_array_equal(tv, np.asarray(ref.track_valid))
    assert bool(ok) == bool(ref.pose.valid) and bool(ok)
    assert int(n_in) == int(ref.pose.num_inliers) and int(iters) == int(ref.pose.iters)
    np.testing.assert_allclose(pose, np.asarray(ref.pose.pose), atol=POSE_TOL)
    np.testing.assert_allclose(res, np.asarray(ref.pose.mean_residual), atol=1e-4)


@pytest.mark.parametrize("orb_th", [60, 70])
@pytest.mark.parametrize("fund", [False, True], ids=["plain", "filter_fund_matrix"])
def test_track_body_matches_jax(frames, orb_th, fund):
    eng = vo.StereoVOEngine(StereoCamera(**CAM), VOOptions(fast_th=12, n_feats=K,
                                                           filter_fund_matrix=fund),
                            capacity=K, device="cpu")
    solve = eng.solve_options()
    jp, jc = _jax_prev(frames), _jax_cur(frames)
    ref = jax.device_get(jvo.track_and_solve(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, jc), JCam(**CAM),
        jnp.asarray(INIT), jnp.int32(orb_th), **solve))
    prev, cur = frame_features_from_numpy(jp, "cpu"), frame_features_from_numpy(jc, "cpu")
    out = vo.track_frame(prev, cur, StereoCamera(**CAM), INIT, torch.tensor(float(orb_th)),
                         **solve)
    _assert_track_equal([out.track_idx.numpy(), out.track_valid.numpy(), out.pose.pose.numpy(),
                         out.pose.valid.numpy(), out.pose.num_inliers.numpy(),
                         out.pose.iters.numpy(), out.pose.mean_residual.numpy()], ref)
    assert int(out.track_valid.sum()) > 20

    # solve_tracks: the engine's increment and ORB threshold in one upload,
    # the outputs packed into words in the body and read on the host once
    eng._prev, eng._last_pose_inc, eng.orb_th = prev, INIT.copy(), float(orb_th)
    ti, tv, mv, pose, ok, res, iters = vo.solve_tracks([eng], [cur])
    _assert_track_equal([ti[0], tv[0], pose[0], ok[0], ref.pose.num_inliers, iters[0], res[0]],
                        ref)
    np.testing.assert_array_equal(mv[0], np.asarray(jc.m_valid))


def _refuse_reads(monkeypatch):
    def refuse(name):
        def read(*a, **k):
            raise AssertionError(f"a body read a tensor on the host: Tensor.{name}")
        return read

    for name in _READS:
        monkeypatch.setattr(torch.Tensor, name, refuse(name))


@pytest.mark.parametrize("options", ["plain", "every_option"])
def test_frame_and_track_bodies_read_nothing_on_the_host(frames, monkeypatch, options):
    cam = StereoCamera(**CAM)
    kw = dict(OPTIONS["every_option"]) if options == "every_option" else {}
    maps = kw.pop("rect_maps", False)
    opts = dict(k=K, cell=5, nms_radius=2, margin=16, max_y_diff=2.0, min_disparity=0.1,
                max_disparity=1e9, oriented=False, n_levels=1, robust_1to1=False)
    opts.update(kw)
    solve = dict(filter_fund_matrix=options == "every_option")
    held = dict(rect_maps=_maps(rectify, device="cpu")) if maps else {}
    xs = [dict(vo._frame_inputs(f[0], f[1], 12.0, 60, torch.device("cpu")), **held)
          for f in frames]
    with cuda_graphs.no_exit_reads():
        prev, cur = (vo._frame_body(x, cam, opts) for x in xs)
        t = vo._track_inputs([prev], [cur], INIT[None], [60.0], "cpu")
        ref = (cur, vo._track_body(t, cam, solve, True), vo._track_body(t, cam, solve, False))
    _refuse_reads(monkeypatch)
    with cuda_graphs.no_exit_reads():
        got = (vo._frame_body(xs[1], cam, opts), vo._track_body(t, cam, solve, True),
               vo._track_body(t, cam, solve, False))
    monkeypatch.undo()
    ref_leaves, got_leaves = pytree.tree_leaves(ref), pytree.tree_leaves(got)
    assert len(got_leaves) == len(ref_leaves) == 13 + 1 + 2 + 7
    assert all(torch.equal(a, b) for a, b in zip(got_leaves, ref_leaves))
    assert int(cur.m_valid.sum()) > 30 and bool(got[2].pose.valid.all())


def _frontend_defaults() -> dict:
    skip = {"left", "right", "cam", "fast_th", "orb_th", "rect_maps", "device"}
    params = inspect.signature(vo.extract_and_match).parameters
    return {name: p.default for name, p in params.items() if name not in skip}


def test_frame_key_separates_shapes_and_options_and_holds_no_threshold():
    """Every frontend option reaches ``frame_key``, and so do the frame's
    height, width and dtype, the camera and the maps' presence; two calls
    at other thresholds have the same program key."""
    cam = StereoCamera(**CAM)
    opts = _frontend_defaults()
    assert set(opts) == {"k", "cell", "nms_radius", "margin", "max_y_diff", "min_disparity",
                         "max_disparity", "oriented", "n_levels", "robust_1to1"}
    left = torch.zeros((96, 160), dtype=torch.uint8)
    base = vo.frame_key(left, cam, None, **opts)
    assert vo.frame_key(left.clone(), StereoCamera(**CAM), None, **dict(opts)) == base
    keys = [base]
    for name, v in opts.items():
        keys.append(vo.frame_key(left, cam, None,
                                 **{**opts, name: (not v) if isinstance(v, bool) else v + 1}))
    for other in (torch.zeros((97, 160), dtype=torch.uint8),
                  torch.zeros((96, 161), dtype=torch.uint8),
                  torch.zeros((96, 160), dtype=torch.float32)):
        keys.append(vo.frame_key(other, cam, None, **opts))
    keys.append(vo.frame_key(left, cam, _maps(rectify, device="cpu"), **opts))
    keys.append(vo.frame_key(left, StereoCamera(**{**CAM, "baseline": 0.6}), None, **opts))
    assert len(set(keys)) == len(keys)
    assert base[0] == "frame" and not any(isinstance(p, torch.Tensor) for p in base)

    pair = np.zeros((96, 160), np.uint8)
    a, b = (vo._frame_inputs(pair, pair, fast, orb_th, torch.device("cpu"))
            for fast, orb_th in ((22.0, 60), (5.0, 90)))
    assert not torch.equal(a["fast_th"], b["fast_th"])
    assert cuda_graphs.program_key(a, base) == cuda_graphs.program_key(b, base)


def test_track_key_separates_options_and_holds_no_threshold(frames, monkeypatch):
    cam = StereoCamera(**CAM)
    skip = {"prev", "cur", "cam", "initial_pose", "orb_th"}
    params = inspect.signature(vo.track_and_solve).parameters
    solve = {name: p.default for name, p in params.items() if name not in skip}
    assert {"max_iters_initial", "max_iters", "filter_fund_matrix", "kernel_param"} <= set(solve)
    base = vo.track_key(1, K, cam, True, **solve)
    assert vo.track_key(1, K, cam, True) == base       # the defaults filled in
    keys = [base, vo.track_key(2, K, cam, True, **solve), vo.track_key(1, K + 1, cam, True),
            vo.track_key(1, K, cam, False, **solve),
            vo.track_key(1, K, StereoCamera(**{**CAM, "fx_l": 91.0}), True, **solve)]
    for name, v in solve.items():
        keys.append(vo.track_key(1, K, cam, True,
                                 **{**solve, name: (not v) if isinstance(v, bool) else v + 1}))
    monkeypatch.setattr(robust_lm, "GN_EXIT_EVERY", robust_lm.GN_EXIT_EVERY + 1)
    keys.append(vo.track_key(1, K, cam, True, **solve))
    monkeypatch.setattr(robust_lm, "GN_GRAPHS", not robust_lm.GN_GRAPHS)
    keys.append(vo.track_key(1, K, cam, True, **solve))
    assert len(set(keys)) == len(keys)

    prev = frame_features_from_numpy(_jax_prev(frames), "cpu")
    a, b = (vo._track_inputs([prev], [prev], init, orb_th, "cpu")
            for init, orb_th in ((INIT[None], [60.0]), (np.zeros((1, 6), np.float32), [90.0])))
    assert cuda_graphs.program_key(a, base) == cuda_graphs.program_key(b, base)
