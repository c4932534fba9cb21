"""The batched VO scan and the per-image thresholds of K1 and K3, on the CPU.

Small camera (160x96, tests/test_parallel.py's), frames rendered with seed
11, capacity 128; JAX runs with its XLA formulation (``use_pallas`` off).

* ``vo_scan`` of the port against the JAX package's over B = 4 frames,
  chained from frame 0's JAX features (the carried ``prev``) and a nonzero
  initial increment; once plain, once with ``rect_maps``. Both packages blur
  with the JAX package's ``gauss_blur7`` and remap with its
  ``remap_bilinear`` here (the port's own differ in the last bit at a few
  pixels, tests/test_torch_orb.py, tests/test_torch_rectify.py). Every
  integer output identical (the stacked FrameFeatures' keypoints,
  descriptor words, matches and masks; track indices and masks; pose
  validity and inlier counts); poses within 1e-4, mean residuals within
  1e-3 px.
  The port's thresholds once as Python numbers and once as tensors (the
  estimator's scan passes them so: on a card they are its graph's inputs).
* The port's ``vo_scan`` against the port's own per-frame
  ``extract_and_match`` + ``track_and_solve``: every output ``torch.equal``.
* The scan with ``Tensor.item``, ``tolist``, ``cpu``, ``numpy``,
  ``__bool__``, ``__int__`` and ``__float__`` made to raise, under
  ``no_exit_reads`` as the estimator runs it, plain and with every frontend
  option: the same outputs, so it reads nothing on the host (a capture on
  the card would refuse a read; tests/test_torch_cuda.py holds the graph to
  the eager scan there). ``scan_key``: another shape, dtype, camera or
  option, or another GN block route, gives another key.
* K1 (``fast_nms``, NMS radii 0-5) and K3 (``fast_score_map``) with one
  threshold per image against the JAX package's per-image ``vmap``: equal
  score maps (the plain versions run here; tests/test_torch_cuda.py holds
  the kernels to them on the card). K1 at radii 0 and 5, the ends of the
  range the JAX package's ``fast_nms_pallas`` takes, against that kernel in
  interpret mode.
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
from srba_slam_tpu.ops.fast import fast_score_map as jfast_score_map
from srba_slam_tpu.ops.nms import local_max_suppress as jlocal_max_suppress
from srba_slam_tpu.ops.orb import gauss_blur7 as jblur
from srba_slam_tpu.ops.pallas_fast import fast_nms_pallas
from srba_slam_tpu.utils.camera import StereoCamera as JCam
from srba_slam_tpu_torch.models import vo
from srba_slam_tpu_torch.models.vo import frame_features_from_numpy
from srba_slam_tpu_torch.ops import cuda_graphs, hopper_fast, orb, rectify, robust_lm
from srba_slam_tpu_torch.utils.camera import StereoCamera
from srba_slam_tpu_torch.utils.framesource import SyntheticSource

torch.set_num_threads(1)

CAM = dict(fx_l=90.0, fy_l=90.0, cx_l=80.0, cy_l=48.0, fx_r=90.0, fy_r=90.0, cx_r=80.0,
           cy_r=48.0, baseline=0.5, width=160, height=96)
K = 128
B = 4
INIT = np.array([1e-3, -2e-3, 5e-4, 1e-2, 0.0, 5e-2], np.float32)
DIST = [-0.28, 0.07, 2e-4, 2e-5, 0.0]
INT_FIELDS = ("ys_l", "xs_l", "valid_l", "desc_l", "ys_r", "xs_r", "valid_r", "desc_r",
              "m_r_idx", "m_valid", "octave")


@pytest.fixture(scope="module")
def frames():
    return list(SyntheticSource(StereoCamera(**CAM), n_frames=B + 1, seed=11, step=0.12))


def _jax_blur(img: torch.Tensor) -> torch.Tensor:
    fn = jblur
    for _ in range(img.dim() - 2):
        fn = jax.vmap(fn)
    return torch.from_numpy(np.array(fn(jnp.asarray(img.numpy(), jnp.float32))))


def _jax_remap(img: torch.Tensor, maps) -> torch.Tensor:
    jm = jrectify.RectifyMaps(jnp.asarray(maps.map_y.numpy()), jnp.asarray(maps.map_x.numpy()))
    fn = lambda im: jrectify.remap_bilinear(im, jm)  # noqa: E731
    for _ in range(img.dim() - 2):
        fn = jax.vmap(fn)
    return torch.from_numpy(np.array(fn(jnp.asarray(img.numpy(), jnp.float32))))


def _maps(mod, **kw):
    c = CAM
    return tuple(mod.build_maps(c["width"], c["height"], c[f"fx_{e}"], c[f"fy_{e}"],
                                c[f"cx_{e}"], c[f"cy_{e}"], dist=DIST, **kw) for e in "lr")


def _scans(frames, with_maps: bool, tensors: bool = False):
    """(port outputs, JAX outputs on the host) of one scan over frames 1..B;
    the port's thresholds as tensors with ``tensors`` (FAST one per frame,
    ORB one value)."""
    lefts = np.stack([f[0] for f in frames[1:]])
    rights = np.stack([f[1] for f in frames[1:]])
    jkw = dict(rect_maps=_maps(jrectify)) if with_maps else {}
    tkw = dict(rect_maps=_maps(rectify, device="cpu")) if with_maps else {}
    jprev = jvo.extract_and_match(jnp.asarray(frames[0][0]), jnp.asarray(frames[0][1]),
                                  JCam(**CAM), jnp.float32(12.0), jnp.int32(60), k=K, **jkw)
    jout = jax.device_get(jvo.vo_scan(jnp.asarray(lefts), jnp.asarray(rights), jprev,
                                      jnp.asarray(INIT), JCam(**CAM), 12.0, 60, k=K, **jkw))
    prev = frame_features_from_numpy(jax.device_get(jprev), "cpu")
    ths = (torch.full((B,), 12.0), torch.tensor(60.0)) if tensors else (12.0, 60)
    tout = vo.vo_scan(lefts, rights, prev, torch.from_numpy(INIT), StereoCamera(**CAM), *ths,
                      k=K, device="cpu", **tkw)
    return tout, jout


@pytest.fixture(scope="module")
def shared_ops():
    """Both packages blur and remap with the JAX package's functions."""
    mp = pytest.MonkeyPatch()
    mp.setattr(orb, "gauss_blur7", _jax_blur)
    mp.setattr(hopper_fast, "gauss_blur7", _jax_blur)
    mp.setattr(vo, "remap_bilinear", _jax_remap)
    yield
    mp.undo()


@pytest.mark.parametrize("thresholds", ["numbers", "tensors"])
@pytest.mark.parametrize("with_maps", [False, True], ids=["plain", "rect_maps"])
def test_vo_scan_matches_jax(frames, shared_ops, with_maps, thresholds):
    (t_last, t_inc, t_outs), (j_last, j_inc, j_outs) = _scans(frames, with_maps,
                                                              thresholds == "tensors")
    t_curs, j_curs = t_outs[0], j_outs[0]
    for name in INT_FIELDS:
        a, b = getattr(t_curs, name).numpy(), np.asarray(getattr(j_curs, name))
        np.testing.assert_array_equal(a, b.view(np.int32) if b.dtype == np.uint32 else b,
                                      err_msg=name)
        np.testing.assert_array_equal(getattr(t_last, name).numpy(),
                                      a[-1], err_msg=f"last {name}")
    assert t_curs.m_valid.shape == (B, K) and int(t_curs.m_valid.sum()) > 100 * B
    np.testing.assert_allclose(t_curs.pts3d.numpy(), j_curs.pts3d, rtol=1e-5, atol=1e-5)
    # track_idx, track_valid, pose_valid, num_inliers exactly
    for i in (1, 2, 4, 5):
        np.testing.assert_array_equal(t_outs[i].numpy(), np.asarray(j_outs[i]), err_msg=str(i))
    assert bool(t_outs[4].all()) and int(t_outs[2].sum()) > 50 * B
    np.testing.assert_allclose(t_outs[3].numpy(), j_outs[3], atol=1e-4)
    np.testing.assert_allclose(t_inc.numpy(), j_inc, atol=1e-4)
    np.testing.assert_allclose(t_outs[6].numpy(), j_outs[6], atol=1e-3)


def test_vo_scan_equals_per_frame_stepping(frames):
    cam = StereoCamera(**CAM)
    prev = vo.extract_and_match(*frames[0], cam, 12.0, 60, k=K, device="cpu")
    lefts = np.stack([f[0] for f in frames[1:]])
    rights = np.stack([f[1] for f in frames[1:]])
    last, inc, outs = vo.vo_scan(lefts, rights, prev, torch.from_numpy(INIT), cam, 12.0, 60,
                                 k=K, device="cpu")
    feat, last_inc = prev, torch.from_numpy(INIT)
    for j, (left, right) in enumerate(frames[1:]):
        cur = vo.extract_and_match(left, right, cam, 12.0, 60, k=K, device="cpu")
        out = vo.track_and_solve(feat, cur, cam, last_inc, 60)
        for a, b in zip(cur, outs[0]):
            assert torch.equal(a, b[j])
        for a, b in zip((out.track_idx, out.track_valid, out.pose.pose, out.pose.valid,
                         out.pose.num_inliers, out.pose.mean_residual), outs[1:]):
            assert torch.equal(a, b[j])
        last_inc = torch.where(out.pose.valid, out.pose.pose, last_inc)
        feat = cur
    assert torch.equal(inc, last_inc)
    assert all(torch.equal(a, b) for a, b in zip(last, feat))


_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__")
# the port's own blur and remap (the module's shared_ops fixture, once set
# up, stays for the module)
_PORT_OPS = ((orb, "gauss_blur7", orb.gauss_blur7), (hopper_fast, "gauss_blur7", orb.gauss_blur7),
             (vo, "remap_bilinear", vo.remap_bilinear))


@pytest.mark.parametrize("options", ["plain", "every_option"])
def test_vo_scan_reads_nothing_on_the_host(frames, monkeypatch, options):
    for mod, name, fn in _PORT_OPS:
        monkeypatch.setattr(mod, name, fn)
    cam = StereoCamera(**CAM)
    kw, solve = dict(k=K, device="cpu"), {}
    if options == "every_option":
        kw.update(n_levels=2, oriented=True, margin=3, robust_1to1=True,
                  rect_maps=_maps(rectify, device="cpu"))
        solve = dict(filter_fund_matrix=True)
    prev = vo.extract_and_match(*frames[0], cam, 12.0, 60, **kw)
    kw.update(solve)
    args = (torch.from_numpy(np.stack([f[0] for f in frames[1:]])),
            torch.from_numpy(np.stack([f[1] for f in frames[1:]])), prev,
            torch.from_numpy(INIT), cam, torch.full((B,), 12.0), torch.tensor(60.0))
    with cuda_graphs.no_exit_reads():
        ref = vo.vo_scan(*args, **kw)

    def refuse(name):
        def read(*a, **k):
            raise AssertionError(f"the scan read a tensor on the host: Tensor.{name}")
        return read

    for name in _READS:
        monkeypatch.setattr(torch.Tensor, name, refuse(name))
    with cuda_graphs.no_exit_reads():
        got = vo.vo_scan(*args, **kw)
    monkeypatch.undo()
    ref_leaves, ref_spec = pytree.tree_flatten(ref)
    got_leaves, got_spec = pytree.tree_flatten(got)
    assert got_spec == ref_spec and len(got_leaves) == 13 + 1 + 13 + 6
    assert all(torch.equal(a, b) for a, b in zip(got_leaves, ref_leaves))
    assert int(got[2][0].m_valid.sum()) > 50 * B


def test_scan_key_separates_shapes_and_options(monkeypatch):
    """Every option of ``vo_scan`` but the inputs reaches ``scan_key``: one
    changed (or the frames' batch, height, width or dtype, the camera, the
    maps' presence, the GN block length or route) gives another key, and
    the same call the same key."""
    cam = StereoCamera(**CAM)
    inputs = {"lefts", "rights", "prev", "init_pose", "cam", "fast_th", "orb_th", "rect_maps",
              "device"}
    opts = {name: p.default for name, p in inspect.signature(vo.vo_scan).parameters.items()
            if name not in inputs}
    assert {"k", "margin", "oriented", "n_levels", "max_iters", "filter_fund_matrix"} <= set(opts)
    frames = torch.zeros((B, 96, 160), dtype=torch.uint8)
    base = vo.scan_key(frames, cam, None, **opts)
    assert vo.scan_key(frames.clone(), StereoCamera(**CAM), None, **dict(opts)) == base
    keys = [base]
    for name, v in opts.items():
        changed = (not v) if isinstance(v, bool) else v + 1
        keys.append(vo.scan_key(frames, cam, None, **{**opts, name: changed}))
    for other in (torch.zeros((B + 1, 96, 160), dtype=torch.uint8),
                  torch.zeros((B, 97, 160), dtype=torch.uint8),
                  torch.zeros((B, 96, 161), dtype=torch.uint8),
                  torch.zeros((B, 96, 160), dtype=torch.float32)):
        keys.append(vo.scan_key(other, cam, None, **opts))
    keys.append(vo.scan_key(frames, cam, _maps(rectify, device="cpu"), **opts))
    keys.append(vo.scan_key(frames, StereoCamera(**{**CAM, "baseline": 0.6}), None, **opts))
    monkeypatch.setattr(robust_lm, "GN_EXIT_EVERY", robust_lm.GN_EXIT_EVERY + 1)
    keys.append(vo.scan_key(frames, cam, None, **opts))
    monkeypatch.setattr(robust_lm, "GN_GRAPHS", not robust_lm.GN_GRAPHS)
    keys.append(vo.scan_key(frames, cam, None, **opts))
    assert len(set(keys)) == len(keys)


def _images(seed: int):
    rng = np.random.default_rng(seed)
    frames = list(SyntheticSource(StereoCamera(**CAM), n_frames=2, seed=11, step=0.12))
    u8 = np.stack([frames[0][0], frames[0][1], frames[1][0], frames[1][1]])
    plateau = rng.integers(0, 8, (4, 96, 160)).astype(np.float32) * 30.0
    return u8, plateau


@pytest.mark.parametrize("radius", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("kind", ["u8", "plateau"])
def test_fast_nms_per_image_thresholds_match_jax(kind, radius):
    u8, plateau = _images(radius)
    imgs = u8 if kind == "u8" else plateau
    ths = np.array([8.0, 12.5, 20.0, 31.0], np.float32)
    margin = 3 + radius + 2
    ref = jax.vmap(lambda im, t: jlocal_max_suppress(
        jfast_score_map(im, t, margin=margin), radius=radius))(
        jnp.asarray(imgs, jnp.float32), jnp.asarray(ths))
    got = hopper_fast.fast_nms(torch.from_numpy(imgs), torch.from_numpy(ths), margin=margin,
                               radius=radius)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # image i at its own threshold equals a batch of one at that float
    for i, th in enumerate(ths):
        one = hopper_fast.fast_nms(torch.from_numpy(imgs[i:i + 1]), float(th), margin=margin,
                                   radius=radius)
        assert torch.equal(one[0], got[i])
    assert len({int((got[i] > 0).sum()) for i in range(4)}) > 1


@pytest.mark.parametrize("radius", [0, 5])
def test_fast_nms_edge_radii_match_pallas_interpret(radius):
    """The least and the largest NMS radius of the JAX TPU kernel (its
    8-row band halo holds the circle and a window of up to 5), at the least
    margin 3 + radius and at 16: the port's K1 wrapper equals the kernel."""
    _, plateau = _images(radius)
    for margin in (3 + radius, 16):
        ref = fast_nms_pallas(jnp.asarray(plateau), 30.0, margin=margin, radius=radius,
                              tile_h=32, interpret=True)
        got = hopper_fast.fast_nms(torch.from_numpy(plateau), 30.0, margin=margin,
                                   radius=radius)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert (got > 0).sum() > 50


@pytest.mark.parametrize("margin", [0, 3, 16])
def test_fast_score_map_per_image_thresholds_match_jax(margin):
    u8, plateau = _images(7)
    ths = np.array([5.0, 12.0, 20.0, 40.0], np.float32)
    for imgs in (u8, plateau):
        ref = jax.vmap(lambda im, t: jfast_score_map(im, t, margin=margin))(
            jnp.asarray(imgs, jnp.float32), jnp.asarray(ths))
        got = hopper_fast.fast_score_map(torch.from_numpy(imgs), torch.from_numpy(ths),
                                         margin=margin)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    one = hopper_fast.fast_score_map(torch.from_numpy(u8[0]), torch.tensor([12.0]), margin=margin)
    assert torch.equal(one, hopper_fast.fast_score_map(torch.from_numpy(u8[0]), 12.0,
                                                       margin=margin))


def test_threshold_tensor_is_checked():
    imgs = torch.zeros((2, 40, 40), dtype=torch.uint8)
    with pytest.raises(ValueError, match="2 images"):
        hopper_fast.fast_nms(imgs, torch.tensor([1.0, 2.0, 3.0]))
    with pytest.raises(TypeError):
        hopper_fast.fast_score_map(imgs, torch.tensor([1, 2]))
    with pytest.raises(ValueError, match="NMS radius 6"):
        hopper_fast.fast_nms(imgs, 10.0, margin=16, radius=6)
    with pytest.raises(ValueError, match="NMS radius -1"):
        hopper_fast.fast_nms(imgs, 10.0, margin=16, radius=-1)


def test_radius_beyond_k1_takes_the_score_map_route(frames, monkeypatch):
    """A radius whose NMS window reaches beyond the margin (margin under
    3 + radius) goes to K3 and a separate suppression, as in the JAX
    package; at a margin that holds it K1 takes every radius of the JAX
    kernel, 0-5, and refuses a larger one rather than change routes."""
    calls = []
    for name in ("fast_nms", "fast_score_map"):
        fn = getattr(vo, name)
        monkeypatch.setattr(vo, name, lambda *a, _fn=fn, _n=name, **k: (calls.append(_n),
                                                                       _fn(*a, **k))[1])
    cam = StereoCamera(**CAM)
    for radius, margin, want in ((0, 16, "fast_nms"), (2, 16, "fast_nms"), (5, 16, "fast_nms"),
                                 (5, 8, "fast_nms"), (5, 7, "fast_score_map"),
                                 (2, 4, "fast_score_map")):
        calls.clear()
        vo.extract_and_match(*frames[0], cam, 12.0, 60, k=K, nms_radius=radius, margin=margin,
                             device="cpu")
        assert calls == [want], (radius, margin, calls)
    with pytest.raises(ValueError, match="NMS radius 6"):
        vo.extract_and_match(*frames[0], cam, 12.0, 60, k=K, nms_radius=6, device="cpu")


def test_float_threshold_inside_a_program_raises(monkeypatch):
    """The kernels' threshold argument: a float outside a captured program
    (passed on as the batch's value), a tensor anywhere (its address), and
    a float inside a program's warm-up or capture raises: it would stay in
    the graph, and a replay at another threshold would use it."""
    cpu = torch.device("cpu")
    th = torch.full((2,), 20.0)
    assert hopper_fast._thresholds(20.0, 2, cpu) == (20.0, 0)
    monkeypatch.setattr(cuda_graphs, "_BODIES", {})
    assert cuda_graphs.in_program()
    assert hopper_fast._thresholds(th, 2, cpu) == (0.0, th.data_ptr())
    with pytest.raises(TypeError, match="float threshold"):
        hopper_fast._thresholds(20.0, 2, cpu)
