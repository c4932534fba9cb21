"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA card and skips without one. This file imports
no jax, so it runs where only torch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: none for the kernels, which are bit-exact against their plain
versions (on uint8 frames and on the f32, non-integer frames of pyramid
octaves and of a rectified rig), nor for the VO engine's integer results
and the estimator's keyframe decisions, which equal the CPU path's. Poses
and triangulated points agree within 1e-4 (the f32 solves sum in another
order on the card). Oriented descriptors, plain torch on both devices, may
differ in rows where a steering angle differs in its last bit: counted,
under 2%.
"""

import numpy as np
import pytest
import torch

from srba_slam_tpu_torch import (
    GeneralOptions, SRBAStereoSLAMEstimator, SRBAStereoSLAMOptions, StereoCamera,
    StereoVOEngine, VOOptions,
)
from srba_slam_tpu_torch.models.vo import _avgpool2, extract_and_match
from srba_slam_tpu_torch.ops import hopper_fast
from srba_slam_tpu_torch.ops.fast import fast_score_map as fast_score_map_plain
from srba_slam_tpu_torch.ops.nms import grid_topk, local_max_suppress
from srba_slam_tpu_torch.ops.rectify import build_maps, remap_bilinear
from srba_slam_tpu_torch.utils import bench_workload
from srba_slam_tpu_torch.utils.bench_workload import decisions
from srba_slam_tpu_torch.utils.framesource import SyntheticSource
from srba_slam_tpu_torch.utils.synthworld import PlaneScene

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_fast_nms_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(0)
    for shape, th in (((2, 200, 320), 12.0), ((3, 123, 300), 8.0)):
        imgs = torch.from_numpy(rng.integers(0, 8, shape) * 30).to(dtype).to(cuda)
        before = hopper_fast.fast_nms.launches
        got = hopper_fast.fast_nms(imgs, th)
        assert hopper_fast.fast_nms.launches == before + 1
        assert torch.equal(got, hopper_fast.fast_nms_plain(imgs, th))


def _k1_images(kind, shape, rng):
    n, h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "checkerboard":          # 0/255 pixels and 4x3 blocks: d = +-255
        board = np.stack([(yy + xx) % 2, (yy // 4 + xx // 3) % 2, (yy // 2 + xx) % 2][:n])
        return torch.from_numpy((board * 255).astype(np.uint8)), 20.0
    if kind == "binary":
        return torch.from_numpy((rng.integers(0, 2, shape) * 255).astype(np.uint8)), 100.0
    if kind == "plateau":               # scores are multiples of 30: score == th occurs
        return torch.from_numpy((rng.integers(0, 8, shape) * 30).astype(np.float32)), 30.0
    if kind == "u8":
        return torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8)), 12.0
    if kind == "u8_negative_th":        # negative scores are kept
        return torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8)), -3.0
    if kind == "f32":                   # not integers: the f32 route
        return torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32)), 12.0
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["checkerboard", "binary", "plateau", "u8", "u8_negative_th",
                                  "f32"])
@pytest.mark.parametrize("margin", [5, 16, 40])
@pytest.mark.parametrize("shape", [(1, 37, 41), (3, 123, 300), (2, 370, 1226)])
def test_fast_nms_kernel_cases(cuda, kind, margin, shape):
    """Shapes that are not multiples of the 124x32 tile, N = 1, 2, 3, every
    margin the wrapper takes from its least (3 + radius) up."""
    imgs, th = _k1_images(kind, shape, np.random.default_rng(margin))
    imgs = imgs.to(cuda)
    before = hopper_fast.fast_nms.launches
    got = hopper_fast.fast_nms(imgs, th, margin=margin)
    assert hopper_fast.fast_nms.launches == before + 1
    assert torch.equal(got, hopper_fast.fast_nms_plain(imgs, th, margin=margin))


def test_orb_kernel_matches_plain(cuda):
    rng = np.random.default_rng(1)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 123, 300)).astype(np.uint8)).to(cuda)
    ys, xs, _, valid = grid_topk(hopper_fast.fast_nms(imgs, 12.0), cell=5, k=300)
    got = hopper_fast.orb_descriptors(imgs, ys, xs, valid)
    assert torch.equal(got, hopper_fast.orb_descriptors_plain(imgs, ys, xs, valid))
    # keypoints near the borders: every sample is clipped the same way
    ys_edge = torch.from_numpy(rng.integers(0, 123, (2, 40)).astype(np.int32)).to(cuda)
    xs_edge = torch.from_numpy(rng.integers(0, 300, (2, 40)).astype(np.int32)).to(cuda)
    ok = torch.ones((2, 40), dtype=torch.bool, device=cuda)
    assert torch.equal(hopper_fast.orb_descriptors(imgs, ys_edge, xs_edge, ok),
                       hopper_fast.orb_descriptors_plain(imgs, ys_edge, xs_edge, ok))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("k", [1, 7, 512])
def test_fused_orb_kernel_cases(cuda, dtype, k):
    """The blur-fused K2 on uint8 and non-integer f32 frames: keypoints
    anywhere (border ones clip and blur at the clipped point), a fifth of
    the slots invalid."""
    rng = np.random.default_rng(k)
    n, h, w = 2, 150, 333
    imgs = torch.from_numpy(rng.integers(0, 256, (n, h, w)).astype(np.uint8))
    if dtype == torch.float32:
        imgs = imgs.to(dtype) + torch.from_numpy(rng.random((n, h, w)).astype(np.float32))
    imgs = imgs.to(cuda)
    ys = torch.from_numpy(rng.integers(0, h, (n, k)).astype(np.int32)).to(cuda)
    xs = torch.from_numpy(rng.integers(0, w, (n, k)).astype(np.int32)).to(cuda)
    valid = torch.from_numpy(rng.random((n, k)) < 0.8).to(cuda)
    before = hopper_fast.orb_descriptors.launches
    got = hopper_fast.orb_descriptors(imgs, ys, xs, valid)
    assert hopper_fast.orb_descriptors.launches == before + 1
    assert torch.equal(got, hopper_fast.orb_descriptors_plain(imgs, ys, xs, valid))
    assert not got[~valid].any()


def test_fused_orb_kernel_unaligned_storage(cuda):
    """A uint8 batch that starts 1 byte past a 4-byte boundary and does not
    end on one: the patch words at either end of the tensor are read byte
    by byte. Keypoints whose patches touch the first row of the first frame
    and the last row of the last frame, and random ones."""
    rng = np.random.default_rng(4)
    n, h, w = 2, 61, 97
    buf = torch.from_numpy(rng.integers(0, 256, n * h * w + 1).astype(np.uint8)).to(cuda)
    imgs = buf[1:].view(n, h, w)
    assert imgs.data_ptr() % 4 == 1 and (imgs.data_ptr() + imgs.numel()) % 4 != 0
    ys = rng.integers(0, h, (n, 16)).astype(np.int32)
    xs = rng.integers(0, w, (n, 16)).astype(np.int32)
    ys[0, :3], xs[0, :3] = 13, (13, 14, 15)
    ys[1, :3], xs[1, :3] = h - 14, (w - 14, w - 15, w - 16)
    ys, xs = torch.from_numpy(ys).to(cuda), torch.from_numpy(xs).to(cuda)
    valid = torch.ones((n, 16), dtype=torch.bool, device=cuda)
    assert torch.equal(hopper_fast.orb_descriptors(imgs, ys, xs, valid),
                       hopper_fast.orb_descriptors_plain(imgs, ys, xs, valid))


SMALL_CAM = dict(fx_l=180.0, fy_l=180.0, cx_l=160.0, cy_l=100.0, fx_r=180.0, fy_r=180.0,
                 cx_r=160.0, cy_r=100.0, baseline=0.54, width=320, height=200)


def _per_image(th: float, n: int, device) -> torch.Tensor:
    """n thresholds around ``th``: th/2, th, 3th/2, 2th, ... (on a plateau
    image the score meets each of them)."""
    return torch.tensor([th * (0.5 + 0.5 * i) for i in range(n)], dtype=torch.float32,
                        device=device)


@pytest.mark.parametrize("thresholds", ["scalar", "per_image"])
@pytest.mark.parametrize("kind", ["plateau", "u8", "f32"])
@pytest.mark.parametrize("shape", [(3, 123, 300), (4, 370, 1226)])
@pytest.mark.parametrize("radius", [0, 1, 2, 3, 4, 5])
def test_fast_nms_kernel_radii_and_thresholds(cuda, radius, shape, kind, thresholds):
    """Every NMS radius K1 is built for (its tile and halo follow the
    radius), at the least margin 3 + radius and at 16, with one threshold
    for the batch or one per image; an image at its own threshold equals a
    batch of one at that float."""
    imgs, th = _k1_images(kind, shape, np.random.default_rng(radius))
    imgs = imgs.to(cuda)
    thr = th if thresholds == "scalar" else _per_image(th, shape[0], cuda)
    for margin in (3 + radius, 16):
        before = hopper_fast.fast_nms.launches
        got = hopper_fast.fast_nms(imgs, thr, margin=margin, radius=radius)
        assert hopper_fast.fast_nms.launches == before + 1
        assert torch.equal(got, hopper_fast.fast_nms_plain(imgs, thr, margin=margin,
                                                           radius=radius))
        if thresholds == "per_image":
            for i in range(shape[0]):
                one = hopper_fast.fast_nms(imgs[i:i + 1], float(thr[i]), margin=margin,
                                           radius=radius)
                assert torch.equal(one[0], got[i])


@pytest.fixture(scope="module")
def street_pair():
    """Frame 0 of the bench workload's street scene, [2, 370, 1226] uint8."""
    left, right = next(iter(SyntheticSource(StereoCamera.kitti(), **bench_workload.SOURCE)))
    return torch.from_numpy(np.stack([left, right]))


def _k3_images(kind, shape, street, rng):
    """(uint8 images of ``shape``, threshold)."""
    n, h, w = (1, *shape) if len(shape) == 2 else shape
    if kind == "street":                # textured crops of the rendered pair
        frames = torch.cat([street, street.flip(-1)])[:n]
        y0, x0 = (370 - h) // 2, (1226 - w) // 3
        imgs, th = frames[:, y0:y0 + h, x0:x0 + w].numpy(), 20.0
    elif kind == "plateau":             # scores are multiples of 30: score == th occurs
        imgs, th = rng.integers(0, 8, (n, h, w)) * 30, 30.0
    elif kind == "noise":
        imgs, th = rng.integers(0, 256, (n, h, w)), 12.0
    elif kind == "negative_th":         # negative scores are kept
        imgs, th = rng.integers(0, 256, (n, h, w)), -3.0
    else:
        raise ValueError(kind)
    return torch.from_numpy(np.asarray(imgs, np.uint8).reshape(shape)), th


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("kind", ["street", "plateau", "noise", "negative_th"])
@pytest.mark.parametrize("margin", [0, 1, 2, 3, 4, 16, "over_half"])
@pytest.mark.parametrize("shape", [(9, 140), (123, 300), (1, 61, 257), (2, 370, 1226),
                                   (3, 123, 300)])
@pytest.mark.parametrize("offset", [0, 1])
def test_fast_score_kernel_matches_plain(cuda, street_pair, dtype, kind, margin, shape, offset):
    """K3 on both routes (uint8 in DPX, f32), shapes that are no multiple of
    the 32x128 tile and one smaller than a tile, the least margins (under 3
    the circle wraps at the borders, as the plain version rolls the image),
    one past half the image (an all-zero map), and with ``offset`` 1 a batch whose
    storage starts one element past an aligned address. f32 frames of noise
    carry a fraction."""
    rng = np.random.default_rng(len(shape) * 100 + offset)
    imgs, th = _k3_images(kind, shape, street_pair, rng)
    if dtype == torch.float32:
        imgs = imgs.float()
        if kind in ("noise", "negative_th"):
            imgs += torch.from_numpy(rng.random(shape).astype(np.float32))
    if margin == "over_half":
        margin = min(shape[-2:]) // 2 + 1
    buf = torch.zeros(imgs.numel() + offset, dtype=dtype, device=cuda)
    buf[offset:] = imgs.flatten().to(cuda)
    imgs = buf[offset:].view(shape)
    before = hopper_fast.fast_score_map.launches
    got = hopper_fast.fast_score_map(imgs, th, margin=margin)
    assert hopper_fast.fast_score_map.launches == before + 1
    assert got.shape == imgs.shape and got.dtype == torch.float32
    ref = fast_score_map_plain(imgs, th, margin=margin)
    assert torch.equal(got, ref)
    if 2 * margin >= min(shape[-2:]):
        assert not ref.any()


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("kind", ["street", "plateau", "noise"])
@pytest.mark.parametrize("margin", [0, 2, 3, 16])
@pytest.mark.parametrize("shape", [(3, 123, 300), (4, 370, 1226)])
def test_fast_score_kernel_per_image_thresholds(cuda, street_pair, dtype, kind, margin, shape):
    """K3 with one threshold per image, on both routes and at margins
    where the halo wraps and where it does not."""
    imgs, th = _k3_images(kind, shape, street_pair, np.random.default_rng(margin))
    imgs = imgs.to(dtype).to(cuda)
    thr = _per_image(th, shape[0], cuda)
    before = hopper_fast.fast_score_map.launches
    got = hopper_fast.fast_score_map(imgs, thr, margin=margin)
    assert hopper_fast.fast_score_map.launches == before + 1
    assert torch.equal(got, fast_score_map_plain(imgs, thr, margin=margin))
    for i in range(shape[0]):
        assert torch.equal(got[i], hopper_fast.fast_score_map(imgs[i], float(thr[i]),
                                                              margin=margin))


def test_vo_scan_cuda_matches_cpu(cuda):
    """The batched scan over 4 bench frames on the card against the CPU
    path: integer fields equal, poses within 1e-4 rad / 1e-3 m, one K1 and
    one K2 launch for the 8 images."""
    from srba_slam_tpu_torch.models.vo import vo_scan

    frames = list(SyntheticSource(StereoCamera.kitti(), **{**bench_workload.SOURCE,
                                                          "n_frames": 5}))
    lefts = np.stack([f[0] for f in frames[1:]])
    rights = np.stack([f[1] for f in frames[1:]])
    cam = StereoCamera.kitti()
    outs = {}
    for dev in (cuda, "cpu"):
        prev = extract_and_match(*frames[0], cam, 20.0, 60, k=512, device=dev)
        before = (hopper_fast.fast_nms.launches, hopper_fast.orb_descriptors.launches)
        outs[str(dev)] = vo_scan(lefts, rights, prev, torch.zeros(6, device=dev), cam, 20.0, 60,
                                 k=512, device=dev)
        after = (hopper_fast.fast_nms.launches, hopper_fast.orb_descriptors.launches)
        if dev is cuda:
            assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
    (_l, inc_c, oc), (_m, inc_h, oh) = outs["cuda"], outs["cpu"]
    for name in ("ys_l", "xs_l", "valid_l", "desc_l", "ys_r", "xs_r", "valid_r", "desc_r",
                 "m_r_idx", "m_valid"):
        assert torch.equal(getattr(oc[0], name).cpu(), getattr(oh[0], name)), name
    assert torch.equal(oc[4].cpu(), oh[4]) and bool(oh[4].all())
    d = (oc[3].cpu() - oh[3]).abs()
    assert float(d[:, :3].max()) <= 1e-4 and float(d[:, 3:].max()) <= 1e-3


@pytest.mark.parametrize("n_lanes", [1, 5])
def test_solve_pose_graph_blocks_match_eager(cuda, monkeypatch, n_lanes):
    """The GN blocks replayed as CUDA graphs give the eager blocks' bits,
    lane by lane, and the CPU path's inliers and validity with poses within
    1e-4."""
    from srba_slam_tpu_torch.ops import robust_lm

    rng = np.random.default_rng(4)
    n = 256
    pts = np.stack([rng.uniform(-6, 6, (n_lanes, n)), rng.uniform(-2, 2, (n_lanes, n)),
                    rng.uniform(4, 25, (n_lanes, n))], -1).astype(np.float32)
    cam = StereoCamera(**SMALL_CAM)
    x = pts + np.array([0.1, -0.05, -0.6], np.float32)
    obs = np.stack([cam.cx_l + cam.fx_l * x[..., 0] / x[..., 2],
                    cam.cy_l + cam.fy_l * x[..., 1] / x[..., 2],
                    cam.cx_r + cam.fx_r * (x[..., 0] - cam.baseline) / x[..., 2]], -1)
    obs = (obs + rng.normal(0, 0.5, obs.shape)).astype(np.float32)
    valid = rng.random((n_lanes, n)) < 0.9
    init = (rng.normal(0, 0.02, (n_lanes, 6))).astype(np.float32)
    outs = {}
    for name, dev, graphs in (("graph", cuda, True), ("eager", cuda, False),
                              ("cpu", "cpu", False)):
        monkeypatch.setattr(robust_lm, "GN_GRAPHS", graphs)
        args = [torch.from_numpy(a).to(dev) for a in (pts, obs, valid, init)]
        outs[name] = robust_lm.solve_pose(*args[:3], cam, initial_pose=args[3])
    for field, a, b in zip(outs["graph"]._fields, outs["graph"], outs["eager"]):
        assert torch.equal(a, b), field
    assert torch.equal(outs["graph"].inliers.cpu(), outs["cpu"].inliers)
    assert torch.equal(outs["graph"].valid.cpu(), outs["cpu"].valid)
    assert bool(outs["cpu"].valid.all())
    assert float((outs["graph"].pose.cpu() - outs["cpu"].pose).abs().max()) <= 1e-4


def test_vo_engine_cuda_matches_cpu(cuda):
    cam = StereoCamera(**SMALL_CAM)
    scene = PlaneScene(np.random.default_rng(11))
    engines = [StereoVOEngine(cam, VOOptions(fast_th=12, n_feats=256), capacity=256,
                              device=d) for d in (cuda, "cpu")]
    for i in range(3):
        left, right = scene.render(cam, np.array([0, 0, 0, 0.04 * i, 0, 0.12 * i], np.float32))
        a, b = (e.process_stereo_pair(left, right) for e in engines)
        assert (a.valid, a.num_stereo_matches, a.tracked_from_last_frame) == \
            (b.valid, b.num_stereo_matches, b.tracked_from_last_frame)
        np.testing.assert_allclose(a.pose_increment, b.pose_increment, atol=1e-4)


def test_estimator_cuda_matches_cpu(cuda):
    """The small-geometry sequence of tests/test_estimator.py, 20 frames."""
    cam = StereoCamera(**SMALL_CAM)
    frames = list(SyntheticSource(cam, n_frames=30, seed=11, step=0.12))[:20]
    ests = []
    for device in (cuda, "cpu"):
        opts = SRBAStereoSLAMOptions(
            orb_adaptive_fast_th=True, camera=cam, n_feats=256, detect_fast_th=12,
            adaptive_th_min_matches=40, max_translation=0.5, max_rotation=10.0,
            updated_matches_th=40, vo_id_tracking_th=30, srba_submap_size=5,
            srba_max_optimize_depth=3, da_filter_by_direction=False, residual_th=10.0)
        est = SRBAStereoSLAMEstimator(GeneralOptions(), opts, VOOptions(fast_th=12, n_feats=256),
                                      capacity=256, max_kfs=64, device=device)
        est.initialize()
        for left, right in frames:
            est.step(left, right)
        ests.append(est)
    a, b = ests
    assert decisions(a.step_log) == decisions(b.step_log)
    assert a.store.n_kfs == b.store.n_kfs >= 3
    n = a.store.n_kfs
    np.testing.assert_allclose(a.rba.kf_global[:n], b.rba.kf_global[:n], atol=1e-4)


EUROC_DIST = [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]
OPTION_SHAPES = [(2, 185, 613), (2, 92, 306), (2, 480, 752)]


def _option_frames(kind, shape, street, rng):
    """f32 frames as the frontend's options make them: ``quarters`` and
    ``sixteenths`` (octaves 1 and 2 of a uint8 frame), ``pooled`` (the
    street pair really pooled, cropped or tiled to ``shape``), ``remapped``
    (textured uint8 frames through a radial-tangential undistortion map)."""
    n, h, w = shape
    if kind == "quarters":
        return torch.from_numpy(rng.integers(0, 1021, shape).astype(np.float32) / 4)
    if kind == "sixteenths":
        return torch.from_numpy(rng.integers(0, 4081, shape).astype(np.float32) / 16)
    tiled = street.float().repeat(1, 3, 2)                    # [2, 1110, 2452]
    if kind == "pooled":
        return _avgpool2(tiled)[:, :h, :w].contiguous()
    assert kind == "remapped"
    maps = build_maps(w, h, 0.61 * w, 0.95 * h, 0.49 * w, 0.52 * h, dist=EUROC_DIST,
                      device="cpu")
    return torch.stack([remap_bilinear(tiled[i, 40:40 + h, 100:100 + w], maps)
                        for i in range(n)])


@pytest.mark.parametrize("kind", ["quarters", "sixteenths", "pooled", "remapped"])
@pytest.mark.parametrize("shape", OPTION_SHAPES)
@pytest.mark.parametrize("k", [170, 256])
def test_kernels_on_option_frames(cuda, street_pair, kind, shape, k):
    """K1, K2 and K3 on the f32, non-integer frames of octaves 1-2 and of a
    rectified rig, at their shapes, with the per-octave K and with
    mostly-false ``valid`` rows."""
    rng = np.random.default_rng(k + shape[1])
    imgs = _option_frames(kind, shape, street_pair, rng).to(cuda)
    assert imgs.dtype == torch.float32 and bool((imgs != imgs.round()).any())
    for th in (20.0, 90.0):
        s1 = hopper_fast.fast_nms(imgs, th)
        assert torch.equal(s1, hopper_fast.fast_nms_plain(imgs, th))
        for margin in (0, 2, 3, 4):
            s3 = hopper_fast.fast_score_map(imgs, th, margin=margin)
            assert torch.equal(s3, fast_score_map_plain(imgs, th, margin=margin))
        for scores in (s1, local_max_suppress(s3, radius=2)):
            ys, xs, _sc, valid = grid_topk(scores, cell=5, k=k)
            # all the selected keypoints, then a mostly-false ``valid`` (a deep octave)
            sparse = valid & torch.from_numpy(rng.random(tuple(valid.shape)) < 0.1).to(cuda)
            for v in (valid, sparse):
                got = hopper_fast.orb_descriptors(imgs, ys, xs, v)
                assert torch.equal(got, hopper_fast.orb_descriptors_plain(imgs, ys, xs, v))
                assert not bool(got[~v].any())


@pytest.mark.parametrize("dtype", ["u8", "quarters", "remapped"])
@pytest.mark.parametrize("dist", list(range(3, 16)))
def test_orb_kernel_at_keypoints_near_a_border(cuda, street_pair, dtype, dist):
    """K2 against its plain version with every keypoint exactly ``dist`` px
    from a border (3-15: closer than the pattern's reach of 13 plus the
    blur's 3), along all four borders and in the corners."""
    rng = np.random.default_rng(dist)
    shape = (2, 185, 613)
    n, h, w = shape
    if dtype == "u8":
        imgs = street_pair[:, 90:90 + h, 300:300 + w].contiguous()
    else:
        imgs = _option_frames(dtype, shape, street_pair, rng)
    imgs = imgs.to(cuda)
    k = 64
    along_x = rng.integers(dist, w - dist, (n, k // 4))
    along_y = rng.integers(dist, h - dist, (n, k // 4))
    ys = np.concatenate([np.full_like(along_x, dist), np.full_like(along_x, h - 1 - dist),
                         along_y, along_y], axis=1)
    xs = np.concatenate([along_x, along_x, np.full_like(along_y, dist),
                         np.full_like(along_y, w - 1 - dist)], axis=1)
    ys[:, :2], xs[:, :2] = (dist, h - 1 - dist), (dist, w - 1 - dist)       # two corners
    ys = torch.from_numpy(ys.astype(np.int32)).to(cuda)
    xs = torch.from_numpy(xs.astype(np.int32)).to(cuda)
    valid = torch.ones((n, k), dtype=torch.bool, device=cuda)
    got = hopper_fast.orb_descriptors(imgs, ys, xs, valid)
    assert torch.equal(got, hopper_fast.orb_descriptors_plain(imgs, ys, xs, valid))
    assert bool(got.any())


@pytest.mark.parametrize("option", ["levels2", "levels3", "margin0", "margin2", "margin3",
                                    "margin4", "margin8",
                                    "rect_maps", "robust_1to1"])
def test_frontend_options_cuda_matches_cpu(cuda, street_pair, option):
    """``extract_and_match`` with each option on the card against the CPU
    path, on the street pair: every integer field equal, pts3d to 1e-4; the
    kernels each option should reach are the ones launched."""
    cam = StereoCamera.kitti()
    kw = {"levels2": dict(n_levels=2), "levels3": dict(n_levels=3), "margin0": dict(margin=0),
          "margin2": dict(margin=2), "margin3": dict(margin=3),
          "margin4": dict(margin=4), "margin8": dict(margin=8), "rect_maps": {},
          "robust_1to1": dict(robust_1to1=True)}[option]
    left, right = street_pair[0].numpy(), street_pair[1].numpy()
    outs = []
    for device in (cuda, "cpu"):
        if option == "rect_maps":
            kw["rect_maps"] = tuple(build_maps(cam.width, cam.height, cam.fx_l, cam.fy_l,
                                               cam.cx_l, cam.cy_l, dist=EUROC_DIST,
                                               device=device) for _ in range(2))
        before = [f.launches for f in (hopper_fast.fast_nms, hopper_fast.orb_descriptors,
                                       hopper_fast.fast_score_map)]
        outs.append(extract_and_match(left, right, cam, 20.0, 60, k=512, device=device, **kw))
        after = [f.launches for f in (hopper_fast.fast_nms, hopper_fast.orb_descriptors,
                                      hopper_fast.fast_score_map)]
        if device == "cpu":
            assert after == before
        else:
            levels = kw.get("n_levels", 1)
            k3 = kw.get("margin", 16) < 5
            assert [a - b for a, b in zip(after, before)] == \
                [0 if k3 else levels, levels, 1 if k3 else 0]
    a, b = outs
    for name in ("ys_l", "xs_l", "valid_l", "desc_l", "ys_r", "xs_r", "valid_r", "desc_r",
                 "m_r_idx", "m_valid", "octave"):
        assert torch.equal(getattr(a, name).cpu(), getattr(b, name)), name
    assert float((a.pts3d.cpu() - b.pts3d).abs().max()) <= 1e-4
    assert int(a.m_valid.sum()) > 100


def test_oriented_frontend_cuda_close_to_cpu(cuda, street_pair):
    """Oriented descriptors are plain torch on the card: keypoints equal the
    CPU path's; a steering angle that differs in its last bit moves a sample
    across a rounding boundary, so differing descriptor rows are counted and
    held under 2%."""
    cam = StereoCamera.kitti()
    left, right = street_pair[0].numpy(), street_pair[1].numpy()
    a, b = (extract_and_match(left, right, cam, 20.0, 60, k=512, oriented=True, device=d)
            for d in (cuda, "cpu"))
    for name in ("ys_l", "xs_l", "valid_l", "ys_r", "xs_r", "valid_r"):
        assert torch.equal(getattr(a, name).cpu(), getattr(b, name)), name
    rows = sum(int((getattr(a, n).cpu() != getattr(b, n)).any(1).sum())
               for n in ("desc_l", "desc_r"))
    print(f"oriented: {rows} of 1024 descriptor rows differ between CUDA and CPU")
    assert rows <= 20


def test_cli_runs_on_the_card(cuda, tmp_path, capsys):
    """``python -m srba_slam_tpu_torch``'s main with no --cpu: the card."""
    import os
    import re

    from srba_slam_tpu_torch.__main__ import main

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    txt = open(os.path.join(repo, "demo", "config_synthetic_small.ini")).read()
    txt = re.sub(r"(?m)^out_dir.*$", f"out_dir = {tmp_path / 'out'}", txt)
    ini = tmp_path / "small.ini"
    ini.write_text(txt)
    before = (hopper_fast.fast_nms.launches, hopper_fast.orb_descriptors.launches)
    assert main([str(ini), "--synthetic", "12", "--checkpoint", str(tmp_path / "s.npz")]) == 0
    said = capsys.readouterr().out
    assert f"backend: cuda ({torch.cuda.get_device_name(0)})" in said and "12 frames" in said
    # the card's default is --batch 8: frame 0 bootstraps, then K1 and K2
    # launch once per scan of up to 8 frames (and per retry tail)
    n_k1 = hopper_fast.fast_nms.launches - before[0]
    assert n_k1 >= 3 and hopper_fast.orb_descriptors.launches - before[1] == n_k1
    assert (tmp_path / "out" / "map_viewer.html").exists() and (tmp_path / "s.npz").exists()
    assert main([str(ini), "--synthetic", "2", "--resume", str(tmp_path / "s.npz")]) == 0
    assert "resumed from" in capsys.readouterr().out
