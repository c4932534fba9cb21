"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA card and skips without one. This file imports
no jax, so it runs where only torch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: none for the kernels, which are bit-exact against their plain
versions (on uint8 frames and on the f32, non-integer frames of pyramid
octaves and of a rectified rig), nor for the VO engine's integer results
and the estimator's keyframe decisions, which equal the CPU path's. Poses
and triangulated points agree within 1e-4 (the f32 solves sum in another
order on the card); the keyframe poses of the pipelined batched loop
within 1e-3, the tolerance of its CPU tests against JAX. Oriented descriptors, plain torch on both devices, may
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
    one K2 launch for the 8 images (and one more for a capture's warm-up)."""
    from srba_slam_tpu_torch.models.vo import vo_scan
    from srba_slam_tpu_torch.ops import cuda_graphs

    frames = list(SyntheticSource(StereoCamera.kitti(), **{**bench_workload.SOURCE,
                                                          "n_frames": 5}))
    lefts = np.stack([f[0] for f in frames[1:]])
    rights = np.stack([f[1] for f in frames[1:]])
    cam = StereoCamera.kitti()
    outs = {}
    for dev in (cuda, "cpu"):
        prev = extract_and_match(*frames[0], cam, 20.0, 60, k=512, device=dev)
        before = (hopper_fast.fast_nms.launches, hopper_fast.orb_descriptors.launches)
        captures = cuda_graphs.PROGRAM_STATS["captures"]
        outs[str(dev)] = vo_scan(lefts, rights, prev, torch.zeros(6, device=dev), cam, 20.0, 60,
                                 k=512, device=dev)
        after = (hopper_fast.fast_nms.launches, hopper_fast.orb_descriptors.launches)
        if dev is cuda:
            n = 1 + cuda_graphs.PROGRAM_STATS["captures"] - captures
            assert (after[0] - before[0], after[1] - before[1]) == (n, n)
    (_l, inc_c, oc), (_m, inc_h, oh) = outs["cuda"], outs["cpu"]
    for name in ("ys_l", "xs_l", "valid_l", "desc_l", "ys_r", "xs_r", "valid_r", "desc_r",
                 "m_r_idx", "m_valid"):
        assert torch.equal(getattr(oc[0], name).cpu(), getattr(oh[0], name)), name
    assert torch.equal(oc[4].cpu(), oh[4]) and bool(oh[4].all())
    d = (oc[3].cpu() - oh[3]).abs()
    assert float(d[:, :3].max()) <= 1e-4 and float(d[:, 3:].max()) <= 1e-3


@pytest.fixture(scope="module")
def street_frames():
    """Frames 0-20 of the bench workload's street sequence (host uint8)."""
    return list(SyntheticSource(StereoCamera.kitti(), **{**bench_workload.SOURCE,
                                                          "n_frames": 21}))


def _scan(frames, j0: int, b: int, prev, init, fast_th, orb_th, graphs: bool, monkeypatch,
          **kw):
    """``vo_scan`` of street frames ``j0 .. j0 + b - 1`` on the card, as a
    graph replay or eagerly; returns its outputs' tensors."""
    from srba_slam_tpu_torch.models import vo
    from srba_slam_tpu_torch.ops import cuda_graphs

    monkeypatch.setattr(vo, "SCAN_GRAPHS", graphs)
    dev = torch.device("cuda")
    lefts = torch.from_numpy(np.stack([f[0] for f in frames[j0:j0 + b]])).to(dev)
    rights = torch.from_numpy(np.stack([f[1] for f in frames[j0:j0 + b]])).to(dev)
    with cuda_graphs.no_exit_reads():
        out = vo.vo_scan(lefts, rights, prev, init, StereoCamera.kitti(), fast_th, orb_th,
                         device=dev, **kw)
    return out


def _leaves(out):
    from torch.utils import _pytree as pytree

    return pytree.tree_leaves(out)


def _assert_same_bits(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) == 13 + 1 + 13 + 6
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), i


def _prev(frames, cuda, **kw):
    return extract_and_match(*frames[0], StereoCamera.kitti(), 20.0, 60, k=512, device=cuda,
                             **kw)


@pytest.mark.parametrize("b", [8, 20, 13], ids=["b8", "b20", "tail13"])
def test_scan_graph_equals_eager(cuda, street_frames, monkeypatch, b):
    """The scan as one CUDA-graph replay (its GN loops conditional WHILE
    nodes, its thresholds device inputs) equals the eager scan bit for bit
    on every output, at the bench's batches and at a retry tail's length;
    its capture counts the warm-up's K1/K2 launches and none of its own,
    each replay one of each; a second call replays without a capture."""
    from srba_slam_tpu_torch.ops import cuda_graphs

    monkeypatch.setattr(cuda_graphs, "_PROGRAMS", {})
    prev, init = _prev(street_frames, cuda), torch.zeros(6, device=cuda)
    eager = _scan(street_frames, 1, b, prev, init, 20.0, 60, False, monkeypatch)
    before = hopper_fast.fast_nms.launches, hopper_fast.orb_descriptors.launches
    captures = cuda_graphs.PROGRAM_STATS["captures"]
    fast = torch.full((b,), 20.0, device=cuda)
    orb = torch.full((), 60.0, device=cuda)
    for rep in range(2):
        graph = _scan(street_frames, 1, b, prev, init, fast, orb, True, monkeypatch)
        torch.cuda.synchronize()
        _assert_same_bits(graph, eager)
    assert cuda_graphs.PROGRAM_STATS["captures"] == captures + 1
    assert (hopper_fast.fast_nms.launches - before[0],
            hopper_fast.orb_descriptors.launches - before[1]) == (3, 3)
    (prog,) = cuda_graphs.programs()
    assert prog["launches"] == {"fast_nms": 1, "orb_descriptors": 1, "fast_score_map": 0}
    assert prog["steps"] == 1 and prog["pool_bytes"] > 0
    assert bool(eager[2][4].all()) and int(eager[2][0].m_valid.sum()) > 200 * b


def test_scan_graph_replays_at_new_thresholds(cuda, street_frames, monkeypatch):
    """Captured at FAST 20 / ORB 60 and replayed at 15 / 70, the graph
    gives the eager scan at 15 / 70 (a threshold baked into the graph
    would give the 20 / 60 scan: the ORB threshold changes the matches);
    and at FAST 250 / ORB 60 the eager scan at 250 / 60 (the FAST threshold
    changes the keypoints)."""
    from srba_slam_tpu_torch.ops import cuda_graphs

    monkeypatch.setattr(cuda_graphs, "_PROGRAMS", {})
    b = 8
    prev, init = _prev(street_frames, cuda), torch.zeros(6, device=cuda)
    first = _scan(street_frames, 1, b, prev, init, torch.full((b,), 20.0, device=cuda),
                  torch.full((), 60.0, device=cuda), True, monkeypatch)
    captures = cuda_graphs.PROGRAM_STATS["captures"]
    for fast, orb, field in ((15.0, 70, "m_valid"), (250.0, 60, "valid_l")):
        graph = _scan(street_frames, 1, b, prev, init, torch.full((b,), fast, device=cuda),
                      torch.full((), float(orb), device=cuda), True, monkeypatch)
        eager = _scan(street_frames, 1, b, prev, init, fast, orb, False, monkeypatch)
        _assert_same_bits(graph, eager)
        assert not torch.equal(getattr(graph[2][0], field), getattr(first[2][0], field))
    assert cuda_graphs.PROGRAM_STATS["captures"] == captures


def test_scan_graph_replay_syncs_nothing(cuda, street_frames, monkeypatch):
    """A replay of a captured scan, its inputs on the card, under
    ``torch.cuda.set_sync_debug_mode("error")``: the input copies, the
    graph launch and the output clones make no host sync."""
    b = 8
    prev, init = _prev(street_frames, cuda), torch.zeros(6, device=cuda)
    fast, orb = torch.full((b,), 20.0, device=cuda), torch.full((), 60.0, device=cuda)
    ref = _scan(street_frames, 1, b, prev, init, fast, orb, True, monkeypatch)
    lefts = torch.from_numpy(np.stack([f[0] for f in street_frames[1:1 + b]])).to(cuda)
    rights = torch.from_numpy(np.stack([f[1] for f in street_frames[1:1 + b]])).to(cuda)
    from srba_slam_tpu_torch.models import vo
    from srba_slam_tpu_torch.ops import cuda_graphs

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with cuda_graphs.no_exit_reads():
            out = vo.vo_scan(lefts, rights, prev, init, StereoCamera.kitti(), fast, orb,
                             device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    _assert_same_bits(out, ref)


def test_chained_scans_back_to_back(cuda, street_frames, monkeypatch):
    """Two graph scans of 8, the second chained from the first's last frame
    and increment and dispatched before anything is read (the pipelined
    loop's order), equal two scans each read before the next is dispatched:
    the first scan's outputs are not the graph's buffers, which the second
    replay overwrites."""
    b = 8
    prev, init = _prev(street_frames, cuda), torch.zeros(6, device=cuda)
    fast, orb = torch.full((b,), 20.0, device=cuda), torch.full((), 60.0, device=cuda)
    runs = []
    for read_between in (True, False):
        first = _scan(street_frames, 1, b, prev, init, fast, orb, True, monkeypatch)
        host = [t.cpu() for t in _leaves(first)] if read_between else []
        second = _scan(street_frames, 1 + b, b, first[0], first[1], fast, orb, True,
                       monkeypatch)
        host = host or [t.cpu() for t in _leaves(first)]
        runs.append(host + [t.cpu() for t in _leaves(second)])
    assert len(runs[0]) == len(runs[1]) == 2 * (13 + 1 + 13 + 6)
    for i, (x, y) in enumerate(zip(*runs)):
        assert torch.equal(x, y), i


@pytest.mark.parametrize("option", ["levels2", "rect_maps", "margin3", "oriented",
                                    "fund_matrix"])
def test_scan_graph_options_equal_eager(cuda, street_frames, monkeypatch, option):
    """Each frontend and solve option that the scan's key holds, through
    the graph and eagerly at B = 4: the same bits."""
    from srba_slam_tpu_torch.ops import cuda_graphs

    monkeypatch.setattr(cuda_graphs, "_PROGRAMS", {})
    cam = StereoCamera.kitti()
    front = dict(levels2=dict(n_levels=2), margin3=dict(margin=3),
                 oriented=dict(oriented=True)).get(option, {})
    if option == "rect_maps":
        front = dict(rect_maps=tuple(build_maps(cam.width, cam.height, cam.fx_l, cam.fy_l,
                                                cam.cx_l, cam.cy_l,
                                                dist=[-0.2, 0.05, 1e-4, 1e-5, 0.0],
                                                device=cuda) for _ in range(2)))
    solve = dict(filter_fund_matrix=True) if option == "fund_matrix" else {}
    prev, init = _prev(street_frames, cuda, **front), torch.zeros(6, device=cuda)
    kw = dict(front, **solve)
    eager = _scan(street_frames, 1, 4, prev, init, 20.0, 60, False, monkeypatch, **kw)
    for _ in range(2):
        graph = _scan(street_frames, 1, 4, prev, init, torch.full((4,), 20.0, device=cuda),
                      torch.full((), 60.0, device=cuda), True, monkeypatch, **kw)
        _assert_same_bits(graph, eager)
    assert int(eager[2][0].m_valid.sum()) > 100


def test_cond_append_outside_a_capture_raises(cuda, monkeypatch):
    """Appending a loop's steps where no capture is active fails in
    ``srba_cond_append`` and raises; nothing runs the steps instead."""
    from srba_slam_tpu_torch.ops import cuda_graphs

    monkeypatch.setattr(cuda_graphs, "_GRAPHS", {})
    monkeypatch.setattr(cuda_graphs, "_KEEP", [])

    def step(c, k):
        runs = c["runs"] + 1
        return dict(runs=runs, more=runs < k["stop"])

    c = dict(runs=torch.zeros((), dtype=torch.int32, device=cuda),
             more=torch.ones((), dtype=torch.bool, device=cuda))
    k = dict(stop=torch.full((), 3, dtype=torch.int32, device=cuda))
    cuda_graphs.loop(step, c, k, 5, ("append",), True)
    ((graph, _launch, sc, _sk),) = cuda_graphs._GRAPHS.values()
    with pytest.raises(RuntimeError, match="srba_cond_append failed"):
        cuda_graphs._append(graph, sc, 5, cuda)


def test_float_threshold_inside_a_program_raises(cuda, street_frames, monkeypatch):
    """K1 given a float threshold inside a captured program's warm-up
    raises (the float would stay in the graph, and a replay at another
    threshold would use it); nothing is cached, and the program state is
    left as it was."""
    from srba_slam_tpu_torch.ops import cuda_graphs, hopper_fast

    monkeypatch.setattr(cuda_graphs, "_PROGRAMS", {})
    imgs = torch.from_numpy(np.stack(street_frames[0])).to(cuda)
    with pytest.raises(TypeError, match="float threshold"):
        cuda_graphs.program(lambda x: hopper_fast.fast_nms(x["imgs"], 20.0), dict(imgs=imgs),
                            ("float",), counted=(hopper_fast.fast_nms,))
    assert not cuda_graphs._PROGRAMS and not cuda_graphs.in_program()
    th = torch.full((2,), 20.0, device=cuda)
    got = cuda_graphs.program(lambda x: hopper_fast.fast_nms(x["imgs"], x["th"]),
                              dict(imgs=imgs, th=th), ("tensor",))
    assert torch.equal(got, hopper_fast.fast_nms(imgs, 20.0))


@pytest.mark.parametrize("reads", [True, False])
def test_graph_loop_skips_steps_past_the_exit(cuda, reads):
    """``cuda_graphs.loop`` on a card puts the captured step in a
    conditional WHILE node on the carry's ``more``: a step that counts its
    runs (not masked, unlike the solves' steps) stops counting at the exit,
    inside ``no_exit_reads`` or not, and a second call replays the same
    graph in one launch that synchronizes nothing."""
    import contextlib

    from srba_slam_tpu_torch.ops import cuda_graphs

    def step(c, k):
        runs = c["runs"] + 1
        return dict(runs=runs, more=runs < k["stop"])

    for stop in (3, 5):
        c = dict(runs=torch.zeros((), dtype=torch.int32, device=cuda),
                 more=torch.ones((), dtype=torch.bool, device=cuda))
        k = dict(stop=torch.full((), stop, dtype=torch.int32, device=cuda))
        # the second call replays: its steps are one WHILE launch, no host read
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error" if stop == 5 else "default")
        try:
            with contextlib.nullcontext() if reads else cuda_graphs.no_exit_reads():
                out = cuda_graphs.loop(step, c, k, 10, ("count", reads), True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert int(out["runs"]) == stop and not bool(out["more"])


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


def _bucket_window(C, L, O, seed=5):
    from srba_slam_tpu_torch.utils.synthworld import make_ba_window_problem

    win, _gt = make_ba_window_problem(StereoCamera.kitti(), np.random.default_rng(seed), C, L, O,
                                      min(C - 2, 12), L // 2)
    return win


@pytest.mark.parametrize("bucket", [(8, 512, 1024), (8, 1024, 2048), (16, 1024, 2048),
                                    (32, 2048, 4096), (32, 8192, 16384)])
def test_window_graph_blocks_match_eager(cuda, monkeypatch, bucket):
    """At each of the engine's default buckets, the LM blocks replayed as
    CUDA graphs give the eager blocks' bits, and (up to C x L = 16384) the
    CPU path's costs within 1e-4 relative; the capture, from an empty cache, synchronizes
    nothing (a synchronize inside a capture raises), and a replayed solve
    synchronizes at most once a block after the first, plus its copy out."""
    from srba_slam_tpu_torch.ops import cuda_graphs, window_ba
    from srba_slam_tpu_torch.utils import kernel_timing

    win = _bucket_window(*bucket)
    cam = StereoCamera.kitti()
    kw = dict(kernel_param=1.5, max_iters=8, stage1_iters=2)
    win_c = window_ba.BAWindow(*(a.to(cuda) for a in win))
    monkeypatch.setattr(cuda_graphs, "_GRAPHS", {})
    graph = window_ba.optimize_window(win_c, cam, **kw)
    assert len(cuda_graphs._GRAPHS) == 2               # stage 1 and stage 2
    monkeypatch.setattr(window_ba, "WBA_GRAPHS", False)
    eager = window_ba.optimize_window(win_c, cam, **kw)
    monkeypatch.setattr(window_ba, "WBA_GRAPHS", True)
    for field, a, b in zip(graph._fields, graph, eager):
        assert torch.equal(a, b), field
    if bucket[0] * bucket[1] <= 16384:                # the CPU takes minutes past that
        cpu = window_ba.optimize_window(win, cam, **kw)
        for field in ("cost_init", "cost_final", "obs_rmse"):
            np.testing.assert_allclose(float(getattr(graph, field)),
                                       float(getattr(cpu, field)), rtol=1e-4, err_msg=field)
    plan = window_ba.assembly_plan(*(a.numpy() for a in (win.obs_cam, win.obs_lm, win.lm_base,
                                                         win.obs_valid)), *bucket[:2], cuda)
    evs = kernel_timing.profile_calls(
        lambda: window_ba.optimize_window(win_c, cam, plan=plan, **kw).cam_pose.cpu())
    # an exit read between two blocks of a stage, and the copy out
    reads = sum(-(-n // min(window_ba.WBA_EXIT_EVERY, n)) - 1 for n in (2, 8))
    assert sum(e.count for e in evs if e.key == "cudaStreamSynchronize") <= reads + 1
    assert sum(e.count for e in evs if e.key == "cudaGraphLaunch") >= 2


def _loop_graph_np(rng, n=30, n_pad=64, e_pad=64, n_lc=3):
    from srba_slam_tpu_torch.utils import se3_np

    gt = [np.zeros(6)]
    inc = np.array([0, np.deg2rad(-360.0 / n), 0, 0.2, 0, 1.5])
    for _ in range(n - 1):
        gt.append(se3_np.compose(gt[-1], inc + rng.normal(0, 0.01, 6)))
    eu, ev, rel = [], [], []
    for i in range(n - 1):
        eu.append(i), ev.append(i + 1)
        rel.append(se3_np.relative(gt[i + 1], gt[i]) + rng.normal(0, 0.02, 6))
    for j in range(n_lc):
        eu.append(j), ev.append(n - 1 - j)
        rel.append(se3_np.relative(gt[n - 1 - j], gt[j]))
    poses0 = np.zeros((n_pad, 6), np.float32)
    for i in range(1, n):
        poses0[i] = se3_np.compose(poses0[i - 1], rel[i - 1])
    eu_a = np.zeros(e_pad, np.int32); eu_a[: len(eu)] = eu
    ev_a = np.zeros(e_pad, np.int32); ev_a[: len(ev)] = ev
    rel_a = np.zeros((e_pad, 6), np.float32); rel_a[: len(rel)] = rel
    return poses0, np.arange(n_pad) < n, eu_a, ev_a, rel_a, np.arange(e_pad) < len(eu)


def test_pose_graph_replays_match_eager(cuda, monkeypatch):
    """With ``PG_PROGRAM`` off, the pose graph's iterations replayed as a
    CUDA graph give the eager iterations' bits, and the CPU path's poses
    within 1e-3; the capture synchronizes nothing, and a call synchronizes
    only for its edges read back and its tables."""
    from srba_slam_tpu_torch.ops import cuda_graphs, posegraph, window_ba
    from srba_slam_tpu_torch.utils import kernel_timing

    args = _loop_graph_np(np.random.default_rng(30))
    args_c = [torch.from_numpy(a).to(cuda) for a in args]
    monkeypatch.setattr(cuda_graphs, "_GRAPHS", {})
    monkeypatch.setattr(posegraph, "PG_PROGRAM", False)     # the replays, not the program
    graph = posegraph.optimize_pose_graph(*args_c, max_iters=25)
    assert len(cuda_graphs._GRAPHS) == 1
    monkeypatch.setattr(posegraph, "PG_GRAPHS", False)
    eager = posegraph.optimize_pose_graph(*args_c, max_iters=25)
    monkeypatch.setattr(posegraph, "PG_GRAPHS", True)
    for name, a, b in zip(("poses", "cost_init", "cost_final", "iters"), graph, eager):
        assert torch.equal(a, b), name
    cpu = posegraph.optimize_pose_graph(*map(torch.from_numpy, args), max_iters=25)
    assert float((graph[0].cpu() - cpu[0]).abs().max()) <= 1e-3
    assert float(graph[2]) < 0.05 * float(graph[1])
    evs = kernel_timing.profile_calls(
        lambda: posegraph.optimize_pose_graph(*args_c, max_iters=25)[0].cpu())
    # the edges to the host, the tables' uploads and the copy out; none in
    # the iterations
    n_e, n = len(args[2]), len(args[0])
    n_tables = len(window_ba._fixed_levels(4 * n_e, n * n, 32)) \
        + len(window_ba._fixed_levels(2 * n_e, n, 32))
    assert sum(e.count for e in evs if e.key == "cudaStreamSynchronize") <= 3 + n_tables + 1
    assert sum(e.count for e in evs if e.key == "cudaGraphLaunch") == 25


def test_entry_runs_on_the_card(cuda):
    """``entry()`` (the single-card VO step at 370x1226, k = 512)
    launches K1 (f32 route) and K2 on the card, and its outputs equal the
    CPU path's: m_valid and num_inliers exact, the pose within 1e-4."""
    from srba_slam_tpu_torch.parallel.multichip import entry

    before = hopper_fast.fast_nms.launches, hopper_fast.orb_descriptors.launches
    fn, args = entry()
    pose, n_inliers, m_valid = fn(*args)
    torch.cuda.synchronize()
    assert hopper_fast.fast_nms.launches >= before[0] + 2
    assert hopper_fast.orb_descriptors.launches >= before[1] + 2
    assert pose.is_cuda and m_valid.is_cuda and pose.shape == (6,) and m_valid.shape == (512,)
    fn_cpu, args_cpu = entry("cpu")
    ref = fn_cpu(*args_cpu)
    assert torch.equal(m_valid.cpu(), ref[2]) and int(n_inliers) == int(ref[1])
    assert float((pose.cpu() - ref[0]).abs().max()) <= 1e-4


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


@pytest.mark.parametrize("rotation", ["auto", "horn"])
@pytest.mark.parametrize("schedule,tol", [("strict", 1e-4), ("pipelined", 1e-3)])
def test_estimator_cuda_matches_cpu(cuda, monkeypatch, schedule, tol, rotation):
    """The small-geometry sequence of tests/test_estimator.py on both
    devices: 20 frames stepped per frame with the strict solve schedule
    (every window solve lands right after its insertion; keyframe poses
    within 1e-4); and 25 frames at ``max_translation`` 0.18 (7 keyframes,
    where the pipelined poses move ~0.1 m from the strict ones) through the
    batched loop at batch 8 with the pipelined default, the CLI's schedule
    on a card (within 1e-3, the tolerance of the CPU's pipelined tests
    against JAX). ``rotation``: the Horn seed's route by device (the SVD
    Kabsch on the CPU, Horn's Jacobi rotation on the card), or Horn's on
    both, which takes the seed's algorithm out of the gap; the gap is
    printed."""
    from srba_slam_tpu_torch.models import data_association as da

    if rotation == "horn":
        monkeypatch.setattr(da, "_kabsch_rotation", da._horn_rotation)
    cam = StereoCamera(**SMALL_CAM)
    strict = schedule == "strict"
    frames = list(SyntheticSource(cam, n_frames=30, seed=11, step=0.12))[:20 if strict else 25]
    ests = []
    for device in (cuda, "cpu"):
        opts = SRBAStereoSLAMOptions(
            orb_adaptive_fast_th=True, camera=cam, n_feats=256, detect_fast_th=12,
            adaptive_th_min_matches=40, max_translation=0.5 if strict else 0.18,
            max_rotation=10.0,
            updated_matches_th=40, vo_id_tracking_th=30, srba_submap_size=5,
            srba_max_optimize_depth=3, da_filter_by_direction=False, residual_th=10.0)
        est = SRBAStereoSLAMEstimator(GeneralOptions(), opts, VOOptions(fast_th=12, n_feats=256),
                                      capacity=256, max_kfs=64, device=device)
        est.initialize()
        if strict:
            est.solve_sync = True
            for left, right in frames:
                est.step(left, right)
        else:
            est.perform_stereo_slam_batched(frames, batch=8)
        est.rba.flush()
        ests.append(est)
    a, b = ests
    assert decisions(a.step_log) == decisions(b.step_log)
    assert a.store.n_kfs == b.store.n_kfs >= (3 if strict else 6)
    n = a.store.n_kfs
    gap = np.abs(a.rba.kf_global[:n] - b.rba.kf_global[:n])
    print(f"card-vs-CPU keyframe poses, {schedule}, rotation {rotation}: max gap "
          f"{gap.max():.3e} (rotation part {gap[:, :3].max():.3e}, translation "
          f"{gap[:, 3:].max():.3e}), per keyframe {np.round(gap.max(axis=1), 8).tolist()}")
    np.testing.assert_allclose(a.rba.kf_global[:n], b.rba.kf_global[:n], atol=tol)


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


FLEET_CAM = dict(fx_l=90.0, fy_l=90.0, cx_l=80.0, cy_l=48.0, fx_r=90.0, fy_r=90.0, cx_r=80.0,
                 cy_r=48.0, baseline=0.5, width=160, height=96)
FLEET_OPTIONS = dict(orb_adaptive_fast_th=True, n_feats=128, detect_fast_th=12,
                     adaptive_th_min_matches=30, max_translation=0.5, max_rotation=10.0,
                     updated_matches_th=30, vo_id_tracking_th=25, srba_submap_size=5,
                     srba_max_optimize_depth=3, da_filter_by_direction=False, residual_th=10.0)


def _fleet_vocabulary():
    from srba_slam_tpu_torch.models.bow import Vocabulary

    rng = np.random.default_rng(0)
    return Vocabulary.train(rng.integers(0, 2**32, (512, 8), dtype=np.uint64).astype(np.uint32),
                            k=8, L=2, seed=0)


def _fleet_sequences(seeds, n_frames: int = 12) -> list:
    return [list(SyntheticSource(StereoCamera(**FLEET_CAM), n_frames=n_frames, seed=s,
                                 step=0.12)) for s in seeds]


def _fleet_estimators(device, voc, n: int) -> list:
    ests = []
    for _ in range(n):
        e = SRBAStereoSLAMEstimator(
            GeneralOptions(), SRBAStereoSLAMOptions(camera=StereoCamera(**FLEET_CAM),
                                                    **FLEET_OPTIONS),
            VOOptions(fast_th=12, n_feats=128), capacity=128, max_kfs=32, device=device)
        e.initialize(vocabulary=voc)
        ests.append(e)
    return ests


def test_fleet_on_a_repeated_card_mesh_equals_meshless(cuda, monkeypatch):
    """Four sequences (the workload of tests/test_torch_parallel.py's fleet,
    two more seeds) on ``["cuda:0"] * 4``, one sequence a shard: the
    mesh-less fleet's decisions, keyframe poses within 1e-4; K1 and K2 once
    per shard per lockstep attempt."""
    from srba_slam_tpu_torch.ops import cuda_graphs
    from srba_slam_tpu_torch.parallel import fleet
    from srba_slam_tpu_torch.parallel.batch import make_mesh

    voc = _fleet_vocabulary()
    seqs = _fleet_sequences((11, 23, 35, 47))

    sizes = []
    attempt = fleet.FleetSLAM._attempt
    monkeypatch.setattr(fleet.FleetSLAM, "_attempt", lambda self, s, idx, *a: (
        sizes.append(len(idx)), attempt(self, s, idx, *a))[1])

    def run(mesh):
        sizes.clear()
        ests = _fleet_estimators(cuda, voc, len(seqs))
        before = hopper_fast.fast_nms.launches, hopper_fast.orb_descriptors.launches
        captures = cuda_graphs.capture_stats("fleet_attempt")["captures"]
        fleet.FleetSLAM(ests, mesh=mesh).run(seqs)
        n_k1 = hopper_fast.fast_nms.launches - before[0]
        assert hopper_fast.orb_descriptors.launches - before[1] == n_k1
        return (ests, n_k1, list(sizes),
                cuda_graphs.capture_stats("fleet_attempt")["captures"] - captures)

    plain, n_plain, sizes_plain, caps_plain = run(make_mesh(devices=[cuda]))
    meshed, n_meshed, sizes_meshed, caps_meshed = run(make_mesh(devices=[cuda] * 4))
    for m, p in zip(meshed, plain):
        assert decisions(m.step_log) == decisions(p.step_log)
        n = p.store.n_kfs
        assert m.store.n_kfs == n >= 2
        assert float(np.abs(m.rba.kf_global[:n] - p.rba.kf_global[:n]).max()) <= 1e-4
    # bootstrap frames: one launch a sequence; then one a shard an attempt
    # (a replay of its program) and one a program's warm-up: the mesh-less
    # fleet's batch of an attempt is one launch a sequence here; the four
    # shards of one card share their attempt program
    assert n_plain == 4 + len(sizes_plain) + caps_plain and len(sizes_plain) >= 11
    assert n_meshed == 4 + len(sizes_meshed) + caps_meshed
    assert len(sizes_meshed) == sum(sizes_plain) and set(sizes_meshed) == {1}
    assert caps_meshed <= 1


def _recording_fleet(ests, mesh=None):
    """A fleet over ``ests`` whose lockstep attempts and check groups are
    recorded as they are called: (fleet, {"attempts": [args], "checks":
    [args]}, the unwrapped methods)."""
    from srba_slam_tpu_torch.parallel import fleet
    from srba_slam_tpu_torch.tools.fleet_launches import record_calls

    flt = fleet.FleetSLAM(ests, mesh=mesh)
    return (flt, *record_calls(flt))


def _assert_same_run(a, b):
    """Two fleet runs' estimators: the same decisions, step results,
    thresholds, DA stream, keyframe store and BoW rows and keyframe poses,
    bit for bit."""
    for x, y in zip(a, b):
        assert decisions(x.step_log) == decisions(y.step_log)
        for rx, ry in zip(x.step_log, y.step_log):
            assert (rx.vo_valid, rx.n_stereo_matches, rx.tracked_from_last_kf) == (
                ry.vo_valid, ry.n_stereo_matches, ry.tracked_from_last_kf)
        assert (x.vo.fast_th, x.vo.orb_th, x._da_seed) == (y.vo.fast_th, y.vo.orb_th, y._da_seed)
        assert x.store.n_kfs == y.store.n_kfs >= 2
        for name, p, q in zip(x.store.arrays._fields, x.store.arrays, y.store.arrays):
            assert torch.equal(p, q), name
        assert torch.equal(x.bow._db, y.bow._db)
        np.testing.assert_array_equal(x.store.match_ids, y.store.match_ids)
        x.rba.flush(), y.rba.flush()
        np.testing.assert_array_equal(x.rba.kf_global[:x.store.n_kfs],
                                      y.rba.kf_global[:y.store.n_kfs])
        for p, q in zip(x.vo.last_frame(), y.vo.last_frame()):
            assert torch.equal(p, q)


def test_fleet_programs_equal_eager(cuda, monkeypatch):
    """A two-sequence fleet with its lockstep attempts and check groups as
    CUDA-graph programs (``FLEET_GRAPHS``) against the eager fleet: every
    decision, step result, store and BoW row and keyframe pose bit for bit.
    Then an attempt with both sequences pending, a retry of one, and the
    largest check group of the run, each called as its program twice and
    eagerly on the same state: the same outputs; a program captured once a
    key (a second call captures nothing)."""
    from srba_slam_tpu_torch.ops import cuda_graphs
    from srba_slam_tpu_torch.parallel import batch

    voc = _fleet_vocabulary()
    seqs = _fleet_sequences((11, 23))
    runs = {}
    for graphs in (True, False):
        monkeypatch.setattr(batch, "FLEET_GRAPHS", graphs)
        captures = {k: cuda_graphs.capture_stats(k)["captures"]
                    for k in ("fleet_attempt", "fleet_check")}
        ests = _fleet_estimators(cuda, voc, 2)
        flt, rec, methods = _recording_fleet(ests)
        flt.run(seqs)
        runs[graphs] = (ests, rec, methods, {k: cuda_graphs.capture_stats(k)["captures"] - n
                                             for k, n in captures.items()})
    _assert_same_run(runs[True][0], runs[False][0])
    ests, rec, (attempt, check_group), captured = runs[True]
    # one check program a group size (1 or 2), whichever sequence leads it
    assert captured["fleet_attempt"] >= 1 and 1 <= captured["fleet_check"] <= 2
    assert runs[False][3] == {"fleet_attempt": 0, "fleet_check": 0}
    s, idx, lefts, rights = next(a for a in rec["attempts"] if len(a[1]) == 2)
    group = max(rec["checks"], key=lambda c: len(c[2]))
    calls = [lambda: attempt(s, idx, lefts, rights)[1:], lambda: attempt(s, idx[1:], lefts,
                                                                         rights)[1:],
             lambda: check_group(*group)]
    n = cuda_graphs.PROGRAM_STATS["captures"]
    for call in calls:
        monkeypatch.setattr(batch, "FLEET_GRAPHS", True)
        first = _leaves(call())
        n_first = cuda_graphs.PROGRAM_STATS["captures"]
        graph = _leaves(call())
        assert cuda_graphs.PROGRAM_STATS["captures"] == n_first
        monkeypatch.setattr(batch, "FLEET_GRAPHS", False)
        eager = _leaves(call())
        assert len(graph) == len(eager) == len(first) > 0
        for i, (x, y, z) in enumerate(zip(graph, eager, first)):
            assert x.dtype == y.dtype and torch.equal(x, y) and torch.equal(x, z), i
    # the run's attempt of two and check group had their programs; a retry
    # of one sequence alone may be a new key
    assert cuda_graphs.PROGRAM_STATS["captures"] <= n + 1


@pytest.mark.parametrize("n_shards", [1, 2])
def test_batched_vo_step_programs_equal_eager(cuda, monkeypatch, n_shards):
    """``batched_vo_step`` of two sequences over a mesh of the card (once,
    and twice: one sequence a shard), two steps, each shard's step one
    replay of its program: bit for bit the eager step (``FLEET_GRAPHS``
    off), its fleet means too; one K1 and one K2 launch a shard a step, and
    one more for each program's warm-up (the shards of one card share it)."""
    from srba_slam_tpu_torch.ops import cuda_graphs
    from srba_slam_tpu_torch.parallel import batch

    seqs = _fleet_sequences((11, 23), n_frames=3)
    cam = StereoCamera(**FLEET_CAM)
    mesh = batch.make_mesh(devices=[cuda] * n_shards)
    init = torch.zeros((2, 6), device=cuda)
    runs = {}
    for graphs in (True, False):
        monkeypatch.setattr(batch, "FLEET_GRAPHS", graphs)
        prev = batch.empty_features(2, 128, device=cuda)
        before = hopper_fast.fast_nms.launches
        captures = cuda_graphs.capture_stats("batched_step")["captures"]
        outs = []
        for j in (1, 2):
            out = batch.batched_vo_step(mesh, np.stack([q[j][0] for q in seqs]),
                                        np.stack([q[j][1] for q in seqs]), prev, init, cam,
                                        torch.tensor(12.0, device=cuda),
                                        torch.tensor(60, device=cuda), k=128)
            outs.append(out)
            prev = out[0]
        caps = cuda_graphs.capture_stats("batched_step")["captures"] - captures
        assert hopper_fast.fast_nms.launches - before == 2 * n_shards + caps
        assert (caps <= 1) if graphs else (caps == 0)
        runs[graphs] = outs
    for a, b in zip(runs[True], runs[False]):
        la, lb = _leaves(a), _leaves(b)
        assert len(la) == len(lb) == 13 + 4
        for i, (x, y) in enumerate(zip(la, lb)):
            assert x.dtype == y.dtype and torch.equal(x, y), i
    assert bool(runs[True][1][2].all()) and float(runs[True][1][4]) == 1.0


def fleet_launches_child() -> None:
    """:func:`test_fleet_programs_launch_no_kernels`' process: a two-sequence
    fleet over 10 frames through ``tools/fleet_launches.py`` ``measure``;
    prints its JSON object."""
    import json

    from srba_slam_tpu_torch.tools import fleet_launches

    ests = _fleet_estimators("cuda", _fleet_vocabulary(), 2)
    print(json.dumps(fleet_launches.measure(ests, _fleet_sequences((11, 23), n_frames=10))))


def test_fleet_programs_launch_no_kernels(cuda):
    """In a process of its own (traces of captured programs stay out of
    this one, ROADMAP Queue 3): a call of the lockstep-attempt program and
    of the check-group program launches no kernel and one graph (the eager
    calls hundreds of kernels); ``batched_vo_step`` on a mesh of the card
    twice one graph a shard, its only kernels the lead's gather and means."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.path.insert(0, 'tests'); import test_torch_cuda; "
            "test_torch_cuda.fleet_launches_child()")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["attempt n"] == 2 and got["check q"] >= 1 and got["shards"] == 2
    assert got["attempt program"][:2] == [0, 1] and got["check program"][:2] == [0, 1]
    assert got["attempt eager"][0] > 100 and got["check eager"][0] > 100
    step_kernels, step_graphs, _copies = got["step program"]
    assert step_graphs == 2 and step_kernels <= 3 * (13 + 4) < got["step eager"][0]


def test_fleet_attempts_and_checks_sync_nothing(cuda):
    """After a two-sequence fleet run with its programs, every lockstep
    attempt and check group that it made, called again on the same
    arguments under ``torch.cuda.set_sync_debug_mode("error")``: its
    uploads (pinned), its program's input copies, replay and output clones
    make no host sync."""
    voc = _fleet_vocabulary()
    ests = _fleet_estimators(cuda, voc, 2)
    flt, rec, (attempt, check_group) = _recording_fleet(ests)
    flt.run(_fleet_sequences((11, 23)))
    assert len(rec["attempts"]) >= 11 and rec["checks"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [attempt(*a)[2] for a in rec["attempts"]]
        outs += [check_group(*c) for c in rec["checks"]]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(torch.isfinite(o[3]).all() for o in outs[:len(rec["attempts"])])


def test_kernels_and_graphs_on_a_second_card(cuda):
    """Where the machine has two cards: K1 and K2 on ``cuda:1`` equal their
    plain versions bit for bit, and a window solve on ``cuda:1`` replayed
    as CUDA graphs equals its eager blocks, with ``cuda:0`` the current
    device throughout (the graph helper captures and replays on the
    tensors' card)."""
    from srba_slam_tpu_torch.ops import cuda_graphs, window_ba

    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA card")
    dev = torch.device("cuda", 1)
    rng = np.random.default_rng(2)
    with torch.cuda.device(0):
        imgs = torch.from_numpy(rng.integers(0, 256, (2, 370, 1226)).astype(np.uint8)).to(dev)
        scores = hopper_fast.fast_nms(imgs, 12.0)
        assert scores.device == dev
        assert torch.equal(scores, hopper_fast.fast_nms_plain(imgs, 12.0))
        ys, xs, _, valid = grid_topk(scores, cell=5, k=512)
        assert torch.equal(hopper_fast.orb_descriptors(imgs, ys, xs, valid),
                           hopper_fast.orb_descriptors_plain(imgs, ys, xs, valid))
        win = window_ba.BAWindow(*(a.to(dev) for a in _bucket_window(8, 512, 1024)))
        kw = dict(kernel_param=1.5, max_iters=8, stage1_iters=2)
        graph = window_ba.optimize_window(win, StereoCamera.kitti(), **kw)
        assert any(key[1] == dev for key in cuda_graphs._GRAPHS)
        window_ba.WBA_GRAPHS = False
        try:
            eager = window_ba.optimize_window(win, StereoCamera.kitti(), **kw)
        finally:
            window_ba.WBA_GRAPHS = True
    for field, a, b in zip(graph._fields, graph, eager):
        assert a.device == dev and torch.equal(a, b), field


@pytest.mark.parametrize("slots", [(0, 1, 2), (1, 4, 7)], ids=["front", "scattered"])
def test_window_group_graphs_match_eager_and_one_window(cuda, monkeypatch, slots):
    """A group of three windows in eight slots, valid at the front or
    scattered among padded slots (``solve_window_group``, one program on
    the card): CUDA-graph blocks give the eager blocks' bits, each slot its
    one-window solve's, the padded rows are zero, and once captured the
    group synchronizes nothing (set_sync_debug_mode "error" raises on a
    sync)."""
    from srba_slam_tpu_torch.ops import window_ba

    bucket = (8, 512, 1024)
    C, L, O = bucket
    ints, floats, valids = _packed_group(bucket, slots)
    cam = StereoCamera.kitti()
    kw = dict(kernel_param=1.5, max_iters=8, stage1_iters=2)

    def group():
        return window_ba.solve_window_group(ints, floats, valids, C, L, O, cam, cuda, **kw)

    graph = group()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = group()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(graph, again)
    monkeypatch.setattr(window_ba, "WBA_GRAPHS", False)
    eager = group()
    monkeypatch.setattr(window_ba, "WBA_GRAPHS", True)
    assert torch.equal(graph, eager)
    for i, v in enumerate(valids):
        if not v:
            assert not graph[i].any(), i
            continue
        plan = window_ba._packed_plan(ints[i], C, L, O, cuda)
        one = window_ba.optimize_window_packed_blob(
            torch.from_numpy(ints[i]).to(cuda), torch.from_numpy(floats[i]).to(cuda), C, L, O,
            cam, plan=plan, **kw)
        assert torch.equal(graph[i], one), i


CHECK_KW = dict(max_orb_distance_da=60.0, residual_th=10.0, max_y_diff_epipolar=1.5,
                filter_by_direction=False, ransac_n_hyp=64)


@pytest.fixture(scope="module")
def check_feats():
    """The small sequence's frames 0, 3, ..., 33 through the VO engine on
    the card (12 frames' features) and a vocabulary trained on them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from srba_slam_tpu_torch.models.bow import Vocabulary

    cam = StereoCamera(**SMALL_CAM)
    frames = list(SyntheticSource(cam, n_frames=34, seed=11, step=0.12))
    eng = StereoVOEngine(cam, VOOptions(fast_th=12, n_feats=256), capacity=256, device="cuda")
    feats = []
    for left, right in frames[::3]:
        eng.process_stereo_pair(left, right)
        feats.append(eng.last_frame())
    desc = np.concatenate([f.desc_l[f.m_valid].cpu().numpy() for f in feats])
    return cam, feats, Vocabulary.train(desc, k=8, L=3, seed=0)


def _check_parts(check_feats, max_kfs: int = 16):
    """A keyframe store and a BoW database on the card holding the first
    three frames as keyframes."""
    from srba_slam_tpu_torch.models.bow import BoWDatabase
    from srba_slam_tpu_torch.models.keyframe import KeyframeStore

    _cam, feats, voc = check_feats
    cuda = torch.device("cuda")
    store = KeyframeStore(max_kfs=max_kfs, capacity=256, device=cuda)
    bow = BoWDatabase(voc, max_kfs=max_kfs, device=cuda)
    for i, f in enumerate(feats[:3]):
        ids = np.where(f.m_valid.cpu().numpy(), 1000 * i + np.arange(256), -1)
        store.append(f, ids, np.zeros(6, np.float32))
        bow.insert(f.desc_l, f.m_valid)
    return store, bow


def _restore(store, bow, snap):
    """The store's and the database's contents set back in place (their
    tensors, and so a program's key, unchanged)."""
    for a, b in zip(list(store.arrays) + [bow._db], snap):
        a.copy_(b)


def _check_groups(check_feats, store, bow, n_valid: int, groups: int, row0: int, seed0: int):
    """``groups`` fused check groups of ``n_valid`` valid slots, dispatched
    back to back (group g checks frames g * n_valid, ... of the batch of
    frames 3-10 at rows row0 + g * n_valid, ...), their rows and seeds one
    slot table a group; returns every blob."""
    from srba_slam_tpu_torch.models import data_association as da
    from srba_slam_tpu_torch.models.vo import stack_features

    cam, feats, _voc = check_feats
    batch = stack_features(feats[3:11])
    pad = da.CHECK_SLOTS - n_valid
    blobs = []
    for g in range(groups):
        first = g * n_valid
        table = da.slot_table([row0 + first + i for i in range(n_valid)] + [0] * pad,
                              [seed0 + first + i for i in range(n_valid)] + [seed0] * pad,
                              store.arrays.desc_l.device)
        blobs += da.fused_checks_batch(batch, store.arrays, bow._db, bow._leaf_bits,
                                       bow._weights, [first + i for i in range(n_valid)] +
                                       [0] * pad, table[:, 0], [True] * n_valid + [False] * pad,
                                       cam, table[:, 1], **CHECK_KW)[0]
    return blobs


def _check_programs() -> list:
    from srba_slam_tpu_torch.ops import cuda_graphs

    return [p for p in cuda_graphs.programs() if p["key"][0] == "check"]


def _assert_same_check(a_blobs, a_parts, b_blobs, b_parts):
    assert len(a_blobs) == len(b_blobs)
    for i, (x, y) in enumerate(zip(a_blobs, b_blobs)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"blob {i}"
    (sa, ba), (sb, bb) = a_parts, b_parts
    for name, x, y in zip(sa.arrays._fields, sa.arrays, sb.arrays):
        assert torch.equal(x, y), name
    assert torch.equal(ba._db, bb._db)


@pytest.mark.parametrize("n_valid,groups", [(1, 1), (3, 1), (8, 1), (3, 2)],
                         ids=["slots1", "slots3", "slots8", "chained"])
def test_check_group_graphs_equal_eager(cuda, check_feats, monkeypatch, n_valid, groups):
    """Fused check groups as slot programs (one CUDA-graph replay a valid
    slot, the store and the database held and written in place) equal the
    eager groups (``CHECK_GRAPHS`` off) bit for bit on every blob and on
    the written store and database: 1, 3 and 8 valid slots, and two groups
    of 3 back to back (the second reads the rows the first wrote). Replayed
    at other rows and seeds, on the same store set back in place, the
    program gives the eager group's bits there and captures nothing: one
    program for the key."""
    from srba_slam_tpu_torch.models import data_association as da
    from srba_slam_tpu_torch.ops import cuda_graphs

    monkeypatch.setattr(cuda_graphs, "_PROGRAMS", {})
    eager_parts, graph_parts = _check_parts(check_feats), _check_parts(check_feats)
    snaps = [[t.clone() for t in list(s.arrays) + [b._db]] for s, b in (eager_parts,
                                                                          graph_parts)]
    for row0, seed0 in ((3, 7), (4, 50)):
        for parts, snap in zip((eager_parts, graph_parts), snaps):
            _restore(*parts, snap)
        monkeypatch.setattr(da, "CHECK_GRAPHS", False)
        eager = _check_groups(check_feats, *eager_parts, n_valid, groups, row0, seed0)
        monkeypatch.setattr(da, "CHECK_GRAPHS", True)
        captures = cuda_graphs.PROGRAM_STATS["captures"]
        graph = _check_groups(check_feats, *graph_parts, n_valid, groups, row0, seed0)
        torch.cuda.synchronize()
        _assert_same_check(eager, eager_parts, graph, graph_parts)
        assert cuda_graphs.PROGRAM_STATS["captures"] == captures + (row0 == 3)
        (prog,) = _check_programs()
        assert prog["key"][1] == "slot" and prog["steps"] >= 2 and prog["pool_bytes"] > 0
        assert prog["held_bytes"] > prog["copy_bytes"] > 0
        if row0 == 3:           # rows 0-2 hold keyframes: each slot tracks its previous row
            valid = [b for i, b in enumerate(eager) if i % da.CHECK_SLOTS < n_valid]
            tracked = [int(da.unpack_check_outputs(b.cpu().numpy(), s=5, k=256, nq=4)[4][0])
                       for b in valid]
            assert min(tracked) >= 15, tracked


@pytest.mark.parametrize("debug", [False, True])
def test_one_check_program_equals_eager(cuda, check_feats, monkeypatch, debug):
    """The strict path's check (``query_and_associate_packed``) as the
    one-check program equals the eager check bit for bit, with and without
    the debug section, at two counts and seeds of one program (one
    capture), and writes nothing."""
    from srba_slam_tpu_torch.models import data_association as da
    from srba_slam_tpu_torch.ops import cuda_graphs

    monkeypatch.setattr(cuda_graphs, "_PROGRAMS", {})
    cam, feats, _voc = check_feats
    store, bow = _check_parts(check_feats)
    before = [t.clone() for t in list(store.arrays) + [bow._db]]
    kw = dict(CHECK_KW, filter_by_direction=True, debug=debug)
    captures = cuda_graphs.PROGRAM_STATS["captures"]
    for n_kfs, seed, j in ((3, 7, 4), (2, 9, 5)):
        args = (feats[j], store.arrays, bow._db, bow._leaf_bits, bow._weights, n_kfs, cam, seed)
        monkeypatch.setattr(da, "CHECK_GRAPHS", False)
        (eager,) = da.query_and_associate_packed(*args, **kw)
        monkeypatch.setattr(da, "CHECK_GRAPHS", True)
        (graph,) = da.query_and_associate_packed(*args, **kw)
        assert torch.equal(eager, graph), (n_kfs, seed)
    assert cuda_graphs.PROGRAM_STATS["captures"] == captures + 1
    (prog,) = _check_programs()
    assert prog["key"][1] == "one" and prog["key"][7] is debug
    for a, b in zip(list(store.arrays) + [bow._db], before):
        assert torch.equal(a, b)


def test_check_program_captures_anew_for_a_replaced_store(cuda, check_feats, monkeypatch):
    """A store and a database put in place of the ones a slot program holds
    (other tensors, the same contents) capture a program of their own, and
    give the same bits."""
    from srba_slam_tpu_torch.ops import cuda_graphs

    monkeypatch.setattr(cuda_graphs, "_PROGRAMS", {})
    first, second = _check_parts(check_feats), _check_parts(check_feats)
    captures = cuda_graphs.PROGRAM_STATS["captures"]
    a = _check_groups(check_feats, *first, 3, 1, 3, 7)
    b = _check_groups(check_feats, *second, 3, 1, 3, 7)
    _assert_same_check(a, first, b, second)
    assert cuda_graphs.PROGRAM_STATS["captures"] == captures + 2
    assert len(_check_programs()) == 2


def test_fused_checks_batch_syncs_nothing(cuda, check_feats):
    """Three deferred checks of one batch on the card as one fused group:
    once its slot program is captured, the group (its slot table's pinned
    upload, three replays, the padded slots' zero blob) makes no host sync,
    and each slot equals the one-check path on the same rows bit for bit."""
    from srba_slam_tpu_torch.models import data_association as da
    from srba_slam_tpu_torch.models.vo import FrameFeatures, stack_features

    cam, feats, _voc = check_feats
    batch = stack_features(feats[3:6])
    js, rows, valids, seeds = [0, 1, 2] + [0] * 5, [3, 4, 5] + [0] * 5, [True] * 3 + [False] * 5, \
        [7, 8, 9] + [9] * 5
    store, bow = _check_parts(check_feats, max_kfs=8)
    snap = [t.clone() for t in list(store.arrays) + [bow._db]]
    da.fused_checks_batch(batch, store.arrays, bow._db, bow._leaf_bits, bow._weights, js, rows,
                          valids, cam, seeds, **CHECK_KW)          # captures the program
    _restore(store, bow, snap)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        blobs = da.fused_checks_batch(batch, store.arrays, bow._db, bow._leaf_bits,
                                      bow._weights, js, rows, valids, cam, seeds, **CHECK_KW)[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    one_store, one_bow = _check_parts(check_feats, max_kfs=8)
    for i in range(3):
        frame = FrameFeatures(*(a[i] for a in batch))
        one_store.write_row(frame, rows[i])
        one_bow.write_row(frame.desc_l, frame.m_valid, rows[i])
        (one,) = da.query_and_associate_packed(frame, one_store.arrays, one_bow._db,
                                               one_bow._leaf_bits, one_bow._weights, rows[i],
                                               cam, seeds[i], **CHECK_KW)
        assert torch.equal(one, blobs[i]), i
    assert not blobs[3].any()


def test_estimator_captures_its_check_program_after_warm_up(cuda, monkeypatch):
    """After a batched run on the card, ``capture_check_program`` leaves
    the estimator's one-check program captured (the bench harness calls it
    after its warm-up): a synchronous check of its store then captures
    nothing, and equals the eager check."""
    from srba_slam_tpu_torch.models import data_association as da
    from srba_slam_tpu_torch.ops import cuda_graphs

    cam = StereoCamera(**SMALL_CAM)
    frames = list(SyntheticSource(cam, n_frames=16, seed=11, step=0.12))
    opts = SRBAStereoSLAMOptions(
        orb_adaptive_fast_th=True, camera=cam, n_feats=256, detect_fast_th=12,
        adaptive_th_min_matches=40, max_translation=0.5, max_rotation=10.0,
        updated_matches_th=40, vo_id_tracking_th=30, srba_submap_size=5,
        srba_max_optimize_depth=3, da_filter_by_direction=False, residual_th=10.0)
    est = SRBAStereoSLAMEstimator(GeneralOptions(), opts, VOOptions(fast_th=12, n_feats=256),
                                  capacity=256, max_kfs=64, device=cuda)
    est.initialize()
    est.perform_stereo_slam_batched(frames, batch=4)
    assert est.store.n_kfs >= 2
    est.capture_check_program()
    captures = cuda_graphs.capture_stats("check")["captures"]
    args = (est.vo._prev, est.store.arrays, est.bow._db, est.bow._leaf_bits, est.bow._weights,
            est.store.n_kfs, cam, 5)
    (graph,) = da.query_and_associate_packed(*args, **est.check_options())
    assert cuda_graphs.capture_stats("check")["captures"] == captures
    monkeypatch.setattr(da, "CHECK_GRAPHS", False)
    (eager,) = da.query_and_associate_packed(*args, **est.check_options())
    assert torch.equal(graph, eager)


def test_uploader_runs_while_graphs_capture(cuda, monkeypatch):
    """The batched loop on the card from empty graph caches, its frame
    source slow enough that the uploader thread stages frames while the
    main thread captures the first GN, Jacobi and LM graphs (the GN,
    Jacobi and LM steps of the scans, the checks and the window groups in
    their programs' own caches): the captures succeed, and the run makes
    the card's per-frame decisions."""
    import time

    from srba_slam_tpu_torch.ops import cuda_graphs

    cam = StereoCamera(**SMALL_CAM)
    frames = list(SyntheticSource(cam, n_frames=30, seed=11, step=0.12))[:20]

    def make():
        opts = SRBAStereoSLAMOptions(
            orb_adaptive_fast_th=True, camera=cam, n_feats=256, detect_fast_th=12,
            adaptive_th_min_matches=40, max_translation=0.5, max_rotation=10.0,
            updated_matches_th=40, vo_id_tracking_th=30, srba_submap_size=5,
            srba_max_optimize_depth=3, da_filter_by_direction=False, residual_th=10.0)
        est = SRBAStereoSLAMEstimator(GeneralOptions(), opts, VOOptions(fast_th=12, n_feats=256),
                                      capacity=256, max_kfs=64, device=cuda)
        est.initialize()
        return est

    def slow(src):
        for f in src:
            time.sleep(0.02)
            yield f

    monkeypatch.setattr(cuda_graphs, "_GRAPHS", {})
    monkeypatch.setattr(cuda_graphs, "_PROGRAMS", {})
    batched = make()
    batched.perform_stereo_slam_batched(slow(frames), batch=4)
    kinds = {p["key"][0] for p in cuda_graphs.programs()}
    assert kinds == {"vo_scan", "check", "window_group"}
    assert len(cuda_graphs._GRAPHS) + sum(p["steps"] for p in cuda_graphs.programs()) >= 3
    assert [u["n"] for u in batched.lat["uploads"]] == [4, 4, 4, 4, 3]
    per_frame = make()
    for left, right in frames:
        per_frame.step(left, right)
    assert decisions(batched.step_log) == decisions(per_frame.step_log)
    assert batched.store.n_kfs == per_frame.store.n_kfs >= 3


def _packed_group(bucket, slots):
    """Host-packed windows of ``bucket`` in ``slots`` of WINDOW_SLOTS (a
    padded slot a copy of the first), as the engine passes a group."""
    from srba_slam_tpu_torch.ops import window_ba

    C, L, O = bucket
    packed = [window_ba.pack_window(*(a.numpy() for a in _bucket_window(C, L, O, seed)))
              for seed in range(len(slots))]
    at = dict(zip(slots, packed))
    full = [at.get(i, packed[0]) for i in range(window_ba.WINDOW_SLOTS)]
    return (np.stack([p[0] for p in full]), np.stack([p[1] for p in full]),
            [i in at for i in range(window_ba.WINDOW_SLOTS)])


GROUP_KW = dict(kernel_param=1.5, max_iters=8, stage1_iters=2)


@pytest.mark.parametrize("slots", [(0,), (0, 1, 2, 3), (1, 4, 7)],
                         ids=["one", "front4", "scattered"])
def test_window_group_program_equals_eager_and_one_window(cuda, monkeypatch, slots):
    """A group of windows of the (16, 1024, 2048) bucket through
    ``solve_window_group``: one program captured, then replayed under
    ``set_sync_debug_mode("error")`` (no host sync: its pinned upload, its
    input copy, the replay and the clone out); its rows equal the eager
    group's (``WBA_GROUP_PROGRAMS`` off) and each slot its one-window solve
    (``SRBAEngine._solve_window``'s), bit for bit; padded rows zero."""
    from srba_slam_tpu_torch.ops import cuda_graphs, window_ba

    bucket = (16, 1024, 2048)
    C, L, O = bucket
    ints, floats, valids = _packed_group(bucket, slots)
    cam = StereoCamera.kitti()

    def group():
        return window_ba.solve_window_group(ints, floats, valids, C, L, O, cam, cuda, **GROUP_KW)

    monkeypatch.setattr(cuda_graphs, "_PROGRAMS", {})    # an earlier test may hold its key
    captures = cuda_graphs.capture_stats("window_group")["captures"]
    graph = group()
    assert cuda_graphs.capture_stats("window_group")["captures"] == captures + 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = group()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cuda_graphs.capture_stats("window_group")["captures"] == captures + 1
    assert torch.equal(graph, again)
    monkeypatch.setattr(window_ba, "WBA_GROUP_PROGRAMS", False)
    eager = group()
    assert torch.equal(graph, eager)
    for i, v in enumerate(valids):
        if not v:
            assert not graph[i].any(), i
            continue
        win = window_ba.unpack_window(torch.from_numpy(ints[i]), torch.from_numpy(floats[i]),
                                      C, L, O)
        plan = window_ba.assembly_plan(*(a.numpy() for a in (
            win.obs_cam, win.obs_lm, win.lm_base, win.obs_valid)), C, L, cuda)
        one = window_ba.result_blob(window_ba.optimize_window(
            window_ba.BAWindow(*(a.to(cuda) for a in win)), cam, plan=plan, **GROUP_KW))
        assert torch.equal(graph[i], one), i


def test_pose_graph_program_equals_eager(cuda, monkeypatch):
    """The pose graph as one program (``PG_PROGRAM``) gives the bits of
    its parts launched from the host (``PG_PROGRAM`` off, its iterations
    graph replays); with the host's edges and inputs on the card a call
    makes no host sync before its result's read."""
    from srba_slam_tpu_torch.ops import cuda_graphs, posegraph

    args = _loop_graph_np(np.random.default_rng(30))
    args_c = [torch.from_numpy(a).to(cuda) for a in args]
    host = (args[2], args[3], args[5])

    def call():
        return posegraph.optimize_pose_graph(*args_c, max_iters=25, host_edges=host)

    monkeypatch.setattr(cuda_graphs, "_PROGRAMS", {})    # an earlier finalize may hold its key
    captures = cuda_graphs.capture_stats("posegraph")["captures"]
    prog = call()
    assert cuda_graphs.capture_stats("posegraph")["captures"] == captures + 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    monkeypatch.setattr(posegraph, "PG_PROGRAM", False)
    eager = call()
    for name, a, b, c in zip(("poses", "cost_init", "cost_final", "iters"), prog, again, eager):
        assert torch.equal(a, b) and torch.equal(a, c), name
    assert float(prog[2]) < 0.05 * float(prog[1])


def program_launches_child() -> None:
    """:func:`test_window_and_pose_graph_programs_launch_no_kernels`'
    process: one window group of three at (8, 512, 1024) and the pose graph
    of a loop, each eager (traced first) and as its program (traced last):
    kernel launches, graph launches and copies of one call. Prints one JSON
    object."""
    import json

    from srba_slam_tpu_torch.ops import posegraph, window_ba
    from srba_slam_tpu_torch.utils import kernel_timing as kt

    bucket = (8, 512, 1024)
    ints, floats, valids = _packed_group(bucket, (0, 1, 2))
    cam = StereoCamera.kitti()
    args = _loop_graph_np(np.random.default_rng(30))
    args_c = [torch.from_numpy(a).to("cuda") for a in args]

    def group():
        return window_ba.solve_window_group(ints, floats, valids, *bucket, cam, "cuda",
                                            **GROUP_KW)

    def pose_graph():
        return posegraph.optimize_pose_graph(*args_c, max_iters=25,
                                             host_edges=(args[2], args[3], args[5]))

    def counts(fn):
        evs = kt.profile_calls(fn)
        return [kt.launch_count(evs), sum(e.count for e in evs if "GraphLaunch" in e.key),
                sum(e.count for e in evs if e.key == "cudaMemcpyAsync")]

    got = {}
    window_ba.WBA_GROUP_PROGRAMS, posegraph.PG_PROGRAM = False, False
    got["group eager"], got["pose graph eager"] = counts(group), counts(pose_graph)
    window_ba.WBA_GROUP_PROGRAMS, posegraph.PG_PROGRAM = True, True
    got["group program"], got["pose graph program"] = counts(group), counts(pose_graph)
    print(json.dumps(got))


def test_window_and_pose_graph_programs_launch_no_kernels(cuda):
    """In a process of its own (traces of captured programs stay out of
    this one, ROADMAP Queue 3): a call of a window group's program and of
    the pose graph's program launches no kernel and one graph; eagerly the
    group launches hundreds of kernels and graphs a slot, the pose graph
    its kernels and one graph an iteration."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.path.insert(0, 'tests'); import test_torch_cuda; "
            "test_torch_cuda.program_launches_child()")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["group program"][:2] == [0, 1] and got["pose graph program"][:2] == [0, 1]
    assert got["group eager"][0] > 100 and got["group eager"][1] >= 3
    assert got["pose graph eager"][0] > 10 and got["pose graph eager"][1] == 25


def _small_estimator(cuda):
    cam = StereoCamera(**SMALL_CAM)
    opts = SRBAStereoSLAMOptions(
        orb_adaptive_fast_th=True, camera=cam, n_feats=256, detect_fast_th=12,
        adaptive_th_min_matches=40, max_translation=0.5, max_rotation=10.0,
        updated_matches_th=40, vo_id_tracking_th=30, srba_submap_size=5,
        srba_max_optimize_depth=3, da_filter_by_direction=False, residual_th=10.0)
    est = SRBAStereoSLAMEstimator(GeneralOptions(), opts, VOOptions(fast_th=12, n_feats=256),
                                  capacity=256, max_kfs=64, device=cuda)
    est.initialize()
    return est


def test_programs_of_a_deleted_estimator_are_freed(cuda):
    """A batched run on the card captures check programs that hold the
    estimator's store, database and vocabulary, and programs that hold
    nothing (its scans, its window groups). Once the estimator is deleted
    and collected, its check programs are gone from ``programs()`` and
    their pools go back to the card (``memory_reserved`` after
    ``empty_cache`` falls by at least their pools); the programs without
    held tensors stay, and the next estimator replays them."""
    import gc

    from srba_slam_tpu_torch.ops import cuda_graphs

    cam = StereoCamera(**SMALL_CAM)
    frames = list(SyntheticSource(cam, n_frames=20, seed=11, step=0.12))
    gc.collect()
    earlier = {p["token"] for p in cuda_graphs.programs()}
    est = _small_estimator(cuda)
    est.perform_stereo_slam_batched(frames, batch=4)
    est.rba.flush()
    assert est.store.n_kfs >= 3
    mine = [p for p in cuda_graphs.programs()
            if p["key"][0] == "check" and p["token"] not in earlier]
    shared = {p["token"] for p in cuda_graphs.programs() if p["held_bytes"] == 0}
    assert mine and any(p["key"][0] == "window_group" for p in cuda_graphs.programs()
                        if p["token"] in shared)
    pools = sum(p["pool_bytes"] + p["body_bytes"] for p in mine)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(cuda)
    del est
    gc.collect()
    tokens = {p["token"] for p in cuda_graphs.programs()}   # frees the dropped ones' graphs
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved(cuda)
    assert not tokens & {p["token"] for p in mine}
    assert shared <= tokens
    assert before - after >= pools, (before, after, pools)
    captures = cuda_graphs.capture_stats("window_group")["captures"]
    again = _small_estimator(cuda)
    again.perform_stereo_slam_batched(frames, batch=4)
    again.rba.flush()
    assert cuda_graphs.capture_stats("window_group")["captures"] == captures


SHARD_KW = dict(kernel_param=1.5, max_iters=8, stage1_iters=2)
SHARD_BUCKET = (16, 1024, 2048)


def _sharded(devices, seed=5, bucket=SHARD_BUCKET):
    """A window of ``bucket`` laid out over ``devices`` from its host arrays
    (the engine's form)."""
    from srba_slam_tpu_torch.ops import window_ba
    from srba_slam_tpu_torch.parallel.batch import make_mesh

    win = _bucket_window(*bucket, seed=seed)
    return window_ba.shard_window_obs(window_ba.BAWindow(*(a.numpy() for a in win)),
                                      make_mesh(devices=devices, axis="obs"))


def _sharded_eager(sw, cam, monkeypatch):
    from srba_slam_tpu_torch.ops import window_ba

    with monkeypatch.context() as m:
        m.setattr(window_ba, "WBA_SHARD_PROGRAMS", False)
        return window_ba.optimize_window(sw, cam, **SHARD_KW)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_programs_equal_eager(cuda, monkeypatch, n_shards):
    """A window of the (16, 1024, 2048) bucket sharded over ``cuda:0`` x n:
    its programs (one a shard and one a lead step, captured at the first
    solve) give the eager LM blocks' bits; a second window of the bucket,
    in other buffers, captures nothing, replays under
    ``set_sync_debug_mode("error")`` (no host sync from its upload to its
    result row) and equals its own eager route."""
    from srba_slam_tpu_torch.ops import cuda_graphs, window_ba

    cam = StereoCamera.kitti()
    monkeypatch.setattr(cuda_graphs, "_PROGRAMS", {})
    first = _sharded(["cuda:0"] * n_shards)
    caps = cuda_graphs.capture_stats("window_shard")["captures"]
    prog = window_ba.optimize_window(first, cam, **SHARD_KW)
    made = cuda_graphs.capture_stats("window_shard")["captures"] - caps
    # 2 shard programs a shard (stage 1, stage 2) and 5 on the lead
    assert made == 2 * n_shards + 5, made
    for field, a, b in zip(prog._fields, prog, _sharded_eager(first, cam, monkeypatch)):
        assert torch.equal(a, b), field
    assert float(prog.cost_final) < float(prog.cost_init)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = _sharded(["cuda:0"] * n_shards, seed=6)
        blob = window_ba.optimize_window_blob(second, cam, **SHARD_KW)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cuda_graphs.capture_stats("window_shard")["captures"] - caps == made
    assert torch.equal(blob, window_ba.result_blob(_sharded_eager(second, cam, monkeypatch)))
    assert not torch.equal(blob, window_ba.result_blob(prog))


def test_sharded_programs_on_distinct_cards(cuda, monkeypatch):
    """Where the machine has two cards: a window sharded over ``cuda:0``
    and ``cuda:1``, its state and partial sums crossing the cards as copies
    ordered by events, equals its eager route bit for bit, with no host
    sync after the capture."""
    from srba_slam_tpu_torch.ops import window_ba

    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA card")
    cam = StereoCamera.kitti()
    sw = _sharded(["cuda:0", "cuda:1"])
    prog = window_ba.optimize_window(sw, cam, **SHARD_KW)
    for field, a, b in zip(prog._fields, prog, _sharded_eager(sw, cam, monkeypatch)):
        assert torch.equal(a, b), field
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = window_ba.optimize_window_blob(sw, cam, **SHARD_KW)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(again, window_ba.result_blob(prog))


def _engine_sequence(engine) -> np.ndarray:
    """Six keyframes 0.8 m apart over 80 landmarks through ``engine``, then
    the keyframes' global poses."""
    from srba_slam_tpu_torch.utils import se3_np

    cam = StereoCamera.kitti()
    rng = np.random.default_rng(5)
    lms_w = np.stack([rng.uniform(-6, 6, 80), rng.uniform(-2, 2, 80),
                      rng.uniform(8, 25, 80)], -1)
    for kf in range(6):
        inv = se3_np.inverse(np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.8 * kf]))
        pcs = [(j, se3_np.transform_point(inv, pw)) for j, pw in enumerate(lms_w)]
        pcs = [(j, pc) for j, pc in pcs if pc[2] >= 2.0]
        px = [[cam.cx_l + cam.fx_l * pc[0] / pc[2], cam.cy_l + cam.fy_l * pc[1] / pc[2],
               cam.cx_r + cam.fx_r * (pc[0] - cam.baseline) / pc[2]] for _j, pc in pcs]
        if kf:
            engine.set_initial_kf_pose(np.array([0, 0, 0, 0, 0, 0.8]))
        engine.define_new_keyframe((np.asarray([j for j, _ in pcs], np.int64),
                                    np.asarray(px, np.float64),
                                    np.asarray([pc for _, pc in pcs], np.float64)),
                                   run_opt=kf > 0)
    engine.flush()
    return engine.kf_global[:6].copy()


def test_mesh_engine_programs_equal_eager(cuda, monkeypatch):
    """``SRBAEngine(mesh=)`` on ``cuda:0`` x 4: the keyframe poses with the
    sharded programs equal those of the eager route; a second engine's run
    captures no program, and ``capture_window_programs`` of a bucket met
    captures nothing more."""
    from srba_slam_tpu_torch.models.srba import SRBAEngine, SRBAParams
    from srba_slam_tpu_torch.ops import cuda_graphs, window_ba
    from srba_slam_tpu_torch.parallel.batch import make_mesh

    p = SRBAParams(submap_size=4, max_optimize_depth=3, max_kfs=16, win_cams=8, win_lms=1024,
                   win_obs=2048)
    cam = StereoCamera.kitti()

    def engine():
        return SRBAEngine(cam, p, mesh=make_mesh(devices=["cuda:0"] * 4, axis="obs"))

    prog = _engine_sequence(engine())
    caps = cuda_graphs.capture_stats("window_shard")["captures"]
    again = engine()
    assert np.array_equal(_engine_sequence(again), prog)
    assert again.capture_window_programs() == []
    assert cuda_graphs.capture_stats("window_shard")["captures"] == caps
    with monkeypatch.context() as m:
        m.setattr(window_ba, "WBA_SHARD_PROGRAMS", False)
        eager = _engine_sequence(engine())
    assert np.array_equal(prog, eager)


def sharded_launches_child() -> None:
    """:func:`test_sharded_solve_launches_no_kernels`' process: one sharded
    solve over ``cuda:0`` x 4, eager (traced first) and as its programs
    (traced last): kernel launches, graph launches and copies of one call.
    Prints one JSON object."""
    import json

    from srba_slam_tpu_torch.ops import window_ba
    from srba_slam_tpu_torch.utils import kernel_timing as kt

    sw = _sharded(["cuda:0"] * 4)
    cam = StereoCamera.kitti()

    def solve():
        return window_ba.optimize_window_blob(sw, cam, **SHARD_KW)

    def counts(fn):
        evs = kt.profile_calls(fn)
        return [kt.launch_count(evs), sum(e.count for e in evs if "GraphLaunch" in e.key),
                sum(e.count for e in evs if e.key == "cudaMemcpyAsync")]

    window_ba.WBA_SHARD_PROGRAMS = False
    got = {"eager": counts(solve)}
    window_ba.WBA_SHARD_PROGRAMS = True
    got["programs"] = counts(solve)
    print(json.dumps(got))


def test_sharded_solve_launches_no_kernels(cuda):
    """In a process of its own: a sharded solve on its programs launches no
    kernel, and one graph a shard and one on the lead a round (the first
    state, 2 pose-only iterations, the switch, 8 iterations, the end: 13
    rounds); eagerly it launches thousands of kernels."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.path.insert(0, 'tests'); import test_torch_cuda; "
            "test_torch_cuda.sharded_launches_child()")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["programs"][:2] == [0, 13 * 5], got
    assert got["eager"][0] > 1000, got
