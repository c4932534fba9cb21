"""Kernel rooflines on one H100: the work a call needs, its least time, and
the card's own time for it.

The work is counted from the inputs, each input byte read once and each
output byte written once, and the f32 operations the inputs need:

* K1 (FAST-9/16 scores with 5x5 suppression, ``csrc/fast_nms.cu``) on
  ``[N, H, W]`` frames: reads the frames, writes an f32 score a pixel; an
  inner pixel whose compass-pair bound (the score's formula over the four
  pairs of neighbouring 12/3/6/9 o'clock taps) is at or under the threshold
  needs 21 operations, one that passes it 180 for its whole score, and one
  that keeps a score 11 more for its key and suppression;
* K2 (7x7 blur and 256 upright BRIEF tests, ``csrc/orb_describe.cu``): reads
  the frame pixels under the blur supports of the distinct sampled points,
  the keypoints (y, x, valid), writes 32 bytes a keypoint; 28 operations a
  distinct sampled point (the separable blur) and 256 compares a valid
  keypoint.

The least time is the larger of the bytes over 3.35 TB/s and the operations
over 67 TFLOP/s (the published f32 rate outside the tensor cores of an H100
SXM at 700 W). ``graph_ms`` times a call on the card alone: ``reps`` calls
captured in one CUDA graph, replayed between two CUDA events.
"""

from __future__ import annotations

import statistics

import torch

from slam_bench.reference import frontend

H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12
COMPASS_OPS_PER_PX = 21
FAST_SCORE_OPS_PER_PX = 180
NMS_OPS_PER_PX = 11
BLUR_OPS_PER_POINT = 28


def bound_ms(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / H100_BYTES_PER_S, n_ops / H100_F32_OPS_PER_S) * 1e3


def k1_work(imgs: torch.Tensor, threshold: float, margin: int = 16) -> tuple[int, int]:
    """(bytes, f32 operations) K1 needs on ``imgs`` [N, H, W]."""
    x = imgs.to(torch.float32)
    n, h, w = x.shape
    c = x[:, margin:h - margin, margin:w - margin]
    d = [x[:, margin + dy:h - margin + dy, margin + dx:w - margin + dx] - c
         for dy, dx in ((-3, 0), (0, 3), (3, 0), (0, -3))]
    bound = torch.stack([torch.maximum(torch.minimum(a, b), -torch.maximum(a, b))
                         for a, b in zip(d, d[1:] + d[:1])]).amax(0)
    n_pass = int((bound > threshold).sum())
    th = torch.full((n,), float(threshold), device=x.device)
    n_kept = int((frontend.suppress(frontend.fast_scores(x, th, margin)) > 0).sum())
    n_bytes = x.numel() * imgs.element_size() + x.numel() * 4
    n_ops = (c.numel() - n_pass) * COMPASS_OPS_PER_PX + n_pass * FAST_SCORE_OPS_PER_PX \
        + n_kept * NMS_OPS_PER_PX
    return n_bytes, n_ops


def k2_work(imgs: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, valid: torch.Tensor
            ) -> tuple[int, int]:
    """(bytes, f32 operations) K2 needs for the keypoints ``ys``/``xs``
    [N, K] (``valid``) on ``imgs`` [N, H, W]."""
    n, h, w = imgs.shape
    off = torch.as_tensor(frontend.PATTERN, device=imgs.device)
    img_idx = torch.arange(n, device=imgs.device)[:, None, None]
    pts = []
    for dy, dx in ((off[:, 0], off[:, 1]), (off[:, 2], off[:, 3])):
        yy = (ys[..., None].long() + dy).clamp(0, h - 1)
        xx = (xs[..., None].long() + dx).clamp(0, w - 1)
        pts.append(((img_idx * h + yy) * w + xx)[valid])
    points = torch.unique(torch.cat(pts).flatten())
    r = torch.arange(-3, 4, device=imgs.device)
    py = (points // w % h)[:, None, None] + r[None, :, None]
    px = (points % w)[:, None, None] + r[None, None, :]
    inside = (py >= 0) & (py < h) & (px >= 0) & (px < w)
    support = torch.unique((((points // (h * w))[:, None, None] * h + py) * w + px)[inside])
    n_kp = ys.numel()
    n_bytes = support.numel() * imgs.element_size() + n_kp * (4 + 4 + 1) + n_kp * 8 * 4
    n_ops = points.numel() * BLUR_OPS_PER_POINT + int(valid.sum()) * 256
    return n_bytes, n_ops


def graph_ms(fn, reps: int = 100, replays: int = 5) -> float:
    """Device ms a call of ``fn`` on the current card: ``reps`` calls in one
    CUDA graph after 3 warm-up calls, the median of ``replays`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(times)


def kernel_shares(imgs: torch.Tensor, threshold: float, k: int, cell: int = 5) -> dict:
    """K1's and K2's share of their rooflines, in %, at the scan's frames
    ``imgs`` [N, H, W] on the card, with the keypoints the reference finds."""
    from srba_slam_tpu_torch.ops import hopper_fast

    n = imgs.shape[0]
    th = torch.full((n,), float(threshold), dtype=torch.float32, device=imgs.device)
    s = frontend.suppress(frontend.fast_scores(imgs, th))
    ys, xs, _sc, valid = frontend.cell_topk(s, cell, k)
    k1_ms = graph_ms(lambda: hopper_fast.fast_nms(imgs, th, margin=16, radius=2))
    k2_ms = graph_ms(lambda: hopper_fast.orb_descriptors(imgs, ys, xs, valid))
    k1_b, k1_o = k1_work(imgs, threshold)
    k2_b, k2_o = k2_work(imgs, ys, xs, valid)
    return dict(k1=100.0 * bound_ms(k1_b, k1_o) / k1_ms, k2=100.0 * bound_ms(k2_b, k2_o) / k2_ms,
                k1_ms=k1_ms, k2_ms=k2_ms)
