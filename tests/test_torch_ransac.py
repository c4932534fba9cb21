"""Port parity: ops/ransac.py against the JAX package's ransac_fundamental,
on the same numpy inputs and the same key (the draws are JAX's bits,
ops/prng.py, held bit-identical in test_torch_prng.py).

Tolerance: the RANSAC index draws are bit-exact; the inlier mask and count
are identical; F agrees to 1e-4 after scaling to unit norm (f32 sums in
another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srba_slam_tpu.ops import ransac as jr
from srba_slam_tpu_torch.ops import prng
from srba_slam_tpu_torch.ops import ransac as tr

# one CPU thread per test process: the ops here are small, and the parallel
# test workers would otherwise oversubscribe the cores
torch.set_num_threads(1)


def _two_view(rng, n=128, outlier_frac=0.0, noise=0.0):
    from srba_slam_tpu.utils import se3_np
    from srba_slam_tpu.utils.camera import StereoCamera

    cam = StereoCamera.kitti()
    pts = np.stack([rng.uniform(-10, 10, n), rng.uniform(-3, 3, n),
                    rng.uniform(6, 40, n)], -1)
    pose = np.array([0.02, -0.05, 0.01, 0.4, 0.1, 1.5])
    x1 = cam.cx_l + cam.fx_l * pts[:, 0] / pts[:, 2]
    y1 = cam.cy_l + cam.fy_l * pts[:, 1] / pts[:, 2]
    pc2 = np.stack([se3_np.transform_point(se3_np.inverse(pose), p) for p in pts])
    x2 = cam.cx_l + cam.fx_l * pc2[:, 0] / pc2[:, 2]
    y2 = cam.cy_l + cam.fy_l * pc2[:, 1] / pc2[:, 2]
    x1 += rng.normal(0, noise, n); y1 += rng.normal(0, noise, n)
    x2 += rng.normal(0, noise, n); y2 += rng.normal(0, noise, n)
    n_out = int(n * outlier_frac)
    if n_out:
        sel = rng.choice(n, n_out, replace=False)
        x2[sel] += rng.uniform(25, 120, n_out) * rng.choice([-1, 1], n_out)
        y2[sel] += rng.uniform(25, 120, n_out) * rng.choice([-1, 1], n_out)
    # integer pixels, as the DA cascade feeds it
    return [np.round(a).astype(np.float32) for a in (x1, y1, x2, y2)]


@pytest.mark.parametrize("case", [
    dict(n=128, frac=0.3, noise=0.3, n_valid=128, n_hyp=128, key=1),
    dict(n=512, frac=0.4, noise=0.5, n_valid=300, n_hyp=64, key=7),
    dict(n=512, frac=0.2, noise=0.0, n_valid=40, n_hyp=128, key=12),
])
def test_ransac_matches_jax(case):
    rng = np.random.default_rng(case["key"])
    x1, y1, x2, y2 = _two_view(rng, case["n"], case["frac"], case["noise"])
    valid = np.zeros(case["n"], bool)
    valid[rng.choice(case["n"], case["n_valid"], replace=False)] = True
    kj = jax.random.PRNGKey(case["key"])
    inl_j, cnt_j, F_j = jr.ransac_fundamental(
        *map(jnp.asarray, (x1, y1, x2, y2)), jnp.asarray(valid), kj,
        threshold=1.5, n_hyp=case["n_hyp"])
    kt = prng.PRNGKey(case["key"])
    inl_t, cnt_t, F_t = tr.ransac_fundamental(
        *map(torch.from_numpy, (x1, y1, x2, y2)), torch.from_numpy(valid), kt,
        threshold=1.5, n_hyp=case["n_hyp"])
    # the index draws: JAX's top_k(-r, 8) order vs the port's stable sort
    r = jax.random.uniform(kj, (case["n_hyp"], case["n"]))
    r = jnp.where(jnp.asarray(valid)[None, :], r, 2.0)
    idx_j = np.asarray(jax.lax.top_k(-r, 8)[1])
    idx_t = tr.sample_indices(torch.from_numpy(valid), kt, case["n_hyp"]).numpy()
    np.testing.assert_array_equal(idx_j, idx_t)
    assert int(cnt_j) == int(cnt_t)
    np.testing.assert_array_equal(np.asarray(inl_j), inl_t.numpy())
    fj = np.asarray(F_j) / np.linalg.norm(np.asarray(F_j))
    ft = F_t.numpy() / np.linalg.norm(F_t.numpy())
    np.testing.assert_allclose(fj * np.sign(fj.ravel()[np.abs(fj).argmax()]),
                               ft * np.sign(ft.ravel()[np.abs(ft).argmax()]), atol=1e-4)


def test_hypotheses_for_prob_matches():
    for p in (0.5, 0.9, 0.95, 0.99, 0.999):
        assert tr.hypotheses_for_prob(p) == jr.hypotheses_for_prob(p)
