"""The port's single-card entry point ``entry()`` against the JAX package's.

``parallel/multichip.py`` ``entry(device)`` ≙ ``__graft_entry__.py``
``entry()``: ``(fn, example_args)`` of the stereo-VO step
(``extract_and_match`` then ``track_and_solve``, FAST 20, ORB 60).
``vo_step(h, w, k)`` builds it at another size.

* At 96x128, k = 64, on the CPU, against the JAX package's
  ``extract_and_match`` + ``track_and_solve`` on the same inputs: the
  seeded example frames (``default_rng(0)`` uniform f32; independent left
  and right images, so no stereo match survives: the JAX entry's inputs
  too), and two rendered frames of a plane scene, where the step matches
  and solves. ``m_valid`` and ``num_inliers`` exact, pose within 1e-4 (the
  GN normal sums run in another order).
* ``entry(device="cpu")`` gives the example arguments and outputs of the
  shapes and dtypes of ``__graft_entry__.entry()``'s (JAX traced with
  ``jax.eval_shape``, not run; uint32 descriptor words are int32 in the
  port, same bits).
* Slow: the full-size step against JAX's ``entry()`` run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srba_slam_tpu.models import vo as jvo
from srba_slam_tpu.utils.camera import StereoCamera as JCam
from srba_slam_tpu_torch.models.vo import extract_and_match, frame_features_from_numpy
from srba_slam_tpu_torch.parallel import multichip
from srba_slam_tpu_torch.utils.camera import StereoCamera
from srba_slam_tpu_torch.utils.synthworld import PlaneScene

torch.set_num_threads(1)

POSE_TOL = 1e-4
CAM_KW = dict(fx_l=64.0, fy_l=64.0, cx_l=64.0, cy_l=48.0, fx_r=64.0, fy_r=64.0, cx_r=64.0,
              cy_r=48.0, baseline=0.5, width=128, height=96)
H, W, K = 96, 128, 64


def _jax_step(cam, k):
    def step(left, right, prev, init_pose):
        cur = jvo.extract_and_match(left, right, cam, jnp.float32(multichip.ENTRY_FAST_TH),
                                    jnp.int32(multichip.ENTRY_ORB_TH), k=k)
        out = jvo.track_and_solve(prev, cur, cam, init_pose, jnp.int32(multichip.ENTRY_ORB_TH))
        return out.pose.pose, out.pose.num_inliers, cur.m_valid
    return step


def _jax_args(left, right, prev_pair, cam, k):
    prev = jvo.extract_and_match(jnp.asarray(prev_pair[0], jnp.float32),
                                 jnp.asarray(prev_pair[1], jnp.float32), cam,
                                 jnp.float32(multichip.ENTRY_FAST_TH),
                                 jnp.int32(multichip.ENTRY_ORB_TH), k=k)
    return (jnp.asarray(left, jnp.float32), jnp.asarray(right, jnp.float32), prev,
            jnp.zeros(6, jnp.float32))


def _assert_same(got, ref):
    pose, n_inl, m_valid = (np.asarray(x) for x in ref)
    assert np.array_equal(got[2].numpy(), m_valid)
    assert int(got[1]) == int(n_inl)
    np.testing.assert_allclose(got[0].numpy(), pose, atol=POSE_TOL)


def _plane_pairs():
    scene = PlaneScene(np.random.default_rng(3))
    cam = StereoCamera(**CAM_KW)
    return [scene.render(cam, np.zeros(6, np.float32)),
            scene.render(cam, np.array([0.0, 0.01, 0.0, 0.03, 0.0, 0.08], np.float32))]


@pytest.mark.parametrize("inputs", ["example", "plane"])
def test_vo_step_matches_jax(inputs):
    cam = StereoCamera(**CAM_KW)
    fn, args = multichip.vo_step(H, W, K, device="cpu", cam=cam)
    if inputs == "example":
        left, right = (a.numpy() for a in args[:2])
        prev_pair = (left, right)
    else:
        prev_pair, (left, right) = _plane_pairs()
        args = (torch.from_numpy(left.astype(np.float32)),
                torch.from_numpy(right.astype(np.float32)),
                extract_and_match(prev_pair[0], prev_pair[1], cam, multichip.ENTRY_FAST_TH,
                                  multichip.ENTRY_ORB_TH, k=K, device="cpu"),
                args[3])
    jcam = JCam(**CAM_KW)
    jargs = _jax_args(left, right, prev_pair, jcam, K)
    # the step's inputs are the same: the port's prev equals JAX's on every
    # integer field
    jprev = frame_features_from_numpy(jax.tree_util.tree_map(np.asarray, jargs[2]), "cpu")
    for name in ("ys_l", "xs_l", "valid_l", "desc_l", "m_r_idx", "m_valid"):
        assert torch.equal(getattr(args[2], name), getattr(jprev, name)), name
    got = fn(*args)
    _assert_same(got, _jax_step(jcam, K)(*jargs))
    if inputs == "plane":
        assert int(got[1]) > 20 and bool(got[2].any())


def test_entry_shapes_and_dtypes_match_the_jax_entry():
    import __graft_entry__

    jfn, jargs = __graft_entry__.entry()
    fn, args = multichip.entry(device="cpu")

    def spec(x):
        dtype = np.dtype(str(x.dtype).replace("torch.", ""))
        # the port keeps uint32 descriptor words as int32, same bits
        # (models/vo.py frame_features_from_numpy)
        return tuple(x.shape), np.dtype(np.int32) if dtype == np.uint32 else dtype

    flat_j = jax.tree_util.tree_leaves(jargs)
    flat_t = [args[0], args[1], *args[2], args[3]]
    assert [spec(a) for a in flat_t] == [spec(a) for a in flat_j]
    out_j = jax.eval_shape(jfn, *jargs)
    out_t = fn(*args)
    assert [spec(a) for a in out_t] == [spec(a) for a in out_j]
    assert all(a.device.type == "cpu" for a in (*flat_t, *out_t))


@pytest.mark.slow
def test_entry_matches_the_jax_entry_at_full_size():
    import __graft_entry__

    jfn, jargs = __graft_entry__.entry()
    fn, args = multichip.entry(device="cpu")
    np.testing.assert_array_equal(args[0].numpy(), np.asarray(jargs[0]))
    _assert_same(fn(*args), jax.jit(jfn)(*jargs))

