"""The bodies of the sharded window's programs, on the CPU.

On a card a sharded window (``ops/window_ba.py`` ``shard_window_obs``)
solves in rounds of one program a shard and one on the lead
(``_solve_sharded``); on the CPU the same bodies run eagerly, so here they
are held to the eager sharded route (``WBA_SHARD_PROGRAMS = False``: the
LM blocks shard by shard each step) and to JAX's SPMD solve.

* The bodies composed eagerly = the eager sharded route, bit for bit, at
  1, 2 and 8 shards, with and without the pose-only stage 1, with and
  without the robust kernel; and at exit periods 1 and 3, where the host
  reads the exit test between blocks.
* Within ``POSE_TOL`` / ``LM_TOL`` (tests/test_torch_mesh.py's) of JAX's
  sharded ``optimize_window`` on its 8 virtual devices; one shard = the
  unsharded solve, bit for bit.
* Neither the shard nor the lead bodies read the device on the host
  (every Tensor host read patched to raise) at the engine's 8 iterations a
  stage, nor at an exit period of 2 with the exits unread.
* ``shard_key`` and the programs' full keys are the bucket's: two windows
  of a bucket, in buffers at other addresses, share them; an option, the
  bucket, the mesh or the exit period changes them.
* ``shard_window_obs`` of the host arrays = of the tensors, view for view.
* ``SRBAEngine(mesh=)`` gives the same keyframe poses on the bodies as on
  the eager route.
* ``cuda_graphs.program``'s fixed inputs: copied in again only for other
  tensors, or tensors written in place since.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from srba_slam_tpu.ops import window_ba as jwb
from srba_slam_tpu.utils.camera import StereoCamera as JCam
from srba_slam_tpu_torch.models.srba import SRBAEngine, SRBAParams
from srba_slam_tpu_torch.ops import cuda_graphs
from srba_slam_tpu_torch.ops import window_ba as twb
from srba_slam_tpu_torch.utils.camera import StereoCamera

from test_torch_mesh import LM_TOL, POSE_TOL, _cpu_mesh, _engine_run, _jax_mesh
from test_window_ba import _make_window

torch.set_num_threads(1)

CAM = StereoCamera.kitti()
KW = dict(kernel_param=1.5, max_iters=10)
STAGES = {"one_stage": {}, "stage1": dict(stage1_iters=2)}
KERNELS = {"robust": {}, "plain": dict(use_kernel=False, use_kernel_stage1=False)}


def _window(seed: int = 0):
    """tests/test_window_ba.py's window (C 8, L 128, O 512), as numpy
    arrays and as the port's tensors."""
    win, _gt_cam, _ = _make_window(np.random.default_rng(seed), px_noise=0.3)
    arrays = [np.array(a) for a in win]
    return win, arrays, twb.BAWindow(*(torch.from_numpy(a) for a in arrays))


def _eager(win, monkeypatch, **kw):
    """The eager sharded route's solve (the LM blocks shard by shard)."""
    with monkeypatch.context() as m:
        m.setattr(twb, "WBA_SHARD_PROGRAMS", False)
        return twb.optimize_window(win, CAM, **kw)


def _assert_same(a, b):
    for name, x, y in zip(twb.BAResult._fields, a, b):
        assert torch.equal(x, y), name


def _raise_on_host_reads(monkeypatch):
    """Every host read of a Tensor raises (a read inside a block would
    stall the lead's queue on the card)."""
    def read(*_a, **_k):
        raise AssertionError("a host read")

    for name in ("item", "__bool__", "__int__", "__float__", "tolist", "numpy", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, read)


@pytest.mark.parametrize("kernel", KERNELS.values(), ids=KERNELS.keys())
@pytest.mark.parametrize("stages", STAGES.values(), ids=STAGES.keys())
@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_bodies_equal_the_eager_sharded_route(monkeypatch, n_shards, stages, kernel):
    _, _, twin = _window()
    sharded = twb.shard_window_obs(twin, _cpu_mesh(n_shards, "obs"))
    kw = dict(KW, **stages, **kernel)
    got = twb.optimize_window(sharded, CAM, **kw)
    _assert_same(got, _eager(sharded, monkeypatch, **kw))
    assert float(got.cost_final) < float(got.cost_init)
    blob = twb.optimize_window_blob(sharded, CAM, **kw)
    assert torch.equal(blob, twb.result_blob(got))


@pytest.mark.parametrize("exit_every", [1, 3])
def test_bodies_equal_eager_between_blocks(monkeypatch, exit_every):
    """Blocks shorter than a stage: the host reads the exit test between
    them on both routes, which stop at the same block."""
    monkeypatch.setattr(twb, "WBA_EXIT_EVERY", exit_every)
    _, _, twin = _window(1)
    sharded = twb.shard_window_obs(twin, _cpu_mesh(2, "obs"))
    kw = dict(KW, max_iters=12, stage1_iters=2)
    _assert_same(twb.optimize_window(sharded, CAM, **kw), _eager(sharded, monkeypatch, **kw))


@pytest.mark.parametrize("stages", STAGES.values(), ids=STAGES.keys())
def test_bodies_match_jax_sharded_solve(stages):
    win, _, twin = _window()
    kw = dict(KW, **stages)
    rj = jwb.optimize_window(jwb.shard_window_obs(win, _jax_mesh(8, "obs")), JCam.kitti(), **kw)
    rt = twb.optimize_window(twb.shard_window_obs(twin, _cpu_mesh(8, "obs")), CAM, **kw)
    valid = np.asarray(win.lm_valid)
    np.testing.assert_allclose(rt.cam_pose.numpy(), np.asarray(rj.cam_pose), atol=POSE_TOL)
    np.testing.assert_allclose(rt.lm_pos.numpy()[valid], np.asarray(rj.lm_pos)[valid],
                               atol=LM_TOL)
    np.testing.assert_allclose(float(rt.obs_rmse), float(rj.obs_rmse), rtol=1e-3)


@pytest.mark.parametrize("stages", STAGES.values(), ids=STAGES.keys())
def test_one_shard_equals_the_unsharded_solve(stages):
    _, _, twin = _window()
    kw = dict(KW, **stages)
    _assert_same(twb.optimize_window(twb.shard_window_obs(twin, _cpu_mesh(1, "obs")), CAM, **kw),
                 twb.optimize_window(twin, CAM, **kw))


@pytest.mark.parametrize("exit_every,reads", [(8, True), (2, False)],
                         ids=["one_block_a_stage", "exits_unread"])
def test_shard_and_lead_bodies_read_nothing_on_the_host(monkeypatch, exit_every, reads):
    """The engine's solve (stage 1 of 2 iterations, 8 LM iterations: one
    block a stage) reads nothing from the device between its upload and
    its result row; nor does a solve of blocks of 2 whose exits are
    unread (a program's capture)."""
    _, _, twin = _window()
    sharded = twb.shard_window_obs(twin, _cpu_mesh(2, "obs"))
    kw = dict(kernel_param=1.5, max_iters=8, stage1_iters=2)
    want = twb.optimize_window_blob(sharded, CAM, **kw)
    monkeypatch.setattr(twb, "WBA_EXIT_EVERY", exit_every)
    _raise_on_host_reads(monkeypatch)
    if reads:
        got = twb.optimize_window_blob(sharded, CAM, **kw)
    else:
        with cuda_graphs.no_exit_reads():
            got = twb.optimize_window_blob(sharded, CAM, **kw)
    monkeypatch.undo()
    assert torch.equal(got, want)


def _shard_program_key(sharded, kw):
    """The full key of shard 0's program (``cuda_graphs.program_key``) for
    the window's first round."""
    w0 = sharded.shards[0]
    key = (*twb.shard_key(sharded, CAM, kw), "shard", 0, True, False)
    return cuda_graphs.program_key(dict(cam_pose=w0.cam_pose, lm_pos=w0.lm_pos), key,
                                   fixed=dict(buf=sharded.bufs[0]),
                                   device=sharded.bufs[0].device)[0]


def test_shard_key_is_the_buckets(monkeypatch):
    mesh = _cpu_mesh(2, "obs")
    a = twb.shard_window_obs(_window(0)[2], mesh)
    b = twb.shard_window_obs(_window(3)[2], mesh)
    assert a.bufs[0].data_ptr() != b.bufs[0].data_ptr()
    assert not torch.equal(a.shards[0].obs_px, b.shards[0].obs_px)
    assert twb.shard_key(a, CAM, KW) == twb.shard_key(b, CAM, KW)
    assert twb.shard_key(a, CAM, KW) == twb.shard_key(a, CAM, twb._options(KW))
    assert _shard_program_key(a, KW) == _shard_program_key(b, KW)
    others = [twb.shard_key(a, CAM, dict(KW, max_iters=4)),
              twb.shard_key(a, CAM, dict(KW, stage1_iters=2)),
              twb.shard_key(a, CAM._replace(baseline=0.5), KW),
              twb.shard_key(twb.shard_window_obs(_window(0)[2], _cpu_mesh(4, "obs")), CAM, KW)]
    big, _gt, _ = _make_window(np.random.default_rng(0), L=256, px_noise=0.3)
    others.append(twb.shard_key(twb.shard_window_obs(
        twb.BAWindow(*(torch.from_numpy(np.array(x)) for x in big)), mesh), CAM, KW))
    base = twb.shard_key(b, CAM, KW)
    monkeypatch.setattr(twb, "WBA_EXIT_EVERY", 4)
    others.append(twb.shard_key(a, CAM, KW))
    assert len({base, *others}) == len(others) + 1


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_host_form_equals_the_tensor_form(n_shards):
    """``shard_window_obs`` of the engine's host arrays = of the window's
    tensors: the same layout, buffers, window views and gather tables."""
    _, arrays, twin = _window()
    mesh = _cpu_mesh(n_shards, "obs")
    host = twb.shard_window_obs(twb.BAWindow(*arrays), mesh)
    tens = twb.shard_window_obs(twin, mesh)
    assert host.layout == tens.layout and len(host.bufs) == n_shards
    for h, t in zip(pytree.tree_leaves([host.bufs, [list(w) for w in host.shards],
                                        [list(p) for p in host.plans]]),
                    pytree.tree_leaves([tens.bufs, [list(w) for w in tens.shards],
                                        [list(p) for p in tens.plans]])):
        assert h.dtype == t.dtype and torch.equal(h, t)
    m = len(arrays[5]) // n_shards
    for i, (w, p) in enumerate(zip(host.shards, host.plans)):
        np.testing.assert_array_equal(w.obs_px.numpy(), arrays[7][i * m:(i + 1) * m])
        np.testing.assert_array_equal(w.lm_pos.numpy(), arrays[2])
        ref = twb.plan_arrays(arrays[5][i * m:(i + 1) * m], arrays[6][i * m:(i + 1) * m],
                              arrays[3], arrays[8][i * m:(i + 1) * m], 8, 128)
        for got, want in zip(pytree.tree_leaves(list(p)), pytree.tree_leaves(list(ref))):
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_mesh_engine_results_do_not_change(monkeypatch, n_shards):
    """``SRBAEngine(mesh=)`` on tests/test_torch_mesh.py's six-keyframe
    sequence: its windows laid out from the host arrays and solved on the
    programs' bodies give the keyframe poses of the eager route exactly;
    on the CPU it captures nothing ahead."""
    p = dict(submap_size=4, max_optimize_depth=3, max_kfs=16, win_cams=8, win_lms=1024,
             win_obs=2048, opt_iters=6)
    eng = SRBAEngine(CAM, SRBAParams(**p), mesh=_cpu_mesh(n_shards, "obs"))
    got = _engine_run(eng)
    assert eng.capture_window_programs() == [] and eng._met
    with monkeypatch.context() as m:
        m.setattr(twb, "WBA_SHARD_PROGRAMS", False)
        want = _engine_run(SRBAEngine(CAM, SRBAParams(**p), mesh=_cpu_mesh(n_shards, "obs")))
    np.testing.assert_array_equal(got, want)


def test_program_copies_fixed_inputs_only_when_they_change():
    """A program remembers the fixed inputs it copied in: the same tensors
    again need no copy; another tensor, or the same one written in place,
    does."""
    buf, other = torch.arange(6.0), torch.arange(6.0)
    prog = SimpleNamespace(fixed_from=cuda_graphs._copied_from([buf, None]))
    assert cuda_graphs._same_fixed(prog, [buf, None])
    assert not cuda_graphs._same_fixed(prog, [other, None])
    assert not cuda_graphs._same_fixed(prog, [buf])
    buf.add_(1.0)
    assert not cuda_graphs._same_fixed(prog, [buf, None])
    prog.fixed_from = cuda_graphs._copied_from([buf, None])
    assert cuda_graphs._same_fixed(prog, [buf, None])
