"""The bodies of the window-solve group's and the pose graph's programs,
and the life of a program that holds tensors, on the CPU.

* ``solve_window_group`` (the engine's group; on a card one program
  replay, here the same body eagerly): its input is the stacked packed
  windows, uploaded as one buffer whose views the body reads; the body
  builds each valid slot's gather tables from its ints (``device_plan``).
  At (C, L, O) =
  (4, 64, 128), three windows in eight slots, valid at the front or
  scattered among padded slots: each row against the JAX package's
  ``optimize_windows_batch_blob`` (poses and landmarks within 1e-4, the
  tolerance of LM step counts that may differ by one or two, ROADMAP
  "Known differences"), equal bit for bit to its one-window solve
  (``optimize_window`` on ``assembly_plan``), padded rows exactly 0.
* Neither the group body nor ``optimize_pose_graph`` with the host's edge
  arrays reads anything from the device (every Tensor host read patched to
  raise); the tables the group builds equal those built on the host from
  read-back arrays.
* ``device_plan`` equals the host's ``packed_plan_arrays`` table for table
  (int64, the same shapes and values): every bucket of the engine's
  ladder at a small fill, a full window, a window of padded observations
  only, a sparse one (levels past the data's last), and one whose
  landmark holds more than ``_SEG_WIDTH`` ** 2 observations (data at
  every level).
* ``group_key`` holds the bucket, the valid slots and every option;
  ``cuda_graphs.pack``/``unpack`` round-trip mixed dtypes.
* A program that holds tensors leaves the cache once one of them is freed;
  one that holds nothing stays; the check programs hold their owners'
  long-lived tensors, never views made for the call.
"""

import gc
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import jax.numpy as jnp

from srba_slam_tpu.ops import window_ba as jwb
from srba_slam_tpu.utils.camera import StereoCamera as JCam
from srba_slam_tpu.utils.synthworld import make_ba_window_problem
from srba_slam_tpu_torch.models import data_association as tda
from srba_slam_tpu_torch.models.bow import BoWDatabase, Vocabulary
from srba_slam_tpu_torch.models.keyframe import KeyframeStore
from srba_slam_tpu_torch.ops import cuda_graphs, posegraph
from srba_slam_tpu_torch.ops import window_ba as twb
from srba_slam_tpu_torch.utils.camera import StereoCamera

from test_torch_posegraph import _loop_graph

torch.set_num_threads(1)

C, L, O = 4, 64, 128
WIN_KW = dict(kernel_param=1.5, max_iters=8, stage1_iters=2)
SEEDS = (0, 3, 4)
SLOTS = {"front": (0, 1, 2), "scattered": (1, 4, 7)}
TOL = 1e-4


def _group(slots):
    """Three windows of the bucket in ``slots`` of WINDOW_SLOTS, packed; a
    padded slot holds a copy of the first (as both engines pad)."""
    wins = []
    for seed in SEEDS:
        win, _gt = make_ba_window_problem(JCam.kitti(), np.random.default_rng(seed), C, L, O,
                                          3, 40)
        wins.append(jwb.pack_window(*(np.asarray(a) for a in win)))
    at = dict(zip(slots, wins))
    full = [at.get(i, wins[0]) for i in range(twb.WINDOW_SLOTS)]
    valids = [i in at for i in range(twb.WINDOW_SLOTS)]
    return np.stack([w[0] for w in full]), np.stack([w[1] for w in full]), valids


def _raise_on_host_reads(monkeypatch):
    """Every host read of a Tensor raises (a read would break a capture on
    the card)."""
    def read(*_a, **_k):
        raise AssertionError("a host read")

    for name in ("item", "__bool__", "__int__", "__float__", "tolist", "numpy", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, read)


def _one_window(ints, floats, i):
    """Slot ``i``'s one-window solve as the engine's ``_solve_window`` makes
    it: the window's tensors and ``assembly_plan`` of its host arrays."""
    win = twb.unpack_window(torch.from_numpy(ints[i]), torch.from_numpy(floats[i]), C, L, O)
    plan = twb.assembly_plan(*(a.numpy() for a in (win.obs_cam, win.obs_lm, win.lm_base,
                                                   win.obs_valid)), C, L, "cpu")
    return twb.result_blob(twb.optimize_window(win, StereoCamera.kitti(), plan=plan, **WIN_KW))


@pytest.mark.parametrize("slots", SLOTS.values(), ids=SLOTS.keys())
def test_group_body_matches_jax(monkeypatch, slots):
    ints, floats, valids = _group(slots)
    jrows = np.asarray(jwb.optimize_windows_batch_blob(
        jnp.asarray(ints), jnp.asarray(floats), jnp.asarray(valids), C, L, O, JCam.kitti(),
        **WIN_KW))
    rows = twb.solve_window_group(ints, floats, valids, C, L, O, StereoCamera.kitti(), "cpu",
                                  **WIN_KW).numpy()
    assert rows.shape == (twb.WINDOW_SLOTS, C * 6 + L * 3 + 4)
    for i, v in enumerate(valids):
        if not v:
            assert not rows[i].any() and not jrows[i].any(), i
            continue
        lm_valid = ints[i][L + 2 * O + C:L + 2 * O + C + L] != 0
        np.testing.assert_allclose(rows[i][:C * 6], jrows[i][:C * 6], atol=TOL)
        np.testing.assert_allclose(rows[i][C * 6:C * 6 + L * 3].reshape(L, 3)[lm_valid],
                                   jrows[i][C * 6:C * 6 + L * 3].reshape(L, 3)[lm_valid],
                                   atol=TOL)
        np.testing.assert_allclose(rows[i][-4:], jrows[i][-4:], rtol=TOL)


@pytest.mark.parametrize("slots", SLOTS.values(), ids=SLOTS.keys())
def test_group_slots_equal_one_window_solves(slots):
    ints, floats, valids = _group(slots)
    rows = twb.solve_window_group(ints, floats, valids, C, L, O, StereoCamera.kitti(), "cpu",
                                  **WIN_KW)
    for i, v in enumerate(valids):
        if v:
            assert torch.equal(rows[i], _one_window(ints, floats, i)), i
        else:
            assert torch.equal(rows[i], torch.zeros_like(rows[i])), i


@pytest.mark.parametrize("exit_every", [1, 8])
def test_group_body_reads_nothing_on_the_host(monkeypatch, exit_every):
    """The body as the program runs it (its loops unread), from its one
    uploaded buffer: no host read at any exit period."""
    ints, floats, valids = _group(SLOTS["scattered"])
    buf, layout = twb.group_upload(ints, floats, "cpu")
    want = twb._group_body(buf, layout, tuple(valids), C, L, O, StereoCamera.kitti(), WIN_KW,
                           twb.optimize_window)
    monkeypatch.setattr(twb, "WBA_EXIT_EVERY", exit_every)
    _raise_on_host_reads(monkeypatch)
    with cuda_graphs.no_exit_reads():
        got = twb._group_body(buf, layout, tuple(valids), C, L, O, StereoCamera.kitti(),
                              WIN_KW, twb.optimize_window)
    monkeypatch.undo()
    assert torch.equal(got, want)


def test_group_tables_equal_read_back_ones():
    """The group's one buffer holds the stacked ints and floats and no
    table; the tables that the body builds from each valid slot's ints (a
    view of the buffer) equal ``assembly_plan`` of the window's arrays read
    back from the device (what ``optimize_window`` builds without a plan),
    table for table."""
    ints, floats, valids = _group(SLOTS["scattered"])
    buf, layout = twb.group_upload(ints, floats, "cpu")
    assert buf.numel() == ints.nbytes + floats.nbytes
    g_ints, g_floats = cuda_graphs.unpack(buf, layout)
    assert torch.equal(g_ints, torch.from_numpy(ints))
    assert torch.equal(g_floats, torch.from_numpy(floats))
    for i in (i for i, v in enumerate(valids) if v):
        plan = twb.device_plan(g_ints[i], C, L, O)
        win = twb.unpack_window(torch.from_numpy(ints[i]), torch.from_numpy(floats[i]), C, L, O)
        back = twb.assembly_plan(*(t.cpu().numpy() for t in (win.obs_cam, win.obs_lm,
                                                             win.lm_base, win.obs_valid)),
                                 C, L, "cpu")
        assert [len(f) for f in plan] == list(twb.plan_levels(C, L, O))
        for got, ref in zip(pytree.tree_leaves(list(plan)), pytree.tree_leaves(list(back))):
            assert got.dtype == ref.dtype == torch.int64 and torch.equal(got, ref)


def _plan_case_ints(bucket, n_cams, n_lms, n_obs, seed=0):
    """The ``pack_window`` ints of a window of ``bucket`` whose first
    ``n_obs`` observations are valid, seen from its first ``n_cams``
    cameras, of its first ``n_lms`` landmarks (based at those cameras)."""
    C_, L_, O_ = bucket
    rng = np.random.default_rng(seed)
    return twb.pack_window(np.zeros((C_, 6)), np.arange(C_) < n_cams, np.zeros((L_, 3)),
                           rng.integers(0, n_cams, L_), np.arange(L_) < n_lms,
                           rng.integers(0, n_cams, O_), rng.integers(0, n_lms, O_),
                           np.zeros((O_, 3)), np.arange(O_) < n_obs)[0]


def _plan_cases():
    """(id, bucket, n_cams, n_lms, n_obs) of ``test_device_plan_equals_host_tables``."""
    from srba_slam_tpu_torch.models.srba import SRBAEngine

    buckets = SRBAEngine(StereoCamera.kitti(), device="cpu").window_buckets()
    cases = [(f"small-{c}x{l}x{o}", (c, l, o), 3, 40, 150) for c, l, o in buckets]
    full = (16, 1024, 2048)
    width = twb._SEG_WIDTH
    return cases + [("full", full, 16, 1024, 2048), ("all-padded", full, 16, 1024, 0),
                    ("sparse", full, 2, 3, 5),
                    ("one-landmark-every-level", (8, 512, 2048), 4, 1, width * width + 300)]


@pytest.mark.parametrize("case", _plan_cases(), ids=lambda c: c[0])
def test_device_plan_equals_host_tables(case):
    """``device_plan`` on the CPU (the body that a group's program runs on
    the card) equals the host's ``packed_plan_arrays`` table for table."""
    _id, bucket, n_cams, n_lms, n_obs = case
    ints = _plan_case_ints(bucket, n_cams, n_lms, n_obs)
    ref = twb.packed_plan_arrays(ints, *bucket)
    got = twb.device_plan(torch.from_numpy(ints), *bucket)
    assert [len(f) for f in got] == [len(f) for f in ref] == list(twb.plan_levels(*bucket))
    for field, g_tabs, r_tabs in zip(got._fields, got, ref):
        for g, r in zip(g_tabs, r_tabs):
            assert g.dtype == torch.int64 and tuple(g.shape) == r.shape, field
            assert np.array_equal(g.numpy(), r), field
    if _id == "one-landmark-every-level":
        # the landmark's sum has rows at every level: two in the last one's
        # row (past it, its pad index: the rows of the level before)
        assert (ref.lm[-1][0] < len(ref.lm[-2])).sum() == 2


def test_pose_graph_with_host_edges_reads_nothing(monkeypatch):
    args = [torch.from_numpy(a) for a in _loop_graph(np.random.default_rng(12), 12, 16, 32,
                                                      0.01, 1)]
    host = tuple(a.numpy().copy() for a in (args[2], args[3], args[5]))
    want = posegraph.optimize_pose_graph(*args, max_iters=10)
    _raise_on_host_reads(monkeypatch)
    got = posegraph.optimize_pose_graph(*args, max_iters=10, host_edges=host)
    monkeypatch.undo()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_pose_graph_tables_equal_read_back_ones():
    args = _loop_graph(np.random.default_rng(30), 30, 64, 64, 0.02, 3)
    dev = [torch.from_numpy(a) for a in args]
    host = posegraph.edge_tables(args[2], args[3], args[5], 64)
    back = posegraph.edge_tables(*(t.cpu().numpy() for t in (dev[2], dev[3], dev[5])), 64)
    assert [len(t) for t in host] == [len(t) for t in back] == [
        len(twb._fixed_levels(4 * 64, 64 * 64, twb._SEG_WIDTH)),
        len(twb._fixed_levels(2 * 64, 64, twb._SEG_WIDTH))]
    for a, b in zip(host[0] + host[1], back[0] + back[1]):
        np.testing.assert_array_equal(a, b)


def test_group_key_separates_slots_and_options():
    cam = StereoCamera.kitti()
    base = twb.group_key([True] * 2 + [False] * 6, C, L, O, cam, WIN_KW)
    assert base == twb.group_key([True] * 2 + [False] * 6, C, L, O, cam, dict(WIN_KW))
    others = [twb.group_key([True] * 3 + [False] * 5, C, L, O, cam, WIN_KW),
              twb.group_key([False, True] + [False] * 6, C, L, O, cam, WIN_KW),
              twb.group_key([True] * 2 + [False] * 6, C, 2 * L, O, cam, WIN_KW),
              twb.group_key([True] * 2 + [False] * 6, C, L, O, cam, dict(WIN_KW, max_iters=4)),
              twb.group_key([True] * 2 + [False] * 6, C, L, O, cam,
                            dict(WIN_KW, w_prior_rot=10.0)),
              twb.group_key([True] * 2 + [False] * 6, C, L, O, cam._replace(baseline=0.5),
                            WIN_KW)]
    assert len({base, *others}) == len(others) + 1


def test_pack_round_trips_mixed_dtypes():
    arrays = [np.arange(7, dtype=np.int32), np.linspace(0, 1, 6, dtype=np.float32).reshape(2, 3),
              np.arange(5) % 2 == 0, np.arange(12, dtype=np.int64).reshape(3, 4),
              np.zeros((0, 32), np.int64)]
    buf, layout = cuda_graphs.pack(arrays)
    assert all(off % 8 == 0 for off, _dt, _s in layout)
    for got, ref in zip(cuda_graphs.unpack(torch.from_numpy(buf), layout), arrays):
        assert got.numpy().dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got.numpy(), ref)


def _fake_program(kind: str) -> SimpleNamespace:
    return SimpleNamespace(key=(kind,), dev=torch.device("cpu"))


def test_program_leaves_the_cache_with_a_held_tensor(monkeypatch):
    """A program registered with held tensors leaves the cache once one of
    them is freed (queued for its graphs' release); one registered with
    none stays; a program captured anew under a dropped key is not dropped
    by the old program's finalizers."""
    monkeypatch.setattr(cuda_graphs, "_PROGRAMS", {})
    monkeypatch.setattr(cuda_graphs, "_DROPPED", [])
    held = [torch.zeros(4), torch.ones(3)]
    cuda_graphs._register(("check", 1), _fake_program("check"), held)
    cuda_graphs._register(("vo_scan", 1), _fake_program("vo_scan"), [])
    gc.collect()
    assert set(cuda_graphs._PROGRAMS) == {("check", 1), ("vo_scan", 1)}
    del held[0]
    gc.collect()
    assert set(cuda_graphs._PROGRAMS) == {("vo_scan", 1)}
    assert [p.key for p in cuda_graphs._DROPPED] == [("check",)]
    again = _fake_program("check")
    cuda_graphs._register(("check", 1), again, held)
    del held[0]                      # held by both the old and the new program
    gc.collect()
    assert set(cuda_graphs._PROGRAMS) == {("vo_scan", 1)}
    assert cuda_graphs._DROPPED[-1] is again and len(cuda_graphs._DROPPED) == 2
    cuda_graphs._DROPPED.clear()     # no graphs to release on the CPU


def test_check_programs_hold_the_owners_tensors(monkeypatch):
    """The held leaves of a check program (``data_association._held``) are
    the store's, the database's and the vocabulary's own tensors, the same
    objects at every call: a program registered on them stays while the
    owner lives, and leaves once the owner is gone."""
    monkeypatch.setattr(cuda_graphs, "_PROGRAMS", {})
    monkeypatch.setattr(cuda_graphs, "_DROPPED", [])
    rng = np.random.default_rng(0)
    voc = Vocabulary(rng.integers(0, 2, (16, 256)).astype(np.int8),
                     rng.uniform(0.5, 1.5, 16).astype(np.float32), 16, 4, 2)
    owner = SimpleNamespace(store=KeyframeStore(8, 16, "cpu"), bow=BoWDatabase(voc, 8, "cpu"))

    def held():
        return pytree.tree_leaves(tda._held(owner.store.arrays, owner.bow._db,
                                            owner.bow._leaf_bits, owner.bow._weights))

    first = held()
    assert [id(t) for t in first] == [id(t) for t in held()]
    cuda_graphs._register(("check", 2), _fake_program("check"), first)
    del first
    gc.collect()
    assert ("check", 2) in cuda_graphs._PROGRAMS
    del owner
    gc.collect()
    assert ("check", 2) not in cuda_graphs._PROGRAMS and len(cuda_graphs._DROPPED) == 1
    cuda_graphs._DROPPED.clear()
