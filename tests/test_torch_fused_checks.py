"""Port parity of the pipelined schedule's device groups, on the CPU.

* ``fused_checks_batch``: three deferred checks of one scanned batch (the
  small-geometry sequence's frames 9, 12 and 15 against keyframes 0, 3 and
  6) in eight slots, five padded, each slot writing its speculative row
  before the next checks, the rows and seeds given as host ints or as
  device tensors (a captured slot's inputs on a card): the packed outputs
  against the JAX package's (statuses, indices, tracked counts and the
  frame's fields identical, BoW scores within 1e-6), the written store and
  BoW rows too; each slot equal bit for bit to the one-check path
  (``query_and_associate_packed``) on the same rows; no host read inside
  the group, nor in the one-check path with device scalars, with every
  cascade option on and off (every Tensor host read patched to raise);
  ``check_key`` holds every option and shape.
* ``solve_window_group`` (the port's ``optimize_windows_batch_blob``):
  two buckets, three windows each in eight slots, valid at the front or
  scattered among padded slots: each row against the JAX package's group
  (the tolerances of tests/test_torch_window_ba.py), equal bit for bit to
  its one-window solve, padded rows zero; no host read.
"""

import inspect

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import jax
import jax.numpy as jnp

from srba_slam_tpu.models import data_association as jda
from srba_slam_tpu.models.bow import BoWDatabase as JBoW, Vocabulary as JVoc
from srba_slam_tpu.models.vo import FrameFeatures as JFeat
from srba_slam_tpu.ops import window_ba as jwb
from srba_slam_tpu.utils.camera import StereoCamera as JCam
from srba_slam_tpu.utils.synthworld import make_ba_window_problem
from srba_slam_tpu_torch.models import data_association as tda
from srba_slam_tpu_torch.models.bow import BoWDatabase
from srba_slam_tpu_torch.models.vo import FrameFeatures, stack_features
from srba_slam_tpu_torch.ops import cuda_graphs, robust_lm
from srba_slam_tpu_torch.ops import window_ba as twb
from srba_slam_tpu_torch.utils.camera import StereoCamera

from test_torch_batched_solve import _count_host_reads
from torch_parity_inputs import (SMALL_CAM, jax_features, jax_store, port_features,
                                 port_store)

torch.set_num_threads(1)

KF_FRAMES = (0, 3, 6)
CHECK_FRAMES = (9, 12, 15)
DA_KW = dict(max_orb_distance_da=60.0, residual_th=10.0, max_y_diff_epipolar=1.5,
             filter_by_direction=False, ransac_n_hyp=64)
S, K, NQ = 5, 256, 4


@pytest.fixture(scope="module")
def checks():
    feats = jax_features(KF_FRAMES + CHECK_FRAMES)
    js = jax_store(feats[:len(KF_FRAMES)])
    desc = np.concatenate([np.asarray(f.desc_l)[np.asarray(f.m_valid)] for f in feats])
    jvoc = JVoc.train(desc, k=8, L=3, seed=0)
    jdb = JBoW(jvoc, max_kfs=js.max_kfs)
    jdb.rebuild_from_store(js.arrays, js.n_kfs)
    cur = feats[len(KF_FRAMES):]
    n = len(cur)
    pad = tda.CHECK_SLOTS - n
    args = dict(js=[0, 1, 2] + [0] * pad, rows=[3, 4, 5] + [0] * pad,
                valids=[True] * n + [False] * pad, seeds=[7, 8, 9] + [9] * pad)
    db0 = jax.device_get(jdb._db)
    jbatch = JFeat(*(jnp.asarray(np.stack([getattr(f, name) for f in cur]))
                     for name in JFeat._fields))
    # fresh copies: the JAX group donates (deletes) its store and database
    jblobs, jarrays, jdb_new = jda.fused_checks_batch(
        jbatch, type(js.arrays)(*(jnp.array(a) for a in js.arrays)), jnp.array(jdb._db),
        jdb._leaf_bits, jdb._weights, tuple(args["js"]),
        tuple(args["rows"]), tuple(args["valids"]), JCam(**SMALL_CAM), tuple(args["seeds"]),
        **DA_KW)
    jout = (jax.device_get(jblobs), jax.device_get(jarrays), jax.device_get(jdb_new))
    return jvoc, db0, js, cur, args, jout


def _port_parts(jvoc, db0, js):
    return port_store(js), BoWDatabase.from_jax_numpy(jvoc, db0, js.n_kfs, device="cpu")


def _slot_inputs(args, given: str):
    """The group's rows and seeds as host ints, or as int64 tensors on the
    database's device (the estimator's slot table)."""
    if given == "ints":
        return args["rows"], args["seeds"]
    return (torch.tensor(args["rows"], dtype=torch.int64),
            torch.tensor(args["seeds"], dtype=torch.int64))


@pytest.mark.parametrize("given", ["ints", "tensors"])
def test_fused_checks_batch_matches_jax(checks, monkeypatch, given):
    jvoc, db0, js, cur, args, (jblobs, jarrays, jdb) = checks
    store, bow = _port_parts(jvoc, db0, js)
    batch = stack_features([port_features(f) for f in cur])
    rows, seeds = _slot_inputs(args, given)
    reads = _count_host_reads(monkeypatch)
    blobs, arrays, db = tda.fused_checks_batch(
        batch, store.arrays, bow._db, bow._leaf_bits, bow._weights, args["js"], rows,
        args["valids"], StereoCamera(**SMALL_CAM), seeds, **DA_KW)
    monkeypatch.undo()
    assert reads[0] == 0
    assert len(blobs) == tda.CHECK_SLOTS
    for i, (bj, bt) in enumerate(zip(jblobs, blobs)):
        if not args["valids"][i]:
            assert not bt.any()
            continue
        oj = jda.unpack_check_outputs(np.asarray(bj), s=S, k=K, nq=NQ)
        ot = tda.unpack_check_outputs(bt.numpy(), s=S, k=K, nq=NQ)
        np.testing.assert_allclose(ot[0], oj[0], atol=1e-6)            # scores
        for a, b in zip(ot[1:10], oj[1:10]):                         # the integer fields
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ot[10], oj[10])                # the frame's points
        assert int(oj[4][0]) >= 15                                   # the cascade ran
    for name in ("desc_l", "m_valid", "xs_l", "pts3d"):
        a = getattr(arrays, name).numpy()[3:6]
        b = np.asarray(getattr(jarrays, name))[3:6]
        np.testing.assert_array_equal(a, b.view(np.int32) if b.dtype == np.uint32 else b)
    np.testing.assert_allclose(db.numpy()[:6], np.asarray(jdb)[:6], atol=1e-6)


def test_fused_slots_equal_the_one_check_path(checks):
    jvoc, db0, js, cur, args, _jout = checks
    cam = StereoCamera(**SMALL_CAM)
    store, bow = _port_parts(jvoc, db0, js)
    batch = stack_features([port_features(f) for f in cur])
    blobs, _a, _d = tda.fused_checks_batch(
        batch, store.arrays, bow._db, bow._leaf_bits, bow._weights, args["js"], args["rows"],
        args["valids"], cam, args["seeds"], **DA_KW)
    store1, bow1 = _port_parts(jvoc, db0, js)
    for i in range(len(cur)):
        frame = FrameFeatures(*(a[args["js"][i]] for a in batch))
        row = args["rows"][i]
        store1.write_row(frame, row)
        bow1.write_row(frame.desc_l, frame.m_valid, row)
        (one,) = tda.query_and_associate_packed(frame, store1.arrays, bow1._db,
                                                bow1._leaf_bits, bow1._weights, row, cam,
                                                args["seeds"][i], **DA_KW)
        assert torch.equal(one, blobs[i]), i
    # fused_check_write is one slot
    store2, bow2 = _port_parts(jvoc, db0, js)
    (blob,), _a, _d = tda.fused_check_write(batch, store2.arrays, bow2._db, bow2._leaf_bits,
                                            bow2._weights, 0, 3, cam, args["seeds"][0],
                                            **DA_KW)
    assert torch.equal(blob, blobs[0])


_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__", "__index__")
# every option of the cascade on, with the debug section; every one off
OPTION_SETS = {
    "every_option_debug": dict(DA_KW, filter_by_direction=True, filter_by_orb_distance=True,
                               use_fund_matrix=True, use_change_pose=True, debug=True),
    "no_option": dict(DA_KW, filter_by_direction=False, filter_by_orb_distance=False,
                      use_fund_matrix=False, use_change_pose=False),
}


@pytest.mark.parametrize("options", list(OPTION_SETS))
def test_check_slot_reads_nothing_on_the_host(checks, monkeypatch, options):
    """A fused group (three slots, rows and seeds as device tensors) and
    the one-check path (count and seed as device scalars, its loops unread,
    as in its program's capture) on the card's route (the Horn rotation)
    with every Tensor host read patched to raise: the same outputs as the
    unpatched calls, leaf for leaf (a read would break the capture on a
    card)."""
    jvoc, db0, js, cur, args, _jout = checks
    kw = OPTION_SETS[options]
    cam = StereoCamera(**SMALL_CAM)
    batch = stack_features([port_features(f) for f in cur])
    rows, seeds = _slot_inputs(args, "tensors")
    monkeypatch.setattr(tda, "_kabsch_rotation", tda._horn_rotation)

    def run():
        store, bow = _port_parts(jvoc, db0, js)
        group = tda.fused_checks_batch(batch, store.arrays, bow._db, bow._leaf_bits,
                                       bow._weights, args["js"], rows, args["valids"], cam,
                                       seeds, **kw)
        with cuda_graphs.no_exit_reads():
            one = tda.query_and_associate_packed(
                FrameFeatures(*(a[0] for a in batch)), store.arrays, bow._db, bow._leaf_bits,
                bow._weights, torch.tensor(3, dtype=torch.int64), cam,
                torch.tensor(11, dtype=torch.int64), **kw)
        return group, one

    ref = run()

    def refuse(name):
        def read(*a, **k):
            raise AssertionError(f"the check read a tensor on the host: Tensor.{name}")
        return read

    for name in _READS:
        monkeypatch.setattr(torch.Tensor, name, refuse(name))
    got = run()
    monkeypatch.undo()
    ref_leaves, ref_spec = pytree.tree_flatten(ref)
    got_leaves, got_spec = pytree.tree_flatten(got)
    assert got_spec == ref_spec and len(got_leaves) == tda.CHECK_SLOTS + 12 + 1 + 1
    assert all(torch.equal(a, b) for a, b in zip(got_leaves, ref_leaves))
    blob_len = tda._blob_len(S, K, NQ, kw.get("debug", False))
    assert got[1][0].shape == (blob_len,) and got[0][0][0].shape == (blob_len,)


def test_check_key_separates_shapes_and_options(checks, monkeypatch):
    """Every option of the check (the cascade's, ``n_query``, ``debug``,
    the slot program or the one-check program) reaches ``check_key``: one
    changed (or the frame's capacity, the store's rows, the database's
    width, the camera, the change-in-pose solve's caps, the GN block length
    or route, the Jacobi sweeps) gives another key; the same call, and the
    defaults given explicitly, the same key. The row and the seed are not
    in it."""
    jvoc, db0, js, cur, _args, _jout = checks
    store, bow = _port_parts(jvoc, db0, js)
    frame, cam = port_features(cur[0]), StereoCamera(**SMALL_CAM)
    inputs = {"cur", "store_arrays", "db", "leaf_bits", "weights", "n_kfs", "cam", "key",
              "init_poses", "n_query"}
    opts = {name: p.default for name, p in
            inspect.signature(tda.query_and_associate).parameters.items() if name not in inputs}
    assert set(opts) == set(tda._CHECK_OPTS)

    def key(f=frame, arrays=store.arrays, db=bow._db, c=cam, n_query=NQ, debug=False,
            slot=True, **o):
        return tda.check_key(f, arrays, db, c, n_query, debug, slot, **o)

    base = key()
    assert key(f=FrameFeatures(*(a.clone() for a in frame)), c=StereoCamera(**SMALL_CAM),
               **opts) == base
    keys = [base]
    for name, v in opts.items():
        keys.append(key(**{name: (not v) if isinstance(v, bool) else v + 1}))
    keys += [key(n_query=NQ + 1), key(debug=True), key(slot=False),
             key(c=StereoCamera(**{**SMALL_CAM, "fx_l": SMALL_CAM["fx_l"] + 1.0})),
             key(f=frame._replace(desc_l=torch.zeros((K + 1, 8), dtype=torch.int32))),
             key(arrays=store.arrays._replace(
                 desc_l=torch.zeros((js.max_kfs + 1, K, 8), dtype=torch.int32))),
             key(db=torch.zeros((bow._db.shape[0], bow._db.shape[1] + 1)))]
    for module, name, value in ((tda, "DA_SOLVE_ITERS_STAGE1", 11),
                                (tda, "DA_SOLVE_ITERS_STAGE2", 11),
                                (robust_lm, "GN_EXIT_EVERY", robust_lm.GN_EXIT_EVERY + 1),
                                (robust_lm, "GN_GRAPHS", not robust_lm.GN_GRAPHS),
                                (tda, "_JACOBI_SWEEPS", 9)):
        monkeypatch.setattr(module, name, value)
        keys.append(key())
        monkeypatch.undo()
    assert len(set(keys)) == len(keys)


WIN_KW = dict(kernel_param=1.5, max_iters=8, stage1_iters=2)
BUCKETS = [dict(C=8, L=128, O=512, n_cams=5, n_lms=100, seeds=(0, 3, 4)),
           dict(C=16, L=256, O=1024, n_cams=9, n_lms=220, seeds=(2, 5, 6))]


def _group(b: dict, slots):
    """Three windows of one bucket in ``slots`` of WINDOW_SLOTS, packed;
    the padded slots hold copies of the first (as both engines pad)."""
    wins = []
    for seed in b["seeds"]:
        win, _gt = make_ba_window_problem(JCam.kitti(), np.random.default_rng(seed), b["C"],
                                          b["L"], b["O"], b["n_cams"], b["n_lms"])
        wins.append(jwb.pack_window(*(np.asarray(a) for a in win)))
    at = dict(zip(slots, wins))
    full = [at.get(i, wins[0]) for i in range(twb.WINDOW_SLOTS)]
    ints = np.stack([w[0] for w in full])
    floats = np.stack([w[1] for w in full])
    valids = np.isin(np.arange(twb.WINDOW_SLOTS), slots)
    return ints, floats, valids


@pytest.mark.parametrize("slots", [(0, 1, 2), (1, 4, 7)], ids=["front", "scattered"])
@pytest.mark.parametrize("bucket", BUCKETS, ids=["C8", "C16"])
def test_window_group_matches_jax_and_one_window_solves(monkeypatch, bucket, slots):
    ints, floats, valids = _group(bucket, slots)
    C, L, O = bucket["C"], bucket["L"], bucket["O"]
    jrows = np.asarray(jwb.optimize_windows_batch_blob(
        jnp.asarray(ints), jnp.asarray(floats), jnp.asarray(valids), C, L, O, JCam.kitti(),
        **WIN_KW))
    cam = StereoCamera.kitti()
    ti, tf = torch.from_numpy(ints), torch.from_numpy(floats)
    plans = [twb._packed_plan(ints[i], C, L, O, "cpu") for i in range(len(ints))]
    reads = _count_host_reads(monkeypatch)
    rows = twb.solve_window_group(ints, floats, list(valids), C, L, O, cam, "cpu", **WIN_KW)
    n_reads = reads[0]
    monkeypatch.undo()
    assert n_reads == 0
    assert rows.shape == (twb.WINDOW_SLOTS, C * 6 + L * 3 + 4)
    for i, v in enumerate(valids):
        if not v:
            assert not rows[i].any() and not jrows[i].any()
            continue
        one = twb.optimize_window_packed_blob(ti[i], tf[i], C, L, O, cam, plan=plans[i],
                                              **WIN_KW)
        assert torch.equal(rows[i], one), i
        lm_valid = ints[i][L + 2 * O + C:L + 2 * O + C + L] != 0
        got, ref = rows[i].numpy(), jrows[i]
        np.testing.assert_allclose(got[:C * 6], ref[:C * 6], atol=1e-4)
        np.testing.assert_allclose(got[C * 6:C * 6 + L * 3].reshape(L, 3)[lm_valid],
                                   ref[C * 6:C * 6 + L * 3].reshape(L, 3)[lm_valid], atol=2e-3)
        np.testing.assert_allclose(got[-4:], ref[-4:], rtol=1e-4)


def test_pack_window_round_trips():
    win, _gt = make_ba_window_problem(JCam.kitti(), np.random.default_rng(1), 8, 128, 512, 5, 100)
    host = [np.asarray(a) for a in win]
    ints, floats = twb.pack_window(*host)
    jints, jfloats = jwb.pack_window(*host)
    np.testing.assert_array_equal(ints, jints)
    np.testing.assert_array_equal(floats, jfloats)
    back = twb.unpack_window(torch.from_numpy(ints), torch.from_numpy(floats), 8, 128, 512)
    for a, b in zip(back, host):
        np.testing.assert_array_equal(a.numpy(), b)
