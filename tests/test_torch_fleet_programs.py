"""The bodies of the parallel layer's programs against the JAX package, on
the CPU.

On a card a fleet shard's lockstep attempt, its check group and a shard's
batched VO step are each one CUDA-graph program (``parallel/batch.py``
``FLEET_GRAPHS``); here the same code runs eagerly, its per-sequence
indices, thresholds, increments, counts and seeds as tensors, as the
programs take them (tests/test_torch_cuda.py holds the programs to the
eager route on the card).

* ``FleetSLAM._attempt`` of three sequences (tests/test_torch_parallel.py's
  160x96 camera and fleet options, seeds 11, 23, 35), each at its own FAST
  and ORB thresholds and initial increment, all three pending and two of
  them (a retry), against JAX's ``_build_vo_prog`` over the same sequences:
  every integer field of the features, the track indices and masks and the
  pose validity identical, ``pts3d`` within 1e-5, poses within 1e-4 (that
  file's tolerances). Both packages blur with JAX's ``gauss_blur7``.
* ``FleetSLAM._check_group`` of two of three sequences (the small-geometry
  stores of tests/torch_parity_inputs.py) against JAX's ``_build_qa_prog``
  over the same two: BoW ids, statuses, matched indices, tracked counts
  and the frames' fields identical, scores within 1e-6
  (tests/test_torch_batched_check.py's contract).
* ``batched_vo_step`` at B = 3 with its thresholds as tensors against JAX's
  ``_batched_step`` at the same thresholds (tests/test_torch_batched_solve.py's
  contract), two steps.
* ``attempt_key``, ``fleet_check_key``, ``step_key`` and
  ``cuda_graphs.program_key``: a change of shape, option, pending count or
  group size, or a held tensor put in another's place, gives another key.
* The attempt, the check group and the batched step with every Tensor host
  read patched to raise (their loops unread, as in a capture): the same
  outputs, so none reads the host.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from srba_slam_tpu.config import (
    GeneralOptions as JGeneral, SRBAStereoSLAMOptions as JOptions, VOOptions as JVO,
)
from srba_slam_tpu.models.bow import BoWDatabase as JBoW, Vocabulary as JVoc
from srba_slam_tpu.models.estimator import SRBAStereoSLAMEstimator as JEstimator
from srba_slam_tpu.models.vo import FrameFeatures as JFeat
from srba_slam_tpu.models import vo as jvo
from srba_slam_tpu.parallel import batch as jbatch
from srba_slam_tpu.parallel import fleet as jfleet
from srba_slam_tpu.utils.camera import StereoCamera as JCam
from srba_slam_tpu_torch.config import GeneralOptions, SRBAStereoSLAMOptions, VOOptions
from srba_slam_tpu_torch.models import data_association as tda
from srba_slam_tpu_torch.models import vo
from srba_slam_tpu_torch.models.bow import Vocabulary
from srba_slam_tpu_torch.models.estimator import SRBAStereoSLAMEstimator
from srba_slam_tpu_torch.models.vo import frame_features_from_numpy
from srba_slam_tpu_torch.ops import cuda_graphs, robust_lm
from srba_slam_tpu_torch.parallel import batch, fleet
from srba_slam_tpu_torch.utils.camera import StereoCamera
from srba_slam_tpu_torch.utils.framesource import SyntheticSource

from test_torch_parallel import (
    CAM, FLEET_OPTIONS, _assert_same_features,
    shared_blur,  # noqa: F401  (a fixture)
)
from torch_parity_inputs import (CAPACITY, SMALL_CAM, jax_features, jax_store, port_features,
                                 port_store)

torch.set_num_threads(1)

POSE_TOL = 1e-4
SEEDS = (11, 23, 35)
FAST = (12.0, 9.0, 15.0)
ORB = (60, 70, 50)
INIT = np.array([[1e-3, -2e-3, 5e-4, 1e-2, 0.0, 5e-2],
                 [0.0, 1e-3, 0.0, -1e-2, 2e-3, 8e-2],
                 [2e-3, 0.0, -1e-3, 0.0, 1e-2, 1e-1]], np.float32)
_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__")


def _attempt_frames():
    """Frames 0 and 1 of the three sequences."""
    return [list(SyntheticSource(StereoCamera(**CAM), n_frames=2, seed=s, step=0.12))
            for s in SEEDS]


def _attempt_fleet(seqs):
    """A port fleet of the three sequences on the CPU, each engine's previous
    frame frame 0 (the JAX frontend's features), its thresholds and
    increment set; and the JAX estimator whose ``_build_vo_prog`` is the
    reference, with the JAX features of frame 0."""
    ests, jprev = [], []
    jcam = JCam(**CAM)
    for (f0, _f1), fast, orb, init in zip(seqs, FAST, ORB, INIT):
        e = SRBAStereoSLAMEstimator(
            GeneralOptions(), SRBAStereoSLAMOptions(camera=StereoCamera(**CAM), **FLEET_OPTIONS),
            VOOptions(fast_th=12, n_feats=128), capacity=128, max_kfs=32, device="cpu")
        e.initialize()
        jf = jax.device_get(jvo.extract_and_match(jnp.asarray(f0[0]), jnp.asarray(f0[1]), jcam,
                                                  jnp.float32(12.0), jnp.int32(60), k=128))
        jprev.append(jf)
        e.vo._prev = frame_features_from_numpy(jf, "cpu")
        e.vo.fast_th, e.vo.orb_th, e.vo._last_pose_inc = fast, float(orb), init.copy()
        ests.append(e)
    je0 = JEstimator(JGeneral(), JOptions(camera=jcam, **FLEET_OPTIONS),
                     JVO(fast_th=12, n_feats=128), capacity=128, max_kfs=32)
    je0.initialize()
    return fleet.FleetSLAM(ests), je0, jprev


def _attempt_inputs(seqs):
    lefts = torch.from_numpy(np.stack([s[1][0] for s in seqs]))
    rights = torch.from_numpy(np.stack([s[1][1] for s in seqs]))
    return lefts, rights


@pytest.mark.parametrize("idx", [(0, 1, 2), (0, 2)], ids=["all", "retry"])
def test_attempt_matches_jax_vo_prog(shared_blur, idx):  # noqa: F811
    seqs = _attempt_frames()
    flt, je0, jprev = _attempt_fleet(seqs)
    lefts, rights = _attempt_inputs(seqs)
    got_idx, curs, outs = flt._attempt(0, list(idx), lefts, rights)
    assert got_idx == list(idx)
    sel = np.array(idx)
    jcur, jti, jtv, jpose, jvalid = jax.device_get(jfleet.FleetSLAM._build_vo_prog(None, je0)(
        jnp.asarray(lefts.numpy()[sel]), jnp.asarray(rights.numpy()[sel]),
        JFeat(*(jnp.asarray(np.stack([getattr(jprev[i], f) for i in idx]))
                for f in JFeat._fields)),
        jnp.asarray(INIT[sel]), jnp.asarray(np.array(FAST, np.float32)[sel]),
        jnp.asarray(np.array(ORB, np.int32)[sel])))
    ti, tv, m_valid, pose, valid, _res, _iters = outs
    _assert_same_features(vo.stack_features(curs), jcur)
    np.testing.assert_array_equal(m_valid.numpy(), np.asarray(jcur.m_valid))
    np.testing.assert_array_equal(ti.numpy(), jti)
    np.testing.assert_array_equal(tv.numpy(), jtv)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    np.testing.assert_allclose(pose.numpy(), jpose, atol=POSE_TOL)
    assert bool(valid.all()) and int(tv.sum(-1).min()) > 30


# (keyframe frames, current frame) of three sequences of the small sequence
CHECK_SEQS = (((0, 3, 6, 9), 12), ((2, 5, 8), 11), ((1, 4, 7, 10), 13))
DA_OPTIONS = dict(max_orb_distance_da=60.0, residual_th=10.0, max_y_diff_epipolar=1.5,
                  da_filter_by_direction=False)
# JAX's fleet check takes its stage-2 filters from da_stage2_method (3: the
# fundamental matrix and the change in pose), the port from two flags
STAGE2 = 3


def _qa_prog_options(je0) -> dict:
    """The options JAX's ``_build_qa_prog`` passes ``query_and_associate``,
    as the port's check takes them."""
    o, m = je0.opts, je0.opts.da_stage2_method
    return dict(max_orb_distance_da=o.max_orb_distance_da, residual_th=o.residual_th,
                max_y_diff_epipolar=o.max_y_diff_epipolar,
                filter_by_direction=o.da_filter_by_direction, use_fund_matrix=m in (1, 3),
                use_change_pose=m in (2, 3), kernel_param=je0.vo_opts.kernel_param)


@pytest.fixture(scope="module")
def check_parts():
    """The three sequences' JAX stores and BoW databases (one vocabulary),
    their current frames, and the JAX estimator whose ``_build_qa_prog`` is
    the reference."""
    stores, currents, descs = [], [], []
    for kfs, cur in CHECK_SEQS:
        feats = jax_features(kfs + (cur,))
        stores.append(jax_store(feats[:-1]))
        currents.append(feats[-1])
        descs += [np.asarray(f.desc_l)[np.asarray(f.m_valid)] for f in feats[:-1]]
    jvoc = JVoc.train(np.concatenate(descs), k=8, L=3, seed=0)
    dbs = []
    for js in stores:
        jdb = JBoW(jvoc, max_kfs=js.max_kfs)
        jdb.rebuild_from_store(js.arrays, js.n_kfs)
        dbs.append(jax.device_get(jdb._db))
    je0 = JEstimator(JGeneral(), JOptions(camera=JCam(**SMALL_CAM), da_stage2_method=STAGE2,
                                          **DA_OPTIONS),
                     JVO(), capacity=CAPACITY, max_kfs=8)
    je0.initialize(vocabulary=jvoc)
    return jvoc, stores, dbs, currents, je0


def _check_fleet(check_parts):
    """A port fleet of the three sequences on the CPU holding the JAX
    stores, databases and current frames, one vocabulary."""
    jvoc, stores, dbs, currents, _je0 = check_parts
    voc = Vocabulary.from_jax_numpy(jvoc)
    ests = []
    for js, db, cur in zip(stores, dbs, currents):
        e = SRBAStereoSLAMEstimator(
            GeneralOptions(), SRBAStereoSLAMOptions(camera=StereoCamera(**SMALL_CAM),
                                                    **DA_OPTIONS),
            VOOptions(), capacity=CAPACITY, max_kfs=8, device="cpu")
        e.initialize(vocabulary=voc)
        e.store = port_store(js)
        e.bow._db.copy_(torch.from_numpy(np.array(db)))
        e.bow.n_kfs = js.n_kfs
        e.vo._prev = port_features(cur)
        ests.append(e)
    return fleet.FleetSLAM(ests)


GROUP = ((2, 9), (0, 10))    # (sequence, seed) of the checking sequences


def test_check_group_matches_jax_qa_prog(check_parts, monkeypatch):
    jvoc, stores, dbs, currents, je0 = check_parts
    flt = _check_fleet(check_parts)
    opts = _qa_prog_options(je0)
    assert opts["use_fund_matrix"] and opts["use_change_pose"]
    group = [(flt.ests[i], None, False, seed) for i, seed in GROUP]
    got = [a.numpy() for a in flt._check_group(0, opts, group)]
    sel = [i for i, _ in GROUP]
    top_s, top_i, _cand, da = jax.device_get(jfleet.FleetSLAM._build_qa_prog(None, je0)(
        JFeat(*(jnp.asarray(np.stack([getattr(currents[i], f) for i in sel]))
                for f in JFeat._fields)),
        type(stores[0].arrays)(*(jnp.stack([jnp.asarray(getattr(stores[i].arrays, f))
                                            for i in sel])
                                 for f in stores[0].arrays._fields)),
        jnp.stack([jnp.asarray(dbs[i]) for i in sel]),
        jnp.asarray([stores[i].n_kfs for i in sel], jnp.int32),
        jnp.asarray([seed for _, seed in GROUP], jnp.uint32)))
    assert len(got) == 11
    np.testing.assert_array_equal(got[1], top_i)
    np.testing.assert_allclose(got[0], top_s, atol=1e-6)
    for a, b, name in zip(got[2:5], (da.status, da.other_idx, da.tracked_count),
                          ("status", "other_idx", "tracked")):
        np.testing.assert_array_equal(a, b, err_msg=name)
    for a, name in zip(got[5:10], ("m_valid", "xs_l", "ys_l", "xs_r", "m_r_idx")):
        np.testing.assert_array_equal(a, np.stack([np.asarray(getattr(currents[i], name))
                                                   for i in sel]), err_msg=name)
    np.testing.assert_allclose(got[10], np.stack([currents[i].pts3d for i in sel]), atol=1e-6)
    assert int(np.asarray(da.tracked_count)[:, 0].min()) >= 15
    # each sequence's row equals its one-sequence check (a group of one)
    for q, (i, seed) in enumerate(GROUP):
        one = flt._check_group(0, opts, [(flt.ests[i], None, False, seed)])
        for a, b in zip(got, one):
            np.testing.assert_array_equal(a[q], b[0].numpy())


def test_batched_vo_step_tensor_thresholds_match_jax_batched_step(shared_blur):  # noqa: F811
    from test_torch_batched_solve import SMALL, _frames

    lefts, rights = _frames(9)
    init = np.zeros((3, 6), np.float32)
    k = 64
    jprev, tprev = jbatch.empty_features(3, k), batch.empty_features(3, k, device="cpu")
    for _step in range(2):
        jout = jax.device_get(jbatch._batched_step(
            jnp.asarray(lefts), jnp.asarray(rights), jprev, jnp.asarray(init), JCam(**SMALL),
            jnp.float32(10.0), jnp.int32(50), k=k, cell=5))
        tout = batch.batched_vo_step(batch.make_mesh(devices=["cpu"]), lefts, rights, tprev,
                                     init, StereoCamera(**SMALL), fast_th=torch.tensor(10.0),
                                     orb_th=torch.tensor(50), k=k)
        _assert_same_features(tout[0], jout[0])
        np.testing.assert_array_equal(tout[2].numpy(), jout[2])
        np.testing.assert_allclose(tout[1].numpy(), jout[1], atol=POSE_TOL)
        np.testing.assert_allclose(float(tout[3]), float(jout[3]), atol=POSE_TOL)
        assert float(tout[4]) == float(jout[4])
        jprev, tprev = jout[0], tout[0]
        lefts, rights = np.roll(lefts, 1, axis=-1), np.roll(rights, 1, axis=-1)
    assert bool(tout[2].all())


def test_program_keys_separate_shapes_options_and_held(check_parts, monkeypatch):
    """``attempt_key``: the pending count, the shard's frames' count, size
    and dtype, the maps' presence, the camera, each frontend and solve
    option and the GN block route; ``fleet_check_key``: the group's size,
    the held count, the shapes, ``debug`` and each cascade option;
    ``step_key``: the frames, ``k`` and ``cell``; ``program_key``: a held
    tensor put in another's place (the same contents) gives another key,
    the same tensors the same key, and the inputs' values never."""
    cam = StereoCamera(**CAM)
    frames = torch.zeros((3, 96, 160), dtype=torch.uint8)
    e = SRBAStereoSLAMEstimator(
        GeneralOptions(), SRBAStereoSLAMOptions(camera=cam, **FLEET_OPTIONS),
        VOOptions(fast_th=12, n_feats=128), capacity=128, max_kfs=32, device="cpu")
    e.initialize()
    front = {k: v for k, v in e.vo.frontend_options().items() if k not in ("rect_maps", "device")}
    opts = {**front, **e.vo.solve_options()}
    scan_opts = {name for name in inspect.signature(vo.vo_scan).parameters} - {
        "lefts", "rights", "prev", "init_pose", "cam", "fast_th", "orb_th", "rect_maps",
        "device", "nms_radius", "margin", "min_disparity", "max_disparity"}
    assert scan_opts <= set(opts)
    base = vo.attempt_key(frames, 3, cam, None, **opts)
    assert vo.attempt_key(frames.clone(), 3, StereoCamera(**CAM), None, **dict(opts)) == base
    keys = [base, vo.attempt_key(frames, 2, cam, None, **opts),
            vo.attempt_key(frames, 1, cam, None, **opts),
            vo.attempt_key(torch.zeros((4, 96, 160), dtype=torch.uint8), 3, cam, None, **opts),
            vo.attempt_key(torch.zeros((3, 97, 160), dtype=torch.uint8), 3, cam, None, **opts),
            vo.attempt_key(frames.float(), 3, cam, None, **opts),
            vo.attempt_key(frames, 3, cam, ("maps",), **opts),
            vo.attempt_key(frames, 3, StereoCamera(**{**CAM, "baseline": 0.6}), None, **opts)]
    for name, v in opts.items():
        keys.append(vo.attempt_key(frames, 3, cam, None,
                                   **{**opts, name: (not v) if isinstance(v, bool) else v + 1}))
    monkeypatch.setattr(robust_lm, "GN_GRAPHS", not robust_lm.GN_GRAPHS)
    keys.append(vo.attempt_key(frames, 3, cam, None, **opts))
    monkeypatch.undo()
    keys += [batch.step_key(frames, cam, 64, 5), batch.step_key(frames, cam, 128, 5),
             batch.step_key(frames, cam, 64, 4), batch.step_key(frames[:2], cam, 64, 5)]
    assert keys[-4] == batch.step_key(frames.clone(), cam, 64, 5)

    flt = _check_fleet(check_parts)
    ests = flt.ests
    copts = ests[0].check_options()
    curs = [x.vo.last_frame() for x in ests]
    stores, dbs = [x.store.arrays for x in ests], [x.bow._db for x in ests]
    cbase = tda.fleet_check_key(curs[:2], stores, dbs, ests[0].cam, 4, False, **copts)
    assert tda.fleet_check_key(curs[1:], stores, dbs, ests[0].cam, 4, False, **copts) == cbase
    keys += [cbase, tda.fleet_check_key(curs, stores, dbs, ests[0].cam, 4, False, **copts),
             tda.fleet_check_key(curs[:2], stores[:2], dbs[:2], ests[0].cam, 4, False, **copts),
             tda.fleet_check_key(curs[:2], stores, dbs, ests[0].cam, 4, True, **copts),
             tda.fleet_check_key(curs[:2], stores, dbs, ests[0].cam, 5, False, **copts)]
    for name, v in copts.items():
        keys.append(tda.fleet_check_key(curs[:2], stores, dbs, ests[0].cam, 4, False, **{
            **copts, name: (not v) if isinstance(v, bool) else v + 1}))
    assert len(set(keys)) == len(keys)

    table = torch.zeros((2, 3), dtype=torch.int64)
    held = dict(stores=stores, dbs=dbs, leaf_bits=ests[0].bow._leaf_bits,
                weights=ests[0].bow._weights)
    pkey = cuda_graphs.program_key(dict(curs=curs[:2], table=table), cbase, held)[0]
    assert cuda_graphs.program_key(dict(curs=curs[1:], table=table + 5), cbase, held)[0] == pkey
    moved = [cuda_graphs.program_key(dict(curs=curs[:2], table=table), cbase,
                                     {**held, name: value})[0]
             for name, value in (("dbs", [dbs[0], dbs[1].clone(), dbs[2]]),
                                 ("stores", [stores[0]._replace(desc_l=stores[0].desc_l.clone()),
                                             *stores[1:]]),
                                 ("weights", held["weights"].clone()))]
    assert len({pkey, *moved}) == 4


def _refuse_reads(monkeypatch):
    def refuse(name):
        def read(*a, **k):
            raise AssertionError(f"a program's body read a tensor on the host: Tensor.{name}")
        return read

    for name in _READS:
        monkeypatch.setattr(torch.Tensor, name, refuse(name))


def test_programs_read_nothing_on_the_host(check_parts, monkeypatch):
    """The attempt (all pending, then a retry of two), the check group (on
    the card's Horn route) and the batched step (the port's own blur),
    their loops unread, with
    every Tensor host read patched to raise: the same outputs as unpatched
    (a read would break the capture on a card)."""
    from test_torch_batched_solve import SMALL, _frames

    seqs = _attempt_frames()
    flt, _je0, _jprev = _attempt_fleet(seqs)
    lefts, rights = _attempt_inputs(seqs)
    cflt = _check_fleet(check_parts)
    copts = cflt.ests[0].check_options()
    group = [(cflt.ests[i], None, False, seed) for i, seed in GROUP]
    bl, br = _frames(9)
    bprev = batch.empty_features(3, 64, device="cpu")
    monkeypatch.setattr(tda, "_kabsch_rotation", tda._horn_rotation)

    def run():
        with cuda_graphs.no_exit_reads():
            return ([flt._attempt(0, idx, lefts, rights)[1:] for idx in ([0, 1, 2], [0, 2])],
                    cflt._check_group(0, copts, group),
                    batch.batched_vo_step(batch.make_mesh(devices=["cpu"]), bl, br, bprev,
                                          np.zeros((3, 6), np.float32), StereoCamera(**SMALL),
                                          fast_th=torch.tensor(10.0), orb_th=torch.tensor(50),
                                          k=64))

    ref = run()
    _refuse_reads(monkeypatch)
    got = run()
    monkeypatch.undo()
    ref_leaves, ref_spec = pytree.tree_flatten(ref)
    got_leaves, got_spec = pytree.tree_flatten(got)
    assert got_spec == ref_spec
    assert len(got_leaves) == (3 + 2) * 13 + 2 * 7 + 11 + 13 + 4
    assert all(torch.equal(a, b) for a, b in zip(got_leaves, ref_leaves))
    assert int(got[1][4][:, 0].min()) >= 15

