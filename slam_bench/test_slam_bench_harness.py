"""The harness on the CPU: discovery by name, its arithmetic, the work
counts of the kernels' rooflines, the module guard, and whole runs of a
cell cut to a tiny size (the result line's keys; the control and planted
faults read as not correct).

The tiny runs drive the program on the CPU with its plain kernels, a
320x128 camera, a 24-frame log and a 2 s window; what needs the card (the
traced instruments, the kernels) is in ``test_card_run``, which skips here.
"""

from __future__ import annotations

import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch

from slam_bench import correct, roofline, run, spec, stats

LATER = os.path.join(spec.HERE, "later")


def with_later(bench: dict) -> dict:
    """``bench`` with the entries of the cells held out of it (``later/``),
    whose files stay in the harness: their runs are tested here too."""
    bench = copy.deepcopy(bench)
    for name in sorted(os.listdir(LATER)):
        held = spec.load_json(os.path.join(LATER, name))
        for key in ("workloads", "end_to_end", "per_layer"):
            bench[key] += held[key]
    return bench


# ------------------------------------------------------------------ discovery
def test_benchmark_names_every_file_and_reader():
    bench = with_later(spec.load_benchmark())
    for w in bench["workloads"]:
        c = spec.cell(w["name"], bench)
        assert c.config["name"] == w["config"]
        assert c.traffic["entry"] in ("batched", "step")
        assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
        assert len(c.end_to_end) >= 2 and c.per_layer
        for entry, reader in c.per_layer:
            for key in spec.READER_KEYS:
                assert hasattr(reader, key)
            assert (reader.NAME, reader.UNIT, reader.BETTER, reader.LAYER, reader.SOURCE,
                    reader.MOVES) == (entry["name"], entry["unit"], entry["better"],
                                      entry["layer"], entry["source"], entry["moves"])
            assert reader.WORKLOADS == entry.get("workloads")
            assert entry["moves"] in {m["name"] for m in c.end_to_end}


def test_contract_limits_of_benchmark_json():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for w in bench["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert len(json.dumps(bench)) < 64 * 1024
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]


def test_held_out_cells_are_not_in_benchmark_json():
    bench = spec.load_benchmark()
    held = with_later(dict(workloads=[], end_to_end=[], per_layer=[]))
    assert held["workloads"] and held["end_to_end"] and held["per_layer"]
    names = {x["name"] for k in ("workloads", "end_to_end", "per_layer") for x in bench[k]}
    assert not names & {x["name"] for k in held for x in held[k]}


def test_a_new_file_is_found_without_an_edit(tmp_path):
    """A new configuration, traffic mix and per-layer metric are files and
    entries only: the harness finds them by name."""
    here = tmp_path / "slam_bench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = with_later(spec.load_benchmark())
    cfg = json.loads((here / "configs" / "kitti00-stereo.json").read_text())
    cfg["name"] = "kitti06-stereo"
    (here / "configs" / "kitti06-stereo.json").write_text(json.dumps(cfg))
    tr = json.loads((here / "traffic" / "logs-b8.json").read_text())
    tr["batch"] = 20
    (here / "traffic" / "logs-b20.json").write_text(json.dumps(tr))
    (here / "metrics" / "checks_per_frame.logs.py").write_text(
        'NAME = "checks_per_frame.logs"\nUNIT = "checks/frame"\nBETTER = "lower"\n'
        'LAYER = "keyframe check (models/data_association.py, models/bow.py)"\n'
        'SOURCE = "program_counter"\nMOVES = "fps"\nWORKLOADS = ["kitti06-logs-b20"]\n\n\n'
        'def read(t):\n    return t["checks"] / t["frames"]\n')
    bench["configs"].append(dict(name="kitti06-stereo", source="x", reduced=[], why="x",
                                 file="slam_bench/configs/kitti06-stereo.json"))
    bench["workloads"].append(dict(name="kitti06-logs-b20", config="kitti06-stereo",
                                   traffic="logs-b20", chips=1, why="x"))
    next(m for m in bench["end_to_end"] if m["name"] == "fps")["workloads"].append(
        "kitti06-logs-b20")
    bench["per_layer"].append(dict(name="checks_per_frame.logs", unit="checks/frame",
                                   better="lower", source="program_counter", moves="fps",
                                   layer="keyframe check (models/data_association.py, models/bow.py)",
                                   workloads=["kitti06-logs-b20"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.cell("kitti06-logs-b20", root=str(tmp_path), here=str(here))
    assert c.config["name"] == "kitti06-stereo" and c.traffic["batch"] == 20
    assert [e["name"] for e, _r in c.per_layer] == ["checks_per_frame.logs"]
    assert c.per_layer[0][1].read(dict(checks=3, frames=12)) == 0.25
    assert sorted(m["name"] for m in c.end_to_end) == ["fps", "setup_s"]


# ----------------------------------------------------------------- arithmetic
def test_percentile_is_over_all_samples():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 0.95) == 95
    assert stats.percentile([5.0], 0.95) == 5.0
    assert stats.percentile([3, 1, 2, 4], 0.5) == 2
    assert stats.percentile([], 0.95) is None
    # a tail of one long request in twenty: the 95th percentile is short,
    # the 96th of the same samples long
    xs = [1.0] * 95 + [100.0] * 5
    assert stats.percentile(xs, 0.95) == 1.0 and stats.percentile(xs, 0.96) == 100.0


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = 10.75, 12.5, 14.25
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)


def test_union_gaps_and_cover():
    spans = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (8.0, 8.0)]
    assert stats.union(spans) == [(0.0, 3.0), (5.0, 6.0)]
    assert stats.covered(spans) == 4.0
    assert stats.gaps(spans, 0.0, 10.0) == [(6.0, 10.0), (3.0, 5.0)]
    assert stats.gaps([(-1.0, 1.0)], 0.0, 2.0) == [(1.0, 2.0)]


def test_k1_and_k2_work_counts():
    imgs = torch.zeros((2, 40, 48), dtype=torch.uint8)
    imgs[0, 20, 24] = 200      # one bright dot: every circle tap is darker
    n_bytes, n_ops = roofline.k1_work(imgs, 20.0)
    assert n_bytes == 2 * 40 * 48 * (1 + 4)
    inner = 2 * (40 - 32) * (48 - 32)
    # the dot passes the compass bound and keeps a score; its 12 circle
    # neighbours at distance 3 each see one compass tap of 200 brighter
    # than them by more than 20 and pass the bound too, keeping none
    th = torch.full((2,), 20.0)
    kept = int((roofline.frontend.suppress(roofline.frontend.fast_scores(imgs, th)) > 0).sum())
    assert kept == 1
    n_pass = (n_ops - inner * roofline.COMPASS_OPS_PER_PX - kept * roofline.NMS_OPS_PER_PX) // (
        roofline.FAST_SCORE_OPS_PER_PX - roofline.COMPASS_OPS_PER_PX)
    assert 1 <= n_pass <= 5
    ys = torch.tensor([[20, 0], [0, 0]], dtype=torch.int32)
    xs = torch.tensor([[24, 0], [0, 0]], dtype=torch.int32)
    valid = torch.tensor([[True, False], [False, False]])
    k2_bytes, k2_ops = roofline.k2_work(imgs, ys, xs, valid)
    pts = {(int(y), int(x)) for y, x in np.clip(
        np.concatenate([20 + roofline.frontend.PATTERN[:, [0, 2]].ravel()[:, None],
                        24 + roofline.frontend.PATTERN[:, [1, 3]].ravel()[:, None]], 1),
        0, [39, 47])}
    assert k2_ops == len(pts) * roofline.BLUR_OPS_PER_POINT + 256
    assert k2_bytes > 4 * (4 + 4 + 1) + 4 * 32


def test_roofline_bound_is_the_larger_of_bytes_and_operations():
    assert roofline.bound_ms(3.35e9, 0) == pytest.approx(1.0)
    assert roofline.bound_ms(0, 67e9) == pytest.approx(1.0)
    assert roofline.bound_ms(3.35e9, 67e9 * 2) == pytest.approx(2.0)


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax", "srba_slam_tpu",
             "srba_slam_tpu.models.vo", "srba_slam_tpu_torch", "srba_slam_tpu_torch.models",
             "jaxtyping", "numpy", "flax_like"]
    assert run.forbidden_modules(names) == ["flax", "jax", "jax.numpy", "jaxlib.xla_client",
                                            "srba_slam_tpu", "srba_slam_tpu.models.vo"]
    assert run.forbidden_modules(["srba_slam_tpu_torch.ops.fast", "torch"]) == []


def test_harness_sources_import_no_jax_stack():
    import ast

    for root, _dirs, files in os.walk(spec.HERE):
        for name in files:
            if not name.endswith(".py") or name.startswith("test_"):
                continue
            tree = ast.parse(open(os.path.join(root, name)).read())
            for node in ast.walk(tree):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                        [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                for m in mods:
                    assert m.split(".")[0] not in run.FORBIDDEN, (name, m)


def test_reference_imports_nothing_of_the_program():
    import ast

    ref = os.path.join(spec.HERE, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tree = ast.parse(open(os.path.join(ref, name)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.ImportFrom):
                    assert not (node.module or "").startswith("srba_slam_tpu"), name
                if isinstance(node, ast.Import):
                    assert not any(a.name.startswith("srba_slam_tpu") for a in node.names), name


# ------------------------------------------------------------- whole runs
def tiny_cell(name: str = "kitti00-logs-b8") -> spec.Cell:
    """``name`` cut to the CPU: a 320x128 camera of the same field of view,
    200 features at capacity 256, a 24-frame log, a vocabulary of 256 words.
    A cell held out of ``BENCHMARK.json`` (``later/``) is found too."""
    c = spec.cell(name, with_later(spec.load_benchmark()))
    cfg = copy.deepcopy(c.config)
    cam = cfg["camera"]
    sx, sy = 320 / cam["width"], 128 / cam["height"]
    for k in ("fx_l", "fx_r", "cx_l", "cx_r"):
        cam[k] *= sx
    for k in ("fy_l", "fy_r", "cy_l", "cy_r"):
        cam[k] *= sy
    cam["width"], cam["height"] = 320, 128
    cfg.update(capacity=256, max_kfs=64)
    cfg["options"]["n_feats"] = cfg["vo_options"]["n_feats"] = 200
    cfg["log"].update(frames=24, step_m=max(cfg["log"]["step_m"], 0.2), warmup_frames=8)
    cfg["vocabulary"].update(k=16, L=2, train_frames=4, features=128, camera=dict(cam))
    return spec.Cell(c.name, cfg, dict(c.traffic), c.end_to_end, c.per_layer, 1)


@pytest.fixture(scope="module")
def threads():
    prev = torch.get_num_threads()
    yield
    torch.set_num_threads(prev)


def _run(cell, **kw):
    import time

    return run.run(cell, 2**31 + 12345, 2.0, False, "cpu", t_start=time.perf_counter(), share=1.0,
                   **kw)


def test_tiny_run_line_keys_and_correct(threads):
    line = _run(tiny_cell())
    assert list(line)[:3] == ["correct", "attempted", "failed"]
    assert list(line)[-1] == "checks"
    assert {"metrics", "device"} <= set(line)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"fps", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert line["device"]["count"] == 1 and line["attempted"] >= 1
    assert set(line["checks"]) == set(correct.NUMBERS) | set(correct.MIN_CASES)


def test_tiny_online_run_reports_the_tail(threads):
    line = _run(tiny_cell("kitti00-online-b1"))
    assert set(line["metrics"]) == {"frame_pose_p95_ms", "setup_s"}
    assert line["correct"] is True, line["checks"]


def test_control_is_not_correct(threads):
    """The reference in bfloat16 in the program's place fails the check."""
    line = _run(tiny_cell(), control_dtype=torch.bfloat16)
    assert line["correct"] is False
    c = line["checks"]
    assert sum(c[k]["value"] > c[k]["limit"] for k in correct.NUMBERS) >= 1


@pytest.mark.parametrize("fault", ["pose_altered", "state_unchanged", "descriptor_altered",
                                   "half_batch"])
def test_planted_faults_are_not_correct(threads, monkeypatch, fault):
    """The timed path broken underneath: a scan's answer altered where it
    is produced, its solve returning the state it started from, or half of
    its batch left out (answered with the other half's answers)."""
    from srba_slam_tpu_torch.models import estimator

    orig = estimator.vo_scan

    def broken(lefts, rights, prev, init_pose, *a, **kw):
        last_feat, last_inc, outs = orig(lefts, rights, prev, init_pose, *a, **kw)
        feats, ti, tv, poses, pv, ni, mr = outs
        if fault == "pose_altered":
            poses = poses + torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.05])
        elif fault == "state_unchanged":
            poses = torch.as_tensor(init_pose, dtype=poses.dtype).expand_as(poses).clone()
        elif fault == "descriptor_altered":
            feats = feats._replace(desc_l=feats.desc_l ^ 1)
        else:
            b = poses.shape[0]
            idx = torch.arange(b) % max(b // 2, 1)
            feats = type(feats)(*(x[idx] for x in feats))
            poses, pv = poses[idx], pv[idx]
        return last_feat, last_inc, (feats, ti, tv, poses, pv, ni, mr)

    monkeypatch.setattr(estimator, "vo_scan", broken)
    line = _run(tiny_cell())
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", ["window_unchanged", "score_altered"])
def test_planted_check_and_window_faults_are_not_correct(threads, monkeypatch, fault):
    """A window solve returning the window it was given; a check's BoW
    score altered where the query produces it."""
    from srba_slam_tpu_torch.models import data_association, srba

    if fault == "score_altered":
        orig = data_association.bow_candidates

        def broken(*a, **kw):
            top_s, top_i, cand, valid = orig(*a, **kw)
            return top_s + 0.01, top_i, cand, valid

        monkeypatch.setattr(data_association, "bow_candidates", broken)
    else:
        orig = srba.optimize_window

        def broken(win, cam, **kw):
            r = orig(win, cam, **kw)
            return r._replace(cam_pose=win.cam_pose.clone(), lm_pos=win.lm_pos.clone())

        monkeypatch.setattr(srba, "optimize_window", broken)
    line = _run(tiny_cell())
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", ["pose_altered", "state_unchanged", "descriptor_altered",
                                   "window_unchanged", "score_altered"])
def test_planted_online_faults_are_not_correct(threads, monkeypatch, fault):
    """The per-frame path of ``kitti00-online-b1`` broken underneath: a
    pass's pose or descriptors altered where the pass produces them, its
    solve returning the increment it started from, a window solve returning
    its window, a check's BoW score altered (a batch of one frame has no
    half to leave out)."""
    from srba_slam_tpu_torch.models import data_association, srba, vo

    if fault == "window_unchanged":
        orig_solve = srba.optimize_window

        def broken_solve(win, cam, **kw):
            r = orig_solve(win, cam, **kw)
            return r._replace(cam_pose=win.cam_pose.clone(), lm_pos=win.lm_pos.clone())

        monkeypatch.setattr(srba, "optimize_window", broken_solve)
    elif fault == "score_altered":
        orig_bow = data_association.bow_candidates

        def broken_bow(*a, **kw):
            top_s, top_i, cand, valid = orig_bow(*a, **kw)
            return top_s + 0.01, top_i, cand, valid

        monkeypatch.setattr(data_association, "bow_candidates", broken_bow)
    else:
        orig_pass = vo.StereoVOEngine.process_stereo_pair

        def broken_pass(eng, left, right):
            init = np.array(eng.initial_increment(), np.float32)
            had_prev = eng._prev is not None
            out = orig_pass(eng, left, right)
            if not had_prev:
                return out
            if fault == "pose_altered":
                return out._replace(pose_increment=out.pose_increment
                                    + np.array([0, 0, 0, 0, 0, 0.05], np.float32))
            if fault == "state_unchanged":
                return out._replace(pose_increment=init)
            eng._prev = eng._prev._replace(desc_l=eng._prev.desc_l ^ 1)
            return out

        monkeypatch.setattr(vo.StereoVOEngine, "process_stereo_pair", broken_pass)
    line = _run(tiny_cell("kitti00-online-b1"))
    assert line["correct"] is False, line["checks"]


# ---------------------------------------------------------- loop closures
LOOP_LIMITS = dict(edge_gap_m=0.5, edge_gap_rad=0.02, loop_edges_min=1)
EDGE_CHECKS = {"edge_gap_m_max", "edge_gap_rad_max", "loop_edges"}


def _passing_numbers() -> dict:
    return {**{k: 0.0 for k in correct.NUMBERS}, **{k: 16 for k in correct.MIN_CASES}}


def _circuit_poses():
    from slam_bench import render

    c = render.Circuit([64, 32], 10)
    return render.path_poses(int(2 * c.length / 0.8), 2**31 + 3, 0.8, True, c), int(c.length / 0.8)


def _truth(poses, fu, fv) -> np.ndarray:
    """The pose of frame ``fv``'s left camera in frame ``fu``'s."""
    Ru, Rv = correct.rotvec_to_R(poses[fu, :3]), correct.rotvec_to_R(poses[fv, :3])
    from slam_bench import render

    return np.concatenate([render.so3_log(Ru.T @ Rv), Ru.T @ (poses[fv, 3:] - poses[fu, 3:])])


def _session(poses, lap, edge: str, end: int | None = None):
    """An estimator's step log and graph after a lap and a bit (or up to
    frame ``end``): keyframes every 10 frames joined by true odometry
    edges, and one loop-closure edge from the keyframe at frame 20 into a
    lap-two keyframe, as ``edge`` plants it."""
    from types import SimpleNamespace

    from srba_slam_tpu_torch.models.estimator import StepResult
    from srba_slam_tpu_torch.models.srba import SRBAEngine
    from srba_slam_tpu_torch.utils.camera import StereoCamera

    rba = SRBAEngine(StereoCamera(**tiny_cell().config["camera"]), device="cpu")
    frames = list(range(0, lap + 40 if end is None else end, 10))
    log = [StepResult(frame_idx=f, inserted_kf=k) for k, f in enumerate(frames)]
    for k in range(1, len(frames)):
        rba._add_edge(k - 1, k, _truth(poses, frames[k - 1], frames[k]), kind=0)
    # a rejected closure's edge, rolled back: not read
    e = rba._add_edge(1, len(frames) - 2, np.zeros(6), kind=2)
    rba._remove_edge(e)
    log[-2].lc_rejected_with = 1
    if edge == "none" or frames[-1] <= lap:
        return SimpleNamespace(step_log=log, rba=rba)
    # the lap-two keyframe nearest frame 20, and one half a lap from it
    v = int(np.argmin([np.linalg.norm(poses[f, 3:] - poses[20, 3:]) if f > lap else np.inf
                       for f in frames]))
    u = frames.index(20)
    pose = _truth(poses, 20, frames[v])
    if edge == "moved":
        pose[3:] += np.array([0.6, 0.0, 0.8])
    elif edge == "rotated":
        pose[:3] += np.array([0.0, 0.05, 0.0])
    elif edge == "half_lap":
        u = frames.index(20 + (lap // 2) // 10 * 10)
    if edge == "unconfirmed":
        # a far edge that no step confirmed (the top-voted area's, kind 1),
        # seeded off by a metre: read like any other
        pose[3:] += np.array([1.0, 0.0, 0.0])
        rba._add_edge(u, v, pose, kind=1)
    else:
        log[v].loop_closure_with = u
        rba._add_edge(u, v, pose, kind=2)
    return SimpleNamespace(step_log=log, rba=rba)


def _judge(rec: correct.Recorder, limits: dict) -> tuple[bool, dict, dict]:
    cases = rec.cases(np.random.default_rng(0))
    out = {}
    correct._edges(cases["edges"], cases["poses"], out)
    ok, checks = correct.verdict({**_passing_numbers(), **out}, limits)
    return ok, checks, out


@pytest.mark.parametrize("edge", ["true", "moved", "rotated", "half_lap", "unconfirmed", "none"])
def test_loop_edges_against_the_ground_truth(edge):
    """Every standing edge is judged, whatever step made it: a true map
    reads as correct; a loop edge moved by 1 m, one turned by 0.05 rad,
    one between keyframes half a lap apart, a far edge that no step
    confirmed seeded a metre off, and a run with no loop edge do not."""
    poses, lap = _circuit_poses()
    rec = correct.Recorder(5, poses=poses)
    sess = _session(poses, lap, edge)
    rec.session_end(sess, True)
    ok, checks, out = _judge(rec, {**tiny_cell().config["limits"], **LOOP_LIMITS})
    assert ok is (edge == "true"), checks
    assert set(checks) == set(correct.NUMBERS) | set(correct.MIN_CASES) | EDGE_CHECKS
    # every valid edge was read: the chain, and the loop edge but for "none"
    assert out["edges"] == int(sess.rba.edge_valid.sum()) == len(sess.step_log) - (edge == "none")
    assert out["loop_edges"] == (edge not in ("none", "half_lap"))
    gap_m, gap_rad = out["edge_gap_m_max"], out["edge_gap_rad_max"]
    if edge in ("true", "none"):
        assert gap_m < 1e-9 and gap_rad < 1e-9
    elif edge == "moved":
        assert gap_m == pytest.approx(1.0) and gap_rad < 1e-9
    elif edge == "rotated":
        assert gap_m < 1e-9 and gap_rad == pytest.approx(0.05, rel=0.05)
    elif edge == "half_lap":
        assert gap_m > 10.0
    elif edge == "unconfirmed":
        assert gap_m == pytest.approx(1.0)


def test_loop_edges_are_counted_per_session():
    """The loop edges are those standing at one session's end, the fewest
    over the sessions that walked the whole log, not a sum over sessions;
    a session cut before the revisit counts only where no session was
    whole."""
    poses, lap = _circuit_poses()
    limits = {**tiny_cell().config["limits"], **LOOP_LIMITS}
    rec = correct.Recorder(5, poses=poses)
    for session in range(3):
        rec.session = session
        rec.session_end(_session(poses, lap, "true"), True)
    rec.session = 3
    rec.session_end(_session(poses, lap, "true", end=lap // 2), False)
    ok, checks, out = _judge(rec, limits)
    assert ok and out["loop_edges"] == 1 and out["loop_edges_by_session"] == {0: 1, 1: 1, 2: 1, 3: 0}
    cut = correct.Recorder(5, poses=poses)
    cut.session_end(_session(poses, lap, "true", end=lap // 2), False)
    ok, checks, out = _judge(cut, limits)
    assert not ok and checks["loop_edges"] == dict(value=0, limit=1)


def test_loop_numbers_are_judged_only_where_the_limits_name_them():
    """With ``kitti00-stereo``'s limits the verdict's checks are those it
    had, whatever edge numbers the run holds; a run of a straight street
    reads no edge at all."""
    limits = spec.cell("kitti00-online-b1").config["limits"]
    keys = set(correct.NUMBERS) | set(correct.MIN_CASES)
    for extra in ({}, dict(loop_edges=0, edge_gap_m_max=50.0, edge_gap_rad_max=1.0)):
        ok, checks = correct.verdict({**_passing_numbers(), **extra}, limits)
        assert ok is True and set(checks) == keys
    poses, lap = _circuit_poses()
    rec = correct.Recorder(5)
    rec.session_end(_session(poses, lap, "true"), True)
    assert not rec.graphs and "edges" not in rec.cases(np.random.default_rng(0))


def _queue(eng, n: int, lc: set):
    """``n`` queued windows of one bucket, those in ``lc`` with loop-closure
    checks."""
    for i in range(n):
        eng._queued.append(dict(ints=np.full(4, i), floats=np.zeros(2),
                                entry=dict(C=32, L=2048, O=4096, lc_checks=[0] if i in lc else [])))


def test_windows_with_loop_closure_checks_are_always_drawn(monkeypatch):
    """Every window with loop-closure checks is kept and drawn first; the
    other windows are kept and drawn as without them."""
    from srba_slam_tpu_torch.models import srba
    from srba_slam_tpu_torch.utils.camera import StereoCamera

    monkeypatch.setattr(srba.SRBAEngine, "_solve_group",
                        lambda eng, windows, key, capture_only=False:
                        torch.zeros((srba.WINDOW_SLOTS, 3)))
    drawn = []
    for lc in (set(), {3, 9}):
        rec = correct.Recorder(2**31 + 5)
        rec.install()
        try:
            eng = srba.SRBAEngine(StereoCamera(**tiny_cell().config["camera"]), device="cpu")
            for _ in range(40):
                _queue(eng, 12, lc)
                eng._dispatch_queued()
        finally:
            rec.uninstall()
        windows = rec.cases(np.random.default_rng([7, 11]))["windows"]
        drawn.append((rec, windows))
    (plain, w_plain), (mixed, w_mixed) = drawn
    assert [int(w["ints"][0]) for w in plain.windows] == [int(w["ints"][0]) for w in mixed.windows]
    assert not plain.lc_windows and plain.n_lc_windows == 0
    assert mixed.n_lc_windows == 80 and len(mixed.lc_windows) == correct.MAX_CASES["windows"]
    assert len(w_mixed) == correct.MAX_CASES["windows"] and all(w.get("lc") for w in w_mixed)
    assert {int(w["ints"][0]) for w in w_mixed} == {3, 9}
    assert len(w_plain) == correct.MAX_CASES["windows"] and not any(w.get("lc") for w in w_plain)


def tiny_circuit_cell() -> spec.Cell:
    """``kitti00-online-b1`` cut to the CPU as ``tiny_cell``, on a small
    circuit, its limits naming the loop-closure numbers."""
    c = tiny_cell("kitti00-online-b1")
    c.config["log"]["circuit"] = dict(block_m=[64, 32], corner_m=10)
    c.config["limits"] = {**c.config["limits"], **LOOP_LIMITS}
    return c


def test_tiny_circuit_run_reads_its_loop_edges(threads):
    """A run on a circuit reads its sessions' standing edges against the
    ground truth (odometry edges only: no loop in 24 frames) and holds them
    to its limits. At this size the map itself is metres off the truth
    (the frames' poses agree with the reference's, which follows them)."""
    line = _run(tiny_circuit_cell())
    c = line["checks"]
    assert c["loop_edges"] == dict(value=0, limit=1)
    assert c["edge_gap_m_max"]["limit"] == 0.5 and c["edge_gap_m_max"]["value"] > 0.0
    assert c["edge_gap_rad_max"]["limit"] == 0.02 and c["edge_gap_rad_max"]["value"] > 0.0
    assert line["correct"] is False
    assert all(c[k]["value"] <= c[k]["limit"] for k in correct.NUMBERS)


@pytest.mark.cuda
def test_card_run(tmp_path):
    """A short traced run of each cell on the card: correct, and every
    per-layer metric of the cell that its run can read is on the line."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import subprocess
    import sys

    for name in [w["name"] for w in spec.load_benchmark()["workloads"]]:
        out = subprocess.run([sys.executable, "-m", "slam_bench.run", "--workload", name,
                              "--seed", "4242424242", "--seconds", "5", "--trace", "1"],
                             cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-4000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] is True
        assert line["device"]["busy_s"] > 0
