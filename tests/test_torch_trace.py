"""The port's own trace (``utils/trace.py``, switched by
``ops/cuda_graphs.py`` ``record_spans``) on the CPU.

A session of ``demo/config_synthetic_small.ini`` over rendered frames,
stepped once inside ``record_spans()`` and once outside it: the host spans
of the traced session (one ``step`` a frame, every other span under the
``step`` of its frame and inside its parent's interval, ``check`` and
``insertion`` exactly where the step log has them, the counters equal to
their spans), the profiler's sections on the same clock with
``profiler.csv`` as it was, and nothing recorded, nor the trace's clock
read, outside the block. The ``window_tables`` counter: every window of
the session, and each valid slot of a traced group, built on the device;
a window solved alone, on the host. The four per-layer readers of the benchmark
(``slam_bench/metrics/``) on a hand-built record, and the CLI's
``--trace FILE``.
"""

import csv
import json
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from slam_bench import spec
from srba_slam_tpu_torch.__main__ import main
from srba_slam_tpu_torch.models.estimator import SRBAStereoSLAMEstimator
from srba_slam_tpu_torch.ops import cuda_graphs, window_ba
from srba_slam_tpu_torch.utils import trace
from srba_slam_tpu_torch.utils.camera import StereoCamera
from srba_slam_tpu_torch.utils.framesource import SyntheticSource

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "demo", "config_synthetic_small.ini")
N = 12


def _estimator():
    est = SRBAStereoSLAMEstimator.from_config(DEMO, device="cpu")
    est.general.verbose_level = 0
    est.initialize()
    return est


def _profile(est, path) -> list:
    """``profiler.csv``'s names and counts, as ``finalize`` writes it."""
    est.profiler.save_csv(path)
    with open(path) as f:
        return [(row["name"], row["count"]) for row in csv.DictReader(f)]


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trace")
    est = _estimator()
    frames = list(SyntheticSource(est.cam, n_frames=N, step=0.5))
    with cuda_graphs.record_spans() as tr:
        for left, right in frames:
            est.step(left, right)
    n_host = len(tr.host)
    # the same session outside the block, the trace's clock made to raise
    mp = pytest.MonkeyPatch()

    def no_clock():
        raise AssertionError("a site read the trace's clock with no trace recording")

    mp.setattr(trace, "perf_counter", no_clock)
    try:
        off = _estimator()
        for left, right in frames:
            off.step(left, right)
    finally:
        mp.undo()
    return dict(est=est, tr=tr, off=off, n_host=n_host, tmp=tmp)


def test_traced_session_records_one_step_span_a_frame(sessions):
    tr = sessions["tr"]
    steps = [s for s in tr.host if s.name == "step"]
    assert [s.frame for s in steps] == list(range(N))
    assert all(s.parent is None for s in steps)


def test_every_span_nests_under_the_step_of_its_frame(sessions):
    host = sessions["tr"].host
    assert {"vo", "check", "decision", "insertion", "window dispatch", "window plan",
            "window upload", "upload", "read", "queryDB", "performDA"} <= {s.name for s in host}
    for s in host:
        assert s.t1 is not None and s.t0 <= s.t1, s
        if s.name == "step":
            continue
        p = host[s.parent]
        assert p.t0 <= s.t0 and s.t1 <= p.t1, (s, p)
        root = s
        while root.parent is not None:
            root = host[root.parent]
        assert root.name == "step" and root.frame == s.frame, (s, root)


def test_check_and_insertion_spans_where_the_step_log_has_them(sessions):
    est, host = sessions["est"], sessions["tr"].host
    for name, flag in (("check", lambda r: r.kf_check),
                       ("insertion", lambda r: r.inserted_kf is not None)):
        frames = sorted(s.frame for s in host if s.name == name)
        assert frames == [r.frame_idx for r in est.step_log if flag(r)], name
        assert len(frames) >= 2, name


def test_counters_add_up_to_their_spans(sessions):
    tr = sessions["tr"]
    for name, counter in (("read", tr.reads), ("upload", tr.uploads)):
        spans = [s for s in tr.host if s.name == name]
        assert counter == dict(count=len(spans), bytes=sum(s.nbytes for s in spans)), name
        assert counter["count"] and all(s.nbytes > 0 for s in spans), name
    assert all(s.site for s in tr.host if s.name == "read")


def test_profiler_sections_on_the_timeline_and_csv_as_before(sessions):
    est, off, tr, tmp = sessions["est"], sessions["off"], sessions["tr"], sessions["tmp"]
    assert _profile(est, tmp / "on.csv") == _profile(off, tmp / "off.csv")
    assert [r.inserted_kf for r in est.step_log] == [r.inserted_kf for r in off.step_log]
    for name, st in est.profiler.sections.items():
        spans = [s for s in tr.host if s.name == name]
        assert len(spans) == st.count, name
        assert sum(s.t1 - s.t0 for s in spans) == pytest.approx(st.total, rel=1e-12), name


def test_nothing_recorded_outside_the_block(sessions):
    assert trace.ACTIVE is None
    assert len(sessions["tr"].host) == sessions["n_host"]
    assert trace.span("step", frame=0) is trace.NOOP
    assert cuda_graphs.span("eager", "cpu") is trace.NOOP
    assert trace.stamp() is None


def test_the_yielded_list_holds_only_device_triples(sessions):
    tr = sessions["tr"]
    assert isinstance(tr, list)
    assert all(isinstance(x, tuple) and len(x) == 3 for x in tr)
    assert not tr         # the CPU records no device span
    assert tr.anchor is None and not tr.replays


def test_replay_record_names_its_kind_and_key():
    with cuda_graphs.record_spans() as tr:
        with trace.span("step", frame=7) as step:
            t0 = trace.stamp()
            key = ("window_group", 16, 1024, 2048, (True, True, False, False), (("a", 1),),
                   object(), 4, True)
            trace.replay(t0, key, None)
            trace.replay(trace.stamp(), ("frame", 370, 1226, torch.uint8, False, object(),
                                         (("x", 1),)), None)
    assert [(r.kind, r.name, r.parent, r.frame) for r in tr.replays] == [
        ("window_group", "window_group 16x1024x2048 2/4", step.id, 7),
        ("frame", "frame 370 1226 uint8 False", step.id, 7)]
    assert tr.replays_by_kind == {"window_group": 1, "frame": 1}
    assert all(step.t0 <= r.t0 <= r.t1 <= step.t1 for r in tr.replays)
    assert trace.key_name(("check", "one", (512, 32), 4, False)) == "check one 512x32 4 False"


# ------------------------------------------------------------------ readers
READERS = ("window_dispatch_host_ms_per_kf.online", "read_wait_ms_per_frame.online",
           "check_answer_lag_ms.online", "program_launch_host_us.online")


def _hand_trace():
    """A frame with a check (its program under ``queryDB``, a window group
    and the one read under ``performDA``) and an insertion; host seconds
    from the anchor, device events as ms after it."""
    tr = trace.Trace()
    tr.t_anchor = 0.0
    tr.anchor = SimpleNamespace(elapsed_time=lambda ev: ev)
    spans = [("step", 0.0, 0.1, None), ("check", 0.01, 0.05, 0), ("queryDB", 0.01, 0.02, 1),
             ("performDA", 0.02, 0.05, 1), ("window dispatch", 0.021, 0.031, 3),
             ("read", 0.032, 0.048, 3), ("insertion", 0.05, 0.09, 0),
             ("window dispatch", 0.06, 0.065, 6), ("read", 0.09, 0.095, 0)]
    for i, (name, t0, t1, parent) in enumerate(spans):
        tr.host.append(trace.HostSpan(i, name, t0, t1, parent, 3, nbytes=8))
    tr.replays += [trace.Replay("check", "check one", 0.011, 0.0112, 12.0, 25.0, 2, 3),
                   trace.Replay("window_group", "wg", 0.030, 0.0303, 26.0, 40.0, 4, 3),
                   trace.Replay("window_group", "wg", 0.064, 0.0644, 66.0, 80.0, 7, 3)]
    return tr


def test_readers_on_a_hand_built_record():
    t = dict(tracer=SimpleNamespace(eager=_hand_trace()), kfs=2, frames=4)
    want = dict(zip(READERS, (
        (0.010 + 0.005) * 1e3 / 2,     # window dispatch ms a keyframe
        (0.016 + 0.005) * 1e3 / 4,     # read ms a frame
        48.0 - 25.0,                   # the check's read returned 23 ms after its replay's end
        300.0)))                       # median replay call: 200, 300, 400 us
    for name in READERS:
        assert spec.load_reader(name).read(t) == pytest.approx(want[name]), name


@pytest.mark.parametrize("record", ["parent", "empty"])
def test_readers_give_none_without_their_spans(record):
    """The parent's ``record_spans`` yields a plain list; an empty trace has
    no span to read."""
    eager = [] if record == "parent" else trace.Trace()
    t = dict(tracer=SimpleNamespace(eager=eager), kfs=2, frames=4)
    for name in READERS:
        assert spec.load_reader(name).read(t) is None, name


# ---------------------------------------------------------------------- CLI
def test_cli_trace_writes_chrome_json(tmp_path, capsys):
    txt = open(DEMO).read()
    txt = re.sub(r"(?m)^out_dir.*$", f"out_dir = {tmp_path / 'out'}", txt)
    txt = re.sub(r"(?m)^verbose_level.*$", "verbose_level = 0", txt)
    ini = tmp_path / "cfg.ini"
    ini.write_text(txt)
    path = tmp_path / "trace.json"
    assert main([str(ini), "--cpu", "--synthetic", "4", "--trace", str(path)]) == 0
    assert "trace:" in capsys.readouterr().out
    with open(path) as f:
        doc = json.load(f)
    steps = [e for e in doc["traceEvents"] if e["name"] == "step"]
    assert sorted(e["args"]["frame"] for e in steps) == [0, 1, 2, 3]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in steps)
    assert any(e["name"] == "finalize" for e in doc["traceEvents"])
    assert set(doc["otherData"]) == {"replays_by_kind", "reads", "uploads", "window_tables"}


# ------------------------------------------------------------ window tables
def test_session_builds_every_window_table_on_the_device(sessions):
    """Every window the session solves (one an insertion after the first
    keyframe) goes through a group, which builds its tables on the device."""
    est, tr = sessions["est"], sessions["tr"]
    inserted = sum(r.inserted_kf is not None for r in est.step_log)
    assert tr.window_tables == dict(device=inserted - 1, host=0)


def _tiny_window(C, L, O, seed=0):
    """A window's nine host arrays at (C, L, O): cameras along x, landmarks
    ahead of them, each observation its landmark's projection."""
    rng = np.random.default_rng(seed)
    cam_pose = np.zeros((C, 6), np.float32)
    cam_pose[:, 3] = np.arange(C) * 0.5
    lm_base = rng.integers(0, C, L)
    lm_pos = np.stack([rng.uniform(-3, 3, L), rng.uniform(-1, 1, L), rng.uniform(6, 12, L)],
                      1).astype(np.float32)
    obs_cam, obs_lm = rng.integers(0, C, O), rng.integers(0, L, O)
    obs_px = np.stack([rng.uniform(100, 1100, O), rng.uniform(50, 300, O),
                       rng.uniform(90, 1000, O)], 1).astype(np.float32)
    return (cam_pose, np.ones(C, bool), lm_pos, lm_base, np.ones(L, bool), obs_cam, obs_lm,
            obs_px, np.arange(O) < O - 3)


def test_window_tables_counted_where_built(sessions):
    """A traced group counts its valid slots as built on the device and
    none on the host; a window solved alone (``SRBAEngine._solve_window``,
    ``assembly_plan``) counts one on the host."""
    C, L, O = 4, 16, 64
    win = _tiny_window(C, L, O)
    ints, floats = window_ba.pack_window(*win)
    valids = [False, True, True, False, False, True, False, False]
    kw = dict(max_iters=2, stage1_iters=1)
    with cuda_graphs.record_spans() as tr:
        window_ba.solve_window_group(np.stack([ints] * 8), np.stack([floats] * 8), valids,
                                     C, L, O, StereoCamera.kitti(), "cpu", **kw)
    assert tr.window_tables == dict(device=3, host=0)
    with cuda_graphs.record_spans() as tr:
        sessions["est"].rba._solve_window(dict(window=win, C=C, L=L))
        sessions["est"].rba._solve_window(dict(window=win, C=C, L=L))
    assert tr.window_tables == dict(device=0, host=2)
