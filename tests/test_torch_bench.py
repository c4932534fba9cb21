"""The port's bench harness (``srba_slam_tpu_torch/bench.py``) against the JAX ``bench.py``.

* ``_latency_stats`` gives the JAX ``bench.py``'s numbers on the same
  synthetic latency log and consumption stamps (``bench.py`` is imported
  from the repository's root: its top level imports no jax). The frame ->
  pose milliseconds equal after ``bench.py``'s rounding to 0.1 (the port
  reports them unrounded); the lags and counts exactly.
* The gate passes on each JAX run's own decisions and poses
  (``data/jax_bench_pipeline.json``), and fails on one flipped decision,
  on a keyframe moved 2e-3 m and on an ATE over the gate.
* ``run()`` (its timed parts stubbed) returns a line with every key of the
  JAX ``bench.py``'s line (read from its source), and ``latency`` with
  every key of its ``latency``; ``main()`` prints no line when a gate
  fails; without a card ``python -m srba_slam_tpu_torch.bench`` fails and
  prints no line.
* The CPU anchor's cache is used only for the sources that measured it.
* A batch's dispatch is stamped before the host issues its scan's
  launches (the latency log's arrival in the device-resident loops).
* Slow: ``run(device="cpu")`` at a cut protocol (one repeat each, the
  timed part cut to one batch of 20 frames), gated on the JAX package's
  runs of the cut schedules, whose decisions are the matching prefix of
  the committed JAX runs; the CPU anchor measured in its subprocess.
"""

import ast
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from srba_slam_tpu_torch import bench
from srba_slam_tpu_torch.utils import bench_workload as bw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import bench as jax_bench  # noqa: E402  (the JAX package's bench.py; imports no jax at top)

torch.set_num_threads(1)

JAX_RUNS = bw.load_fingerprint(bw.PIPELINE_FINGERPRINT)["runs"]


def _lat_log(seed: int):
    """A latency log of the estimator's layout: batches of 20 from frame 1
    and checks resolved one to three batches later."""
    rng = np.random.default_rng(seed)
    t, batches, checks = 100.0, [], []
    for j0 in range(1, 81, 20):
        t += rng.uniform(0.05, 0.2)
        batches.append(dict(j0=j0, b=min(20, 81 - j0), t_dispatch=t,
                            t_pull=t + rng.uniform(0.01, 0.9)))
    for f in sorted(rng.choice(np.arange(1, 81), 20, replace=False)):
        checks.append(dict(frame=int(f), resolved_at=int(f + rng.integers(0, 45)), t=0.0))
    stamps = {f: 100.0 + f * 0.02 + rng.uniform(0, 0.01) for f in range(1, 81)}
    return types.SimpleNamespace(lat=dict(batches=batches, checks=checks)), stamps


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("first_frame", [0, 21])
@pytest.mark.parametrize("stamped", [True, False])
def test_latency_stats_equal_the_jax_bench(seed, first_frame, stamped):
    est, stamps = _lat_log(seed)
    t_consumed = stamps if stamped else None
    ref = jax_bench._latency_stats(est, first_frame, t_consumed)
    got = bench._latency_stats(est, first_frame, t_consumed)
    assert set(got) == set(ref)
    for key in ("frame_pose_p50_ms", "frame_pose_p95_ms"):
        assert round(got[key], 1) == ref[key]
    for key in ("kf_decision_lag_frames_p50", "kf_decision_lag_frames_p95", "n_checks"):
        assert got[key] == ref[key]


def _gate_inputs(name):
    run = JAX_RUNS[name]
    return [list(r) for r in run["decisions"]], np.array(run["kf_global"]), run["ate_m"], run


@pytest.mark.parametrize("name", list(bw.SCHEDULES))
def test_gate_passes_on_the_jax_run(name):
    out = bench.gate(name, *_gate_inputs(name))
    assert out == dict(d_jax_m=0.0, ate_m=JAX_RUNS[name]["ate_m"])


@pytest.mark.parametrize("name", list(bw.SCHEDULES))
@pytest.mark.parametrize("fault", ["decision", "pose", "ate"])
def test_gate_fails(name, fault):
    dec, kf, ate, run = _gate_inputs(name)
    if fault == "decision":
        checked = next(i for i, r in enumerate(dec) if r[1])
        dec[checked][1] = not dec[checked][1]         # one kf_check flipped
    elif fault == "pose":
        kf[len(kf) // 2, 3] += 2e-3                   # one keyframe moved 2e-3 m
    else:
        ate = bench.ATE_GATE_M + 1e-9
    with pytest.raises(bench.GateError, match={"decision": "decisions", "pose": "positions",
                                               "ate": "ATE"}[fault]):
        bench.gate(name, dec, kf, ate, run)


def _jax_line_keys():
    """The keys of the JSON line the JAX ``bench.py``'s ``main`` prints,
    and of its ``latency`` dict (an f-string key evaluated at DEV_BATCH)."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    line = next(n for n in ast.walk(main) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "dumps").args[0]

    def key(k):
        if isinstance(k, ast.Constant):
            return k.value
        return "".join(v.value if isinstance(v, ast.Constant) else str(jax_bench.DEV_BATCH)
                       for v in k.values)

    top = [key(k) for k in line.keys]
    lat = line.values[top.index("latency")]
    return set(top), {key(k) for k in lat.keys}


def _stub_rows(monkeypatch):
    """run()'s timed parts replaced by rows of their layout."""
    lat = dict(frame_pose_p50_ms=1.0, frame_pose_p95_ms=2.0, kf_decision_lag_frames_p50=3,
               kf_decision_lag_frames_p95=4, n_checks=5)
    launches = {fn.__name__: 3 for fn in bench.KERNELS}

    def row(s, **kw):
        return dict(s=s, launches=launches, captures=dict(vo_scan=1, check=2), latency=lat,
                    gate=dict(d_jax_m=1e-5, ate_m=0.25), **kw)

    monkeypatch.setattr(bench, "_headline", lambda *a: [
        row(s, sections={"queryDB": dict(count=1, mean_ms=1.0, total_ms=1.0)})
        for s in (3.0, 2.0, 4.0)])
    monkeypatch.setattr(bench, "_busy_share", lambda *a: 0.05)
    monkeypatch.setattr(bench, "_device_resident", lambda *a, **k: [
        row(s, fps=60 / s, mbps=100.0) for s in (2.5, 2.0)])
    monkeypatch.setattr(bench, "_get_cpu_anchor", lambda: 0.5)


def test_line_holds_every_key_of_the_jax_bench_line(monkeypatch):
    _stub_rows(monkeypatch)
    frames = [(np.zeros((4, 6), np.uint8), np.zeros((4, 6), np.uint8))] * 81
    line = bench.run("cpu", frames=(frames, np.zeros((81, 6))))
    top, lat = _jax_line_keys()
    assert "vs_baseline_provenance" in top and "device_resident_batch60" in lat
    assert top <= set(line) and lat == set(line["latency"])
    assert set(line) - top == {"card", "toolchain", "gates", "launches", "scan_graphs",
                               "check_graphs", "sections", "busy_share", "cpu_fps_provenance"}
    json.dumps(line)                                  # one JSON line
    assert line["metric"] == "kitti_synth_e2e_fps_per_chip[cpu]"
    assert line["value"] == 60 / 3.0 and line["best"] == 60 / 2.0   # median, best repeat
    assert line["device_resident_fps"] == 60 / 2.0
    assert line["latency"]["bounded_lag"]["batch"] == 8
    assert line["launches"] == {fn.__name__: 3 * 7 for fn in bench.KERNELS}
    assert line["scan_graphs"] == dict(captures=0, captures_timed=7, capture_s=0.0)
    assert line["check_graphs"] == dict(captures=0, captures_timed=14, capture_s=0.0)
    assert line["vs_cpu_anchor"] == line["value"] / 0.5 and line["card"] is None
    assert set(line["gates"]) == {bench.HEADLINE, bench.DEVICE_RESIDENT, bench.BOUNDED}


def test_main_prints_no_line_when_a_gate_fails(monkeypatch, capsys):
    def failing(*a, **k):
        raise bench.GateError("pipelined b20: keyframe decisions differ")

    monkeypatch.setattr(bench, "run", failing)
    assert bench.main(["--device", "cpu"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "gate failed" in out.err


def test_bench_without_a_card_fails_and_prints_no_line():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "-m", "srba_slam_tpu_torch.bench"],
                          capture_output=True, text=True, cwd=REPO, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode != 0 and proc.stdout == ""


def test_cpu_anchor_cache_is_keyed_on_the_sources(monkeypatch, tmp_path):
    cache = tmp_path / "anchor.json"
    monkeypatch.setattr(bench, "CPU_ANCHOR_CACHE", str(cache))
    measured = []

    def measure(cmd, **kw):
        measured.append(cmd)
        return types.SimpleNamespace(stdout=json.dumps({"cpu_fps": 0.5 + len(measured)}) + "\n")

    monkeypatch.setattr(bench.subprocess, "run", measure)
    assert bench._get_cpu_anchor() == 1.5 and len(measured) == 1
    assert bench._get_cpu_anchor() == 1.5 and len(measured) == 1      # cached
    stored = json.load(open(cache))
    assert stored["sources"] == bench._sources_hash()
    json.dump(dict(stored, sources="0" * 16), open(cache, "w"))      # other sources
    assert bench._get_cpu_anchor() == 2.5 and len(measured) == 2
    json.dump({"cpu_fps": 9.0}, open(cache, "w"))                    # a cache with no key
    assert bench._get_cpu_anchor() == 3.5 and len(measured) == 3


def test_dispatch_is_stamped_before_the_scan_launches(monkeypatch):
    from srba_slam_tpu_torch.models import estimator as est_mod

    import test_torch_pipeline as tp

    scan_ends, stamps = [], []
    run_scan = est_mod.vo_scan

    def scan(*a, **k):
        out = run_scan(*a, **k)
        scan_ends.append(time.perf_counter())
        return out

    monkeypatch.setattr(est_mod, "vo_scan", scan)
    est = tp._make(True)
    run_dispatch = est._dispatch_scan

    def dispatch(*a, **k):
        n = len(scan_ends)
        disp = run_dispatch(*a, **k)
        assert len(scan_ends) == n + 1
        stamps.append((disp["t_dispatch"], scan_ends[-1]))
        return disp

    est._dispatch_scan = dispatch
    est.perform_stereo_slam_batched(tp._frames()[:13], batch=4)
    assert len(stamps) == 3 and len(est.lat["batches"]) == 3
    assert all(t < end for t, end in stamps)
    assert [b["t_dispatch"] for b in est.lat["batches"]] == [t for t, _ in stamps]


def _jax_cut_runs(names, n_frames):
    """The JAX package's runs of ``names`` over the first ``n_frames``
    frames of the bench workload (tests/test_torch_bench_fingerprint.py's
    schedules, cut)."""
    import test_torch_bench_fingerprint as tbf

    frames, sha, gt = tbf._frames()
    runs = {}
    for name in names:
        est = tbf._jax_estimator()
        tbf._run_schedule(est, name, frames[:n_frames], tbf._jax_device_loop)
        runs[name] = tbf._fingerprint(est, sha, gt)
    return runs, frames, gt


@pytest.mark.slow
def test_run_on_the_cpu_at_a_cut_protocol(monkeypatch, tmp_path):
    timed = bw.SCHEDULES[bench.HEADLINE][0]
    n = bw.WARMUP_FRAMES + timed
    names = (bench.HEADLINE, bench.DEVICE_RESIDENT, bench.BOUNDED)
    jax_runs, frames, gt = _jax_cut_runs(names, n)
    for name in names:
        assert jax_runs[name]["decisions"] == JAX_RUNS[name]["decisions"][:n]
    monkeypatch.setattr(bench, "CPU_ANCHOR_CACHE", str(tmp_path / "anchor.json"))
    line = bench.run("cpu", 1, 1, 2, frames=(frames[:n], gt[:n]), jax_runs=jax_runs)
    top, lat = _jax_line_keys()
    assert top <= set(line) and lat == set(line["latency"])
    assert line["cpu_fps"] > 0 and json.load(open(tmp_path / "anchor.json"))["cpu_fps"] > 0
    assert {k: g["repeats"] for k, g in line["gates"].items()} == {k: 1 for k in names}
    assert all(g["max_d_jax_m"] < bench.PIPE_JAX_GATE_M for g in line["gates"].values())
    assert line["launches"] == {fn.__name__: 0 for fn in bench.KERNELS}   # no card here
    assert line["busy_share"] is None and line["value"] > 0
