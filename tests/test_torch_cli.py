"""The port's command line against the JAX package's, on the CPU.

Both run ``demo/config_synthetic_small.ini`` (its ``out_dir`` pointed into a
temporary directory) over ``--synthetic 24`` in this process.

Held exactly: exit codes, the seven output files, ``kf_frames.txt`` and the
keyframe count; ``out_kf_poses.txt`` within 1e-3 (six decimals of f32 solves
that sum in another order).
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

from srba_slam_tpu.__main__ import main as jmain
from srba_slam_tpu_torch.__main__ import main, run
from srba_slam_tpu_torch.utils.camera import StereoCamera
from srba_slam_tpu_torch.utils.framesource import SyntheticSource
from torch_parity_inputs import SMALL_CAM

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "demo", "config_synthetic_small.ini")
N = 24
SEVEN = ("out_kf_poses.txt", "kf_frames.txt", "time_new_kf.txt", "profiler.csv",
         "final_graph.dot", "final_global_path.ply", "map_viewer.html")


def _ini(tmp, name, extra_app="", **subs):
    """The demo config with its out_dir under ``tmp`` and other edits."""
    txt = open(DEMO).read()
    out = os.path.join(str(tmp), name)
    txt = re.sub(r"(?m)^out_dir.*$", f"out_dir = {out}\n{extra_app}", txt)
    txt = re.sub(r"(?m)^verbose_level.*$", "verbose_level = 0", txt)
    for key, val in subs.items():
        txt = re.sub(rf"(?m)^{key}\s*=.*$", f"{key} = {val}", txt)
    path = os.path.join(str(tmp), name + ".ini")
    with open(path, "w") as f:
        f.write(txt)
    return path, out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    tini, tout = _ini(tmp, "port")
    jini, jout = _ini(tmp, "jax")
    gt = os.path.join(str(tmp), "gt.txt")
    np.savetxt(gt, SyntheticSource(StereoCamera(**SMALL_CAM), n_frames=N, step=0.5)
               .gt_poses[:, 3:])
    ckpt = os.path.join(str(tmp), "state.npz")
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([tini, "--cpu", "--synthetic", str(N), "--gt", gt, "--checkpoint", ckpt])
    jrc = jmain([jini, "--cpu", "--synthetic", str(N), "--batch", "1"])
    return dict(rc=rc, jrc=jrc, out=tout, jout=jout, stdout=buf.getvalue(), ckpt=ckpt, tmp=tmp)


def test_cli_exits_0_and_writes_the_seven_files(runs):
    assert runs["rc"] == 0 and runs["jrc"] == 0
    for name in SEVEN:
        assert os.path.getsize(os.path.join(runs["out"], name)) > 0, name
    assert sorted(os.listdir(runs["out"])) == sorted(os.listdir(runs["jout"])) == sorted(SEVEN)
    assert "[srba_slam_tpu_torch] backend: cpu" in runs["stdout"]
    assert f"{N} frames" in runs["stdout"]


def test_cli_keyframes_equal_jax_cli(runs):
    kf_t = open(os.path.join(runs["out"], "kf_frames.txt")).read()
    kf_j = open(os.path.join(runs["jout"], "kf_frames.txt")).read()
    assert kf_t == kf_j and len(kf_t.splitlines()) >= 4
    pt = np.loadtxt(os.path.join(runs["out"], "out_kf_poses.txt"))
    pj = np.loadtxt(os.path.join(runs["jout"], "out_kf_poses.txt"))
    assert pt.shape == pj.shape == (len(kf_t.splitlines()), 7)
    np.testing.assert_allclose(pt, pj, atol=1e-3)
    ply_t = open(os.path.join(runs["out"], "final_global_path.ply")).read().splitlines()
    ply_j = open(os.path.join(runs["jout"], "final_global_path.ply")).read().splitlines()
    assert ply_t[:10] == ply_j[:10]                      # header: the same vertex count
    html = open(os.path.join(runs["out"], "map_viewer.html")).read()
    assert html.startswith("<!DOCTYPE html>") or "<html" in html[:200]


def test_cli_gt_reports_ate(runs):
    m = re.search(r"ATE RMSE vs .*gt.txt: ([0-9.]+) m \((\d+) keyframes", runs["stdout"])
    assert m, runs["stdout"]
    assert float(m.group(1)) < 0.5 and int(m.group(2)) >= 4


def test_cli_checkpoint_then_resume(runs, capsys):
    assert os.path.getsize(runs["ckpt"]) > 0
    ini, out = _ini(runs["tmp"], "resumed")
    assert main([ini, "--cpu", "--synthetic", "3", "--resume", runs["ckpt"]]) == 0
    said = capsys.readouterr().out
    n_kfs = len(open(os.path.join(runs["out"], "kf_frames.txt")).read().splitlines())
    assert f"resumed from {runs['ckpt']} ({n_kfs} KFs)" in said
    assert len(np.atleast_2d(np.loadtxt(os.path.join(out, "out_kf_poses.txt")))) >= n_kfs


def test_cli_config_driven_state_file(tmp_path, capsys):
    state = str(tmp_path / "cfg_state.npz")
    ini, _ = _ini(tmp_path, "saver", extra_app=f"save_state_to_file = true\n"
                  f"state_file = {state}\nsave_at_iteration = 4\n")
    assert main([ini, "--cpu", "--synthetic", "12"]) == 0
    said = capsys.readouterr().out
    assert "will stop and save state at iteration 4" in said and "4 frames" in said
    assert f"state saved to {state}" in said and os.path.getsize(state) > 0
    ini, _ = _ini(tmp_path, "loader", extra_app=f"load_state_from_file = true\n"
                  f"state_file = {state}\n")
    assert main([ini, "--cpu", "--synthetic", "2"]) == 0
    assert f"resumed from {state}" in capsys.readouterr().out


@pytest.mark.parametrize("case", ["rawlog", "fleet", "batch8"])
def test_cli_exit_2(tmp_path, capsys, case):
    if case == "rawlog":
        ini, _ = _ini(tmp_path, "rawlog", grabber_type="rawlog")
        args, needle = [ini, "--cpu"], "grabber_type=rawlog is not supported"
    elif case == "fleet":
        args, needle = [DEMO, "--cpu", "--synthetic", "4", "--fleet", "2"], "M13"
    else:
        args, needle = [DEMO, "--cpu", "--synthetic", "4", "--batch", "8"], "M12"
    assert main(args) == 2
    assert needle in capsys.readouterr().err


def test_cli_batch_0_and_1_step_per_frame(tmp_path, capsys):
    for b in ("0", "1"):
        ini, out = _ini(tmp_path, "b" + b)
        assert main([ini, "--cpu", "--synthetic", "3", "--batch", b]) == 0
        assert "3 frames" in capsys.readouterr().out


def test_run_maps_failures_to_exit_codes(tmp_path, capsys, monkeypatch):
    assert run([str(tmp_path / "missing.ini"), "--cpu"]) == 1
    assert "error:" in capsys.readouterr().err
    import srba_slam_tpu_torch.__main__ as cli

    def interrupted(argv=None):
        raise KeyboardInterrupt

    monkeypatch.setattr(cli, "main", interrupted)
    assert run([DEMO]) == 130

    def broken(argv=None):
        raise ValueError("boom")

    monkeypatch.setattr(cli, "main", broken)
    assert run([DEMO]) == 1
    assert "fatal: ValueError: boom" in capsys.readouterr().err


def test_cli_without_a_card_raises_by_default():
    """No ``--cpu``: the run is on the card, and without one it fails
    instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert run([DEMO, "--synthetic", "2"]) == 1


def test_cli_serve_and_image_dir(tmp_path, capsys):
    """--serve starts the live viewer and implies show3D snapshots; without
    --synthetic the frames come from the image directory through whichever
    loader is available."""
    PIL = pytest.importorskip("PIL.Image")
    cam = StereoCamera(**SMALL_CAM)
    img_dir = tmp_path / "seq"
    img_dir.mkdir()
    for i, (left, right) in enumerate(SyntheticSource(cam, n_frames=4, step=0.5)):
        PIL.fromarray(left).save(img_dir / f"l_{i:06d}.png")
        PIL.fromarray(right).save(img_dir / f"r_{i:06d}.png")
    ini, out = _ini(tmp_path, "imgdir", image_dir_url=str(img_dir))
    assert main([ini, "--cpu", "--serve"]) == 0
    said = capsys.readouterr().out
    assert re.search(r"frame loader: (Native)?ImageDirSource", said) and "4 frames" in said
    assert re.search(r"live map viewer: http://localhost:\d+/", said)
    for name in ("live_viewer.html", "live_map.json", "final_global_path.png"):
        assert os.path.exists(os.path.join(out, name)), name
