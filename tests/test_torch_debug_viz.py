"""Debug dumps, viewers and the live server of the port (CPU).

The small-geometry sequence runs with ``debug`` and ``show3D`` set, in both
packages. Held exactly: the set of file names under ``debug/``; the lines of
the keypoint, match, data-association, raw-match and match-after files
(integers, and pixel coordinates and Hamming distances printed with two
decimals). ``posechange_outliers*`` lists filter-4 residuals, f32 solves
summed in another order: the same rows, residuals within 0.05 px.
"""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from srba_slam_tpu.config import GeneralOptions as JGeneral
from srba_slam_tpu_torch.config import GeneralOptions
from srba_slam_tpu_torch.utils import debug_dumps, html_viewer, live_server, viz
from test_torch_estimator import SMALL, _run
from torch_parity_inputs import small_frames

torch.set_num_threads(1)

N_FRAMES = 20


def _debug_run(port, out_dir, monkeypatch):
    """_run with general.debug/show3D set (the options class is the only
    thing swapped)."""
    import test_torch_estimator as tte

    cls = GeneralOptions if port else JGeneral
    name = "GeneralOptions" if port else "JGeneral"
    monkeypatch.setattr(tte, name, lambda: cls(debug=True, show3D=True, out_dir=out_dir))
    frames, _gt = small_frames()
    est, _ = _run(SMALL, frames[:N_FRAMES], port)
    est.finalize(out_dir=out_dir)
    return est


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    d = tmp_path_factory.mktemp("dbg")
    j = _debug_run(False, str(d / "jax"), mp)
    t = _debug_run(True, str(d / "port"), mp)
    mp.undo()
    return j, t, str(d / "jax"), str(d / "port")


def test_debug_file_family_has_the_jax_names(dirs):
    j, t, jd, td = dirs
    names = sorted(os.listdir(os.path.join(td, "debug")))
    assert names == sorted(os.listdir(os.path.join(jd, "debug")))
    for kind in ("kf_0000_keypoints", "kf_0001_matches", "da_info_", "if_raw_match_kf",
                 "if_match_after_kf", "da_dist_kf", "posechange_outliers_kf"):
        assert any(n.startswith(kind) for n in names), (kind, names)
    assert t.store.n_kfs == j.store.n_kfs >= 3


def test_debug_file_contents_equal_jax(dirs):
    _j, _t, jd, td = dirs
    n_lines = 0
    for name in sorted(os.listdir(os.path.join(td, "debug"))):
        a = open(os.path.join(td, "debug", name)).read().splitlines()
        b = open(os.path.join(jd, "debug", name)).read().splitlines()
        if name.startswith("posechange_outliers"):
            assert [ln.split()[0] for ln in a] == [ln.split()[0] for ln in b], name
            if a:
                np.testing.assert_allclose([float(ln.split()[1]) for ln in a],
                                           [float(ln.split()[1]) for ln in b], atol=0.05)
        else:
            assert a == b, name
        n_lines += len(a)
    assert n_lines > 1000


def test_show3d_outputs_written(dirs):
    _j, t, _jd, td = dirs
    for name in ("live_map.png", "live_map.json", "final_global_path.png",
                 "final_global_path.ply", "map_viewer.html"):
        assert os.path.getsize(os.path.join(td, name)) > 0, name
    live = json.load(open(os.path.join(td, "live_map.json")))
    assert len(live["traj"]) == t.store.n_kfs and len(live["edges"]) >= 2
    assert live["kf_frames"] == [r.frame_idx for r in t.step_log if r.inserted_kf is not None]
    with open(os.path.join(td, "live_map.png"), "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_ply_and_html_equal_jax_format(dirs, tmp_path):
    from srba_slam_tpu.utils import debug_dumps as jdumps
    from srba_slam_tpu.utils import html_viewer as jhtml

    _j, t, _jd, _td = dirs
    poses = t.final_poses
    lms = np.random.default_rng(0).normal(size=(20, 3))
    debug_dumps.export_scene_ply(str(tmp_path / "a.ply"), poses, lms)
    jdumps.export_scene_ply(str(tmp_path / "b.ply"), poses, lms)
    assert (tmp_path / "a.ply").read_text() == (tmp_path / "b.ply").read_text()
    edges = [(0, 1, "submap"), (1, 2, "lc")]
    a = html_viewer.build_map_data(poses, landmarks=lms, edges=edges, kf_frames=[0, 4, 9],
                                   title="x")
    b = jhtml.build_map_data(poses, landmarks=lms, edges=edges, kf_frames=[0, 4, 9], title="x")
    assert a == b
    assert html_viewer.write_map_viewer(str(tmp_path / "m.html"), poses, landmarks=lms,
                                        edges=edges)
    assert "srba_slam_tpu_torch" in (tmp_path / "m.html").read_text()


def test_render_map_png(tmp_path, dirs):
    pytest.importorskip("matplotlib")
    _j, t, _jd, _td = dirs
    path = str(tmp_path / "map.png")
    assert viz.render_map_png(path, t.final_poses, query_scores=np.linspace(0, 1, t.store.n_kfs),
                              query_score_th=0.2)
    assert os.path.getsize(path) > 1000


def test_live_server_serves_the_page(tmp_path):
    srv, port = live_server.start_live_server(str(tmp_path), 0)
    try:
        with open(tmp_path / "live_map.json", "w") as f:
            json.dump({"poses": []}, f)
        page = urllib.request.urlopen(f"http://localhost:{port}/", timeout=10)
        assert page.status == 200 and page.headers["Cache-Control"] == "no-store"
        assert b"live_map.json" in page.read()
        data = urllib.request.urlopen(f"http://localhost:{port}/live_map.json", timeout=10)
        assert json.load(data) == {"poses": []}
    finally:
        srv.shutdown()
        srv.server_close()
