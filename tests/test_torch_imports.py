"""The PyTorch port imports neither jax nor the JAX package.

Run in a fresh interpreter: this test process has jax loaded already
(tests/conftest.py). Every module of the port is imported. Exact checks:
module names and file bytes.
"""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import srba_slam_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'srba_slam_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'srba_slam_tpu_torch.models.estimator' in names, names\n"
        "assert 'srba_slam_tpu_torch.ops.prng' in names, names\n"
        "for new in ('__main__', 'ops.rectify', 'utils.checkpoint', 'utils.compare',\n"
        "            'utils.debug_dumps', 'utils.viz', 'utils.html_viewer', 'utils.live_server',\n"
        "            'native.loader', 'parallel.batch', 'parallel.sweep', 'parallel.fleet',\n"
        "            'parallel.multichip', 'bench'):\n"
        "    assert 'srba_slam_tpu_torch.' + new in names, (new, names)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'srba_slam_tpu' or m.startswith('srba_slam_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_run_imports_no_jax(tmp_path):
    """After ``main([...])`` has run a few frames on the CPU, neither jax
    nor the JAX package is loaded."""
    ini = open(os.path.join(REPO, "demo", "config_synthetic_small.ini")).read()
    ini = ini.replace("out_dir = /tmp/srba_out", f"out_dir = {tmp_path / 'out'}")
    cfg = tmp_path / "cfg.ini"
    cfg.write_text(ini)
    code = (
        "import sys\n"
        "import torch; torch.set_num_threads(1)\n"
        "from srba_slam_tpu_torch.__main__ import main\n"
        f"rc = main([{str(cfg)!r}, '--cpu', '--synthetic', '3', '--checkpoint', "
        f"{str(tmp_path / 's.npz')!r}])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'srba_slam_tpu' or m.startswith('srba_slam_tpu.')]\n"
        "print(rc, bad)\n"
        "sys.exit(1 if bad or rc else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (tmp_path / "out" / "map_viewer.html").exists() and (tmp_path / "s.npz").exists()


def test_frameloader_copies_differ_only_in_the_header():
    a = open(os.path.join(REPO, "srba_slam_tpu", "native", "frameloader.cpp")).read()
    b = open(os.path.join(REPO, "srba_slam_tpu_torch", "native", "frameloader.cpp")).read()
    assert a[a.index("#include"):] == b[b.index("#include"):]


def test_orb_pattern_copies_equal():
    a = np.load(os.path.join(REPO, "srba_slam_tpu", "ops", "orb_pattern_opencv.npy"))
    b = np.load(os.path.join(REPO, "srba_slam_tpu_torch", "ops", "orb_pattern_opencv.npy"))
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
