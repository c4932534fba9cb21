"""The PyTorch port imports neither jax nor the JAX package.

Run in a fresh interpreter: this test process has jax loaded already
(tests/conftest.py). Exact checks: module names and file bytes.
"""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import srba_slam_tpu_torch, srba_slam_tpu_torch.models.vo\n"
        "import srba_slam_tpu_torch.ops.hopper_fast, srba_slam_tpu_torch.utils.framesource\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'srba_slam_tpu' or m.startswith('srba_slam_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_orb_pattern_copies_equal():
    a = np.load(os.path.join(REPO, "srba_slam_tpu", "ops", "orb_pattern_opencv.npy"))
    b = np.load(os.path.join(REPO, "srba_slam_tpu_torch", "ops", "orb_pattern_opencv.npy"))
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
