"""srba_slam_tpu_torch — the PyTorch/CUDA port of srba_slam_tpu.

A second package beside the JAX one, for one NVIDIA H100. It keeps the JAX
package's module names, so each counterpart is easy to find, and imports
neither jax nor ``srba_slam_tpu``. Plain tensor code is eager torch on an
explicit device; the JAX package's Pallas kernels on the ported path are
kernels written by hand for Hopper (``csrc/``, built at first use by
``ops/cuda_build.py``), each beside its plain torch version.

Ported so far: the stereo-VO engine that turns stereo frames into pose
increments (``models/vo.py`` ``StereoVOEngine``), with the host layer it
needs (``config``, ``utils/``). The estimator and the backend come later
(ROADMAP.md, Queue 1).
"""

__version__ = "0.1.0"

from srba_slam_tpu_torch.config import VOOptions, load_config
from srba_slam_tpu_torch.models.vo import StereoVOEngine
from srba_slam_tpu_torch.utils.camera import StereoCamera

__all__ = [
    "StereoCamera",
    "StereoVOEngine",
    "VOOptions",
    "load_config",
    "__version__",
]
