"""srba_slam_tpu_torch — the PyTorch/CUDA port of srba_slam_tpu.

A second package beside the JAX one, for one NVIDIA H100. It keeps the JAX
package's module names, so each counterpart is easy to find, and imports
neither jax nor ``srba_slam_tpu``. Plain tensor code is eager torch on the
card unless the caller asks for the CPU (every entry point's ``device``
defaults to ``"cuda"``); the JAX package's Pallas kernels on the ported
path are kernels written by hand for Hopper (``csrc/``, built at first use
by ``ops/cuda_build.py``), each beside its plain torch version.

Ported so far: the SLAM estimator's per-frame path
(``models/estimator.py`` ``SRBAStereoSLAMEstimator``): the stereo-VO engine
(``models/vo.py`` ``StereoVOEngine``), the keyframe store, bag-of-words
place recognition, the data-association cascade with fundamental-matrix
RANSAC, the SRBA backend with its windowed bundle adjustment, the global
pose graph and the output files, with the host layer they need
(``config``, ``utils/``), behind the command line of the JAX package
(``python -m srba_slam_tpu_torch <config.ini>``, ``__main__.py``) with
checkpoint and resume, the native frame loader, the debug dumps and the
viewers. What is not ported yet: ROADMAP.md, Queue 1.
"""

__version__ = "0.1.0"

from srba_slam_tpu_torch.config import (
    GeneralOptions, SRBAStereoSLAMOptions, VOOptions, load_config,
)
from srba_slam_tpu_torch.models.estimator import SRBAStereoSLAMEstimator
from srba_slam_tpu_torch.models.vo import StereoVOEngine
from srba_slam_tpu_torch.utils.camera import StereoCamera

__all__ = [
    "GeneralOptions",
    "SRBAStereoSLAMEstimator",
    "SRBAStereoSLAMOptions",
    "StereoCamera",
    "StereoVOEngine",
    "VOOptions",
    "load_config",
    "__version__",
]
