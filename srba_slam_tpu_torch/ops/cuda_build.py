"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each ``.cu`` source compiles with its own ``nvcc`` for Hopper (``sm_90a``),
all started together, and the objects link into one shared library with a
plain C interface, loaded with ``ctypes``. The library goes
to ``srba_slam_tpu_torch/_build/`` under a name keyed by a hash of the
sources and flags, so an edited source builds anew and an unchanged one is
built once. ``nvcc``'s report (``-Xptxas -v``: registers, shared memory and
spills per kernel) is kept beside the library as ``<name>.log``.

Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: ctypes.CDLL | None = None


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsrba_kernels-{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path}); "
                           "the CUDA kernels cannot be built")
    return path


def _run(cmd: list[str], what: str) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {what} ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    return " ".join(cmd) + "\n" + proc.stdout + proc.stderr


def build() -> str:
    """Compile the kernels unless the library for these sources exists;
    returns its path. Raises with nvcc's output if the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    cu = [p for p in _sources() if p.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(p)}.o" for p in cu]
    with ThreadPoolExecutor(max_workers=len(cu)) as pool:
        logs = list(pool.map(_run, [[nvcc, *NVCC_FLAGS, "-c", "-o", o, p]
                                    for p, o in zip(cu, objs)], cu))
    logs.append(_run([nvcc, "-shared", "-o", tmp, *objs], "the link"))
    for o in objs:
        os.remove(o)
    with open(out + ".log", "w") as f:
        f.write("".join(logs))
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with every C
    function's argument types declared: pointers and the stream as
    ``c_void_p``, which ctypes would otherwise cut to 32 bits."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.srba_fast_nms.argtypes = [vp, ci, vp, ci, ci, ci, cf, vp, ci, ci, cf, vp]
        lib.srba_fast_nms.restype = ci
        lib.srba_orb_describe.argtypes = [vp, ci, vp, vp, vp, vp, ctypes.POINTER(cf), vp,
                                          ci, ci, ci, ci, vp]
        lib.srba_orb_describe.restype = ci
        lib.srba_fast_score.argtypes = [vp, ci, vp, ci, ci, ci, cf, vp, ci, vp]
        lib.srba_fast_score.restype = ci
        lib.srba_empty_launch.argtypes = [ci, ci, ci, ci, ci, ci, vp]
        lib.srba_empty_launch.restype = ci
        lib.srba_cond_graph_create.argtypes = [vp, vp, ctypes.POINTER(vp)]
        lib.srba_cond_graph_create.restype = ci
        lib.srba_cond_graph_launch.argtypes = [vp, vp]
        lib.srba_cond_graph_launch.restype = ci
        _lib = lib
    return _lib
