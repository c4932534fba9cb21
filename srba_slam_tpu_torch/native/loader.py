"""ctypes bindings for the native prefetching frame loader.

Counterpart of ``srba_slam_tpu/native/loader.py``. ``frameloader.cpp`` (the
port's own copy) is built with ``g++`` against libpng at first use into the
package's ``_build/`` directory, under a name keyed by a hash of the source,
so an edited source builds anew. Where ``g++`` or libpng is missing,
``NativeImageDirSource.available()`` is False and the caller takes the
pure-Python ``ImageDirSource``, which yields the same bytes.

Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "frameloader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_lib = None


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libframeloader-{digest}.so")


def _load():
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-shared", _SRC,
                        "-lpng", "-lz", "-pthread", "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    lib.fl_open.restype = ctypes.c_void_p
    lib.fl_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.fl_next.restype = ctypes.c_int
    lib.fl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_int)]
    lib.fl_copy.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_uint8),
                            ctypes.POINTER(ctypes.c_uint8)]
    lib.fl_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class NativeImageDirSource:
    """Drop-in for utils.framesource.ImageDirSource backed by the C++
    prefetcher: PNG/PGM decode happens on a worker thread, queue_depth frames
    ahead of the SLAM loop."""

    def __init__(self, image_dir: str, left_format: str, right_format: str,
                 start_index: int = 0, end_index: int = 0, queue_depth: int = 4):
        self._args = (image_dir, left_format, right_format,
                      start_index, end_index, queue_depth)

    @staticmethod
    def available() -> bool:
        try:
            _load()
            return True
        except Exception:
            return False

    def __iter__(self):
        lib = _load()
        h = lib.fl_open(
            self._args[0].encode(), self._args[1].encode(),
            self._args[2].encode(), self._args[3], self._args[4], self._args[5],
        )
        try:
            idx = ctypes.c_int()
            w = ctypes.c_int()
            hh = ctypes.c_int()
            while lib.fl_next(h, ctypes.byref(idx), ctypes.byref(w), ctypes.byref(hh)):
                left = np.empty((hh.value, w.value), np.uint8)
                right = np.empty((hh.value, w.value), np.uint8)
                lib.fl_copy(
                    h,
                    left.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    right.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                )
                yield left, right
        finally:
            lib.fl_close(h)
