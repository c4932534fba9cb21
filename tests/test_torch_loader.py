"""The port's native frame loader: equal bytes to its Python loader and to
the JAX package's native loader, on PNGs this test writes. Exact."""

import os

import numpy as np
import pytest

from srba_slam_tpu.native.loader import NativeImageDirSource as JNative
from srba_slam_tpu_torch.native import loader
from srba_slam_tpu_torch.native.loader import NativeImageDirSource
from srba_slam_tpu_torch.utils.framesource import ImageDirSource

PIL = pytest.importorskip("PIL.Image")

needs_toolchain = pytest.mark.skipif(
    not NativeImageDirSource.available(), reason="needs g++ and libpng to build the loader")


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("seq")
    rng = np.random.default_rng(0)
    for i in range(5):
        for side in ("l", "r"):
            img = rng.integers(0, 255, (48, 64), dtype=np.uint8)
            img[0, 0] = i       # the frame index, so that ordering shows
            PIL.fromarray(img).save(d / f"{side}_{i:06d}.png")
    return str(d)


@needs_toolchain
def test_native_loader_equals_python_loader(image_dir):
    native = list(NativeImageDirSource(image_dir, "l_%06d.png", "r_%06d.png"))
    python = list(ImageDirSource(image_dir, "l_%06d.png", "r_%06d.png"))
    assert len(native) == len(python) == 5
    for (nl, nr), (pl, pr) in zip(native, python):
        assert nl.dtype == np.uint8 and nl.shape == (48, 64)
        np.testing.assert_array_equal(nl, pl)
        np.testing.assert_array_equal(nr, pr)


@needs_toolchain
def test_native_loader_equals_jax_native_loader(image_dir):
    if not JNative.available():
        pytest.skip("the JAX package's loader does not build here")
    for (a, b), (c, d) in zip(NativeImageDirSource(image_dir, "l_%06d.png", "r_%06d.png"),
                              JNative(image_dir, "l_%06d.png", "r_%06d.png")):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


@needs_toolchain
def test_native_loader_range_and_order(image_dir):
    frames = list(NativeImageDirSource(image_dir, "l_%06d.png", "r_%06d.png",
                                       start_index=1, end_index=3))
    assert [int(f[0][0, 0]) for f in frames] == [1, 2, 3]
    python = list(ImageDirSource(image_dir, "l_%06d.png", "r_%06d.png", 1, 3))
    assert [int(f[0][0, 0]) for f in python] == [1, 2, 3]


@needs_toolchain
def test_native_loader_missing_directory(tmp_path):
    missing = str(tmp_path / "nowhere")
    assert list(NativeImageDirSource(missing, "l_%06d.png", "r_%06d.png")) == []
    assert list(ImageDirSource(missing, "l_%06d.png", "r_%06d.png")) == []


@needs_toolchain
def test_library_is_built_under_the_build_directory():
    path = loader.library_path()
    assert os.path.exists(path)
    assert os.path.basename(os.path.dirname(path)) == "_build"
    assert not os.path.exists(os.path.join(os.path.dirname(loader.__file__),
                                           "libframeloader.so"))
