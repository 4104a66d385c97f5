"""The port's native image preprocessing (``llava_plus_torch/data/native.py``
over its own copy of ``llava_img.cpp``) against the JAX package's
(``llava_plus_tpu/data/native.py`` over ``native/llava_img.cpp``), on the
CPU.

The JAX package's library is built here with ``g++`` into a temporary
directory (never into ``native/``) with the port's flags, and its module is
pointed at it through ``LLAVA_IMG_LIB``. The two libraries must agree bit
for bit on the shapes of ``tests/test_native.py`` and on a hypothesis draw
of sizes; both must lie within one uint8 level in normalized units (1.01 /
255 / 0.258) of the PIL pipeline of the JAX and the port's
``ClipImageProcessor``."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from llava_plus_torch import mm_utils
from llava_plus_torch.data import native
from llava_plus_torch.data.image_processing import ClipImageProcessor
from llava_plus_tpu import mm_utils as jax_mm_utils
from llava_plus_tpu.data import native as jax_native
from llava_plus_tpu.data.image_processing import ClipImageProcessor as JaxClipImageProcessor

ROOT = Path(__file__).resolve().parent.parent
ONE_LEVEL = 1.01 / 255 / 0.258
SHAPES = [(480, 640), (336, 336), (200, 500), (1024, 768)]

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on PATH")


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("native") / "libllava_img.so"
    subprocess.run(["g++", *native.flags(), "-o", str(out), str(ROOT / "native" /
                                                                  "llava_img.cpp")],
                   check=True, capture_output=True)
    return out


@pytest.fixture
def jax_side(jax_lib, monkeypatch):
    """The JAX module, loading the library built above."""
    monkeypatch.setenv("LLAVA_IMG_LIB", str(jax_lib))
    monkeypatch.setattr(jax_native, "_TRIED", False)
    monkeypatch.setattr(jax_native, "_LIB", None)
    assert jax_native.native_available()
    return jax_native


def _image(rng, shape):
    return rng.integers(0, 255, tuple(shape) + (3,), dtype=np.uint8)


def test_malformed_images_raise_before_the_c_call():
    with pytest.raises(ValueError, match="3 channels"):
        native.clip_preprocess(np.zeros((8, 8), np.uint8))
    with pytest.raises(ValueError, match="4 dims"):
        native.clip_preprocess_batch(np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="3 values"):
        native.expand2square(np.zeros((4, 6, 3), np.uint8), (1, 2))
    with pytest.raises(ValueError, match="non-empty"):
        native.expand2square(np.zeros((0, 6, 3), np.uint8), (1, 2, 3))


def test_library_builds_into_the_port_and_is_reused():
    path = native.library_path()
    assert native.native_available()
    assert path.exists() and path.parent == ROOT / "llava_plus_torch" / "build"
    assert native.build() == path and native.load_library() is native.load_library()
    assert native.openmp() and native.flags() == native.CXX_FLAGS   # g++ here links OpenMP


def test_without_openmp_the_library_builds_apart(monkeypatch):
    """A compiler that cannot link OpenMP builds without -fopenmp, into a
    library of its own name (the flags are in the hash)."""
    with_omp = native.library_path()
    monkeypatch.setattr(native, "_OPENMP", False)
    assert "-fopenmp" not in native.flags() and native.library_path() != with_omp


@pytest.mark.parametrize("shape", SHAPES)
def test_clip_preprocess_equals_jax_native(jax_side, shape):
    a = _image(np.random.default_rng(0), shape)
    np.testing.assert_array_equal(native.clip_preprocess(a), jax_side.clip_preprocess(a))
    np.testing.assert_array_equal(native.clip_preprocess(a, 224, 224),
                                  jax_side.clip_preprocess(a, 224, 224))


def test_batch_equals_jax_native_and_single(jax_side):
    imgs = _image(np.random.default_rng(1), (4, 100, 160))
    batch = native.clip_preprocess_batch(imgs)
    np.testing.assert_array_equal(batch, jax_side.clip_preprocess_batch(imgs))
    for i in range(4):
        np.testing.assert_array_equal(batch[i], native.clip_preprocess(imgs[i]))


def test_expand2square_equals_jax_native_and_pil(jax_side):
    rng = np.random.default_rng(2)
    for shape in [(40, 100), (100, 40), (64, 64), (1, 7)]:
        a = _image(rng, shape)
        got = native.expand2square(a, (10, 20, 30))
        np.testing.assert_array_equal(got, jax_side.expand2square(a, (10, 20, 30)))
        np.testing.assert_array_equal(
            got, np.asarray(mm_utils.expand2square(Image.fromarray(a), (10, 20, 30))))


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(h=st.integers(1, 700), w=st.integers(1, 700), n=st.integers(1, 3),
       edge=st.sampled_from([224, 336]), seed=st.integers(0, 2 ** 16))
def test_drawn_sizes_equal_jax_native(jax_side, h, w, n, edge, seed):
    imgs = _image(np.random.default_rng(seed), (n, h, w))
    np.testing.assert_array_equal(native.clip_preprocess_batch(imgs, edge, edge),
                                  jax_side.clip_preprocess_batch(imgs, edge, edge))
    np.testing.assert_array_equal(native.clip_preprocess(imgs[0], edge, edge),
                                  jax_side.clip_preprocess(imgs[0], edge, edge))
    bg = tuple(int(x) for x in imgs[0, 0, 0])
    np.testing.assert_array_equal(native.expand2square(imgs[0], bg),
                                  jax_side.expand2square(imgs[0], bg))


@pytest.mark.parametrize("shape", SHAPES)
def test_native_within_one_level_of_both_pil_processors(shape):
    a = _image(np.random.default_rng(0), shape)
    pil = Image.fromarray(a)
    port, jax_ref = ClipImageProcessor()(pil), JaxClipImageProcessor()(pil)
    np.testing.assert_array_equal(port, jax_ref)
    got = native.clip_preprocess(a)
    assert np.abs(port - got).max() <= ONE_LEVEL
    assert np.abs(jax_ref - got).max() <= ONE_LEVEL
    # the pad-to-square path of mm_utils.process_images, both packages
    bg = tuple(int(x * 255) for x in ClipImageProcessor().image_mean)
    sq = native.expand2square(a, bg)
    want = ClipImageProcessor()(mm_utils.expand2square(pil, bg))
    np.testing.assert_array_equal(
        want, JaxClipImageProcessor()(jax_mm_utils.expand2square(pil, bg)))
    assert np.abs(want - native.clip_preprocess(sq)).max() <= ONE_LEVEL
