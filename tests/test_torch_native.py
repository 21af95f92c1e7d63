"""icl_tpu_torch.native, the port's C++ order-0 zoom and rotate, against
scipy.ndimage and against the JAX package's helper (`icl_tpu.native`,
whose half of each case skips where its library does not load): 0
differing pixels, f32 and u8; zooms up, down, to odd sizes and to one
pixel, and at sizes where the last source coordinate rounds past the
input (scipy writes 0 there, the JAX helper copies the last input row or
column: the one place where the two helpers differ, asserted); rotations of four sizes (one an odd square, one an ACDC slice) at
every integer angle the augmentation draws, [-20, 20). Also: the JAX
module's dtypes for other inputs, the transforms' routing beside the JAX
package's, a cached build reused without compiling, a broken source that
raises instead of falling back, scipy with no compiler (logged once), and
the first call from many threads at once (one build, every call counted).
"""
import logging
import shutil
import sys
import threading

import numpy as np
import pytest
from scipy import ndimage

from icl_tpu import native as jax_native
from icl_tpu.data import transforms as jax_transforms

from icl_tpu_torch import native
from icl_tpu_torch.data import transforms
from icl_tpu_torch.ops import build
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

ANGLES = range(-20, 20)
ROTATE_SIZES = [(24, 20), (31, 31), (57, 33), (256, 216)]
ZOOMS = [((20, 24), (40, 48)), ((256, 216), (64, 64)), ((30, 17), (21, 13)),
         ((21, 19), (16, 16)), ((9, 7), (1, 1)), ((9, 7), (1, 5)), ((1, 6), (4, 11)),
         ((232, 256), (224, 224)), ((201, 199), (384, 384)), ((428, 512), (224, 224))]


def _image(shape, dtype, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.normal(size=shape).astype(dtype)


def past_the_input(n_in: int, n_out: int) -> list:
    """The output indices of an order-0 zoom whose source coordinate
    k * ((n_in - 1) / (n_out - 1)) rounds past n_in - 1 in f64."""
    return [] if n_out == 1 else [k for k in range(n_out) if k * ((n_in - 1) / (n_out - 1)) > n_in - 1]


def _oracle(which: str):
    """(zoom, rotate) of scipy or of the JAX package's helper."""
    if which == "scipy":
        return (lambda img, size: ndimage.zoom(img, (size[0] / img.shape[0], size[1] / img.shape[1]),
                                               order=0),
                lambda img, angle: ndimage.rotate(img, angle, order=0, reshape=False))
    if not jax_native.available():
        pytest.skip("the JAX package's native library does not load here")
    return jax_native.zoom_nearest, jax_native.rotate_nearest


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The library built anew under tmp_path at the next call (the loaded
    one forgotten before and after); yields the compiler calls made."""
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    compiles = []
    run = build.subprocess.run

    def counting_run(cmd, *a, **kw):
        compiles.append(cmd)
        return run(cmd, *a, **kw)

    monkeypatch.setattr(build.subprocess, "run", counting_run)
    native._load.cache_clear()
    yield compiles
    native._load.cache_clear()


@pytest.mark.parametrize("oracle", ["scipy", "jax_native"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8], ids=["f32", "u8"])
@pytest.mark.parametrize("shape,out", ZOOMS, ids=[f"{a}x{b}-{c}x{d}" for (a, b), (c, d) in ZOOMS])
def test_zoom_matches(shape, out, dtype, oracle):
    """Against the JAX helper: equal but in the rows and columns past the
    input, where it copies the input's last one and the port writes 0, as
    scipy does."""
    zoom, _ = _oracle(oracle)
    img = _image(shape, dtype) | 1 if dtype == np.uint8 else _image(shape, dtype) + 5
    got = native.zoom_nearest(img, out)
    assert got.shape == out and got.dtype == dtype
    want = zoom(img, out)
    rows, cols = past_the_input(shape[0], out[0]), past_the_input(shape[1], out[1])
    if oracle == "jax_native":
        assert (want[rows] != 0).all() and (want[:, cols] != 0).all()
        want[rows], want[:, cols] = 0, 0
    np.testing.assert_array_equal(got, want)
    assert (got[rows] == 0).all() and (got[:, cols] == 0).all()


@pytest.mark.parametrize("oracle", ["scipy", "jax_native"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8], ids=["f32", "u8"])
@pytest.mark.parametrize("angle", ANGLES)
@pytest.mark.parametrize("shape", ROTATE_SIZES, ids=[f"{h}x{w}" for h, w in ROTATE_SIZES])
def test_rotate_matches(shape, angle, dtype, oracle):
    _, rotate = _oracle(oracle)
    img = _image(shape, dtype, seed=angle + 20)
    got = native.rotate_nearest(img, angle)
    assert got.shape == shape and got.dtype == dtype
    np.testing.assert_array_equal(got, rotate(img, angle))


@pytest.mark.parametrize("op", ["zoom", "rotate"])
@pytest.mark.parametrize("dtype", [np.float64, np.int32])
def test_other_dtypes_as_the_jax_module(op, dtype):
    """Anything but float32 is cast to uint8, as in the JAX module."""
    img = (_image((23, 17), np.float32) * 40).astype(dtype)
    if op == "zoom":
        got, want = native.zoom_nearest(img, (12, 30)), jax_native.zoom_nearest(img, (12, 30))
    else:
        got, want = native.rotate_nearest(img, 13), jax_native.rotate_nearest(img, 13)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_refuses_what_the_library_cannot_index():
    for bad in (np.zeros((2, 3, 4), np.float32), np.zeros((0, 5), np.float32)):
        with pytest.raises(ValueError, match="2D"):
            native.rotate_nearest(bad, 5)
    with pytest.raises(ValueError, match="output size"):
        native.zoom_nearest(np.zeros((4, 4), np.float32), (0, 3))


@pytest.mark.parametrize("case", ["f32", "u8", "int32", "float64", "order1"])
def test_transforms_route_as_the_jax_package(case):
    """zoom_to reaches the library for an order-0 zoom of a 2D f32 or u8
    array only, random_rotate always, and both give the JAX package's
    arrays (its own helper left on)."""
    img = {"f32": _image((40, 36), np.float32), "u8": _image((40, 36), np.uint8),
           "int32": _image((40, 36), np.uint8).astype(np.int32),
           "float64": _image((40, 36), np.float64), "order1": _image((40, 36), np.float32)}[case]
    order = 1 if case == "order1" else 0
    native.reset_call_counts()
    got = transforms.zoom_to(img, (48, 32), order=order)
    want = jax_transforms.zoom_to(img, (48, 32), order=order)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert native.zoom_nearest.calls == (case in ("f32", "u8"))
    label = _image((40, 36), np.uint8) % 4
    got = transforms.random_rotate(img, label, np.random.default_rng(4))
    want = jax_transforms.random_rotate(img, label, np.random.default_rng(4))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert native.rotate_nearest.calls == 2


def test_second_call_reuses_the_cached_build(fresh_build, tmp_path):
    assert native.available()
    assert len(fresh_build) == 1 and fresh_build[0][0] == build.find_cxx()
    assert "-ffp-contract=off" in fresh_build[0] and "-march=native" not in fresh_build[0]
    built = list((tmp_path / "build").glob("augment-*/libaugment.so"))
    assert len(built) == 1
    native._load.cache_clear()  # a new process: the library from disk, no compile
    img = _image((30, 20), np.float32)
    np.testing.assert_array_equal(native.rotate_nearest(img, 7),
                                  ndimage.rotate(img, 7, order=0, reshape=False))
    assert len(fresh_build) == 1
    assert list((tmp_path / "build").glob("augment-*/libaugment.so")) == built


def test_broken_source_raises_instead_of_falling_back(fresh_build, tmp_path, monkeypatch):
    broken = tmp_path / "augment.cpp"
    broken.write_text(native.SOURCE.read_text().replace("zoom_index(j, w, ow);", "zoom_index(j, w);"))
    monkeypatch.setattr(native, "SOURCE", broken)
    for call in (native.available,
                 lambda: transforms.zoom_to(_image((20, 20), np.float32), (10, 10)),
                 lambda: native.rotate_nearest(_image((20, 20), np.uint8), 3)):
        with pytest.raises(RuntimeError, match="failed"):
            call()
    assert not list((tmp_path / "build").glob("augment-*/*.so"))


def test_no_compiler_runs_scipy_and_says_so_once(fresh_build, monkeypatch, caplog):
    """No compiler: available() is False, logged once, and RandomGenerator
    gives the JAX package's arrays through scipy, on every branch."""
    monkeypatch.setattr(build, "find_cxx", lambda: None)
    monkeypatch.setattr(jax_native, "available", lambda: False)
    native.reset_call_counts()
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert not native.available() and not native.available()
    assert [r.message for r in caplog.records].count(caplog.records[0].message) == 1
    assert "no C++ compiler" in caplog.records[0].message
    image, label = _image((40, 36), np.float32), _image((40, 36), np.uint8) % 4
    port, ref = transforms.RandomGenerator((48, 32)), jax_transforms.RandomGenerator((48, 32))
    for seed in range(12):  # seeds 0-11 reach all three branches
        got = port(image, label, np.random.default_rng(seed))
        want = ref(image, label, np.random.default_rng(seed))
        np.testing.assert_array_equal(got[0], want[0][..., 0])
        np.testing.assert_array_equal(got[1], want[1])
    lab32 = label.astype(np.int32)  # the JAX module's fallback keeps scipy's dtype
    np.testing.assert_array_equal(native.zoom_nearest(lab32, (20, 20)),
                                  jax_native.zoom_nearest(lab32, (20, 20)))
    assert native.zoom_nearest(lab32, (20, 20)).dtype == np.int32
    assert native.zoom_nearest.calls == native.rotate_nearest.calls == 0
    assert not fresh_build


def test_first_calls_from_many_threads(fresh_build):
    """16 threads call at once on a library not yet loaded, the switch
    interval shortened: one compile, every call counted, every result
    scipy's."""
    img = _image((64, 48), np.float32)
    want = ndimage.rotate(img, 11, order=0, reshape=False)
    results, barrier = [], threading.Barrier(16)

    def work():
        barrier.wait()
        for _ in range(25):
            results.append(bool((native.rotate_nearest(img, 11) == want).all()))
            native.zoom_nearest(img, (32, 32))

    native.reset_call_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(fresh_build) == 1
    assert len(results) == 400 and all(results)
    assert native.rotate_nearest.calls == native.zoom_nearest.calls == 400


def test_no_compiler_found_where_cxx_names_none(monkeypatch):
    monkeypatch.setenv("CXX", "no-such-compiler-anywhere")
    assert build.find_cxx() is None
    monkeypatch.delenv("CXX")
    assert build.find_cxx() == shutil.which("g++")
