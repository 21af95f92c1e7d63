"""Fixtures that put the order-0 rotate and zoom of both packages on one
path, for the port's parity tests of host batches: import them into a
test module (`from _torch_native import native_on_both, scipy_on_both
# noqa: F401`).

`scipy_on_both`: the reference's scipy.ndimage in both packages (each
package's `native.available()` says False). `native_on_both`: each
package's C++ helper, the JAX package's library as it loads (the test
skips where it does not) and the port's built here; the port's library
must have been called by the end of the test."""
import pytest

from icl_tpu import native as jax_native

from icl_tpu_torch import native


@pytest.fixture
def scipy_on_both(monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)


@pytest.fixture
def native_on_both():
    if not jax_native.available():
        pytest.skip("the JAX package's native library does not load here")
    assert native.available(), "the port's library did not build"
    native.reset_call_counts()
    yield
    assert native.zoom_nearest.calls > 0, "the port's batches did not reach its library"
