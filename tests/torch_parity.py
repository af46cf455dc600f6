"""Tolerances for holding the PyTorch port against the JAX reference (or
one path of the port against another). Not a test module: the port's
test files import it.

* :func:`to_numpy` is the bridge: torch tensors (any device, any float
  dtype), JAX arrays and numpy arrays all become numpy arrays, floats
  widened to float64 so the comparison itself rounds nothing.
* :func:`assert_close` holds floats to a limit scaled to the reference's
  magnitude: ``max|got - want| <= rtol * max|want|``. One wrong entry
  anywhere fails it; sums taken in another order pass it.
* :func:`assert_close_ulps` states the same limit in units of the last
  place of a dtype at the reference's largest magnitude.
* :func:`assert_equal` is the integer mode: same shape, same values,
  both integer-typed (index streams, labels, uint8 pixels).
"""

from __future__ import annotations

import numpy as np


def to_numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):   # a torch tensor
        x = x.detach().cpu()
        if x.is_floating_point():
            x = x.double()
        x = x.numpy()
    x = np.asarray(x)
    if np.issubdtype(x.dtype, np.floating):
        x = x.astype(np.float64)
    return x


def assert_close(got, want, rtol: float, what: str = "") -> None:
    got, want = to_numpy(got), to_numpy(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rtol * scale, (
        f"{what}: max|got - want| = {err:.3e} > {rtol:g} x max|want| "
        f"({scale:.3e})"
    )


def assert_close_ulps(got, want, ulps: float, dtype=np.float32,
                      what: str = "") -> None:
    assert_close(got, want, ulps * float(np.finfo(dtype).eps), what)


def assert_equal(got, want, what: str = "") -> None:
    got, want = to_numpy(got), to_numpy(want)
    for a in (got, want):
        assert np.issubdtype(a.dtype, np.integer) or a.dtype == bool, (
            f"{what}: integer mode got dtype {a.dtype}")
    np.testing.assert_array_equal(got, want, err_msg=what)
