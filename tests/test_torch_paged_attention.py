"""The PyTorch port's paged attention (pytorch_distributed_tpu_torch/ops/
paged_attention.py) held against the JAX package's.

Inputs are numpy arrays from a seed, fed to both packages. On the CPU the
port's wrapper runs its plain ``stream`` version; it is held against the
JAX Pallas kernel run in interpret mode and against the JAX ``gather``
impl, in f32. Online softmax reorders the reductions, so outputs agree
to a tolerance scaled to the output's magnitude (RTOL below), not
bitwise. The CUDA kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention,
    paged_write as jax_paged_write,
)
from pytorch_distributed_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_write,
)

# f32, different summation orders (torch vs XLA einsums, page-by-page
# online softmax): a few ulp of the largest output
RTOL = 1e-5


def _case(rng, *, B=4, W=1, Hq=4, Hkv=2, D=16, ps=8, n=4):
    """Pool + tables + ragged lengths (a zero-length row included);
    tail table entries point at null page 0, which holds garbage."""
    P1 = B * n + 1
    q = rng.standard_normal((B, W, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((P1, ps, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P1, ps, Hkv, D)).astype(np.float32)
    kp[0], vp[0] = 1e6, -1e6
    lengths = rng.integers(0, n * ps - W + 1, size=B).astype(np.int32)
    lengths[0] = 0
    tables = np.arange(1, B * n + 1, dtype=np.int32).reshape(B, n)
    for b in range(B):
        tables[b, -(-(lengths[b] + W) // ps):] = 0
    return q, kp, vp, tables, lengths


def _jax(q, kp, vp, tables, lengths, impl, window):
    return np.asarray(jax_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        page_tables=jnp.asarray(tables), lengths=jnp.asarray(lengths),
        window=window, impl=impl,
    ))


def _port(q, kp, vp, tables, lengths, impl, window):
    t = torch.from_numpy
    return paged_attention(
        t(q), t(kp), t(vp), page_tables=t(tables), lengths=t(lengths),
        window=window, impl=impl,
    ).numpy()


@pytest.mark.parametrize("W,G,window", [
    (1, 1, None), (1, 2, 5), (1, 4, None),
    (5, 1, 5), (5, 2, None), (5, 4, 5),
])
def test_matches_jax_kernel_and_gather(W, G, window):
    """W in {1, 5}, GQA groups in {1, 2, 4}, window on and off."""
    rng = np.random.default_rng(10 * W + G)
    Hkv = 2
    case = _case(rng, W=W, Hq=G * Hkv, Hkv=Hkv)
    before = paged_attention.launches
    ref_kernel = _jax(*case, "kernel", window)
    ref_gather = _jax(*case, "gather", window)
    for ref, port_impl in ((ref_kernel, None), (ref_kernel, "stream"),
                           (ref_gather, "gather")):
        out = _port(*case, port_impl, window)
        tol = RTOL * np.abs(ref).max()
        np.testing.assert_allclose(out, ref, rtol=0, atol=tol,
                                   err_msg=str(port_impl))
    # CPU tensors never reach the kernel, so the launch count stays put
    assert paged_attention.launches == before


@pytest.mark.parametrize("impl", [None, "gather"])
def test_null_page_contents_unobservable(impl):
    """Garbage in frame 0 (the null page) changes no output, bitwise."""
    rng = np.random.default_rng(2)
    q, kp, vp, tables, lengths = _case(rng, W=2)
    kp[0], vp[0] = 0.0, 0.0
    clean = _port(q, kp, vp, tables, lengths, impl, None)
    kp[0], vp[0] = 3e5, -3e5
    dirty = _port(q, kp, vp, tables, lengths, impl, None)
    assert np.array_equal(clean, dirty)


def test_paged_write_matches_jax():
    """Placement through the page table and dropped rows (keep=False
    writes nothing) are exactly the JAX paged_write's."""
    rng = np.random.default_rng(3)
    P1, ps, H, D, B, W = 13, 4, 2, 8, 4, 3
    pool = rng.standard_normal((P1, ps, H, D)).astype(np.float32)
    new = rng.standard_normal((B, W, H, D)).astype(np.float32)
    tables = rng.permutation(np.arange(1, P1)).reshape(B, 3).astype(
        np.int32
    )
    write_pos = np.array([0, 3, 6, 9], np.int32)  # crosses page edges
    keep = np.array([True, False, True, True])
    ref = np.asarray(jax_paged_write(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(tables),
        jnp.asarray(write_pos), jnp.asarray(keep),
    ))
    port = torch.from_numpy(pool.copy())
    out = paged_write(
        port, torch.from_numpy(new), torch.from_numpy(tables),
        torch.from_numpy(write_pos), torch.from_numpy(keep),
    )
    assert out is port  # in place
    assert np.array_equal(port.numpy(), ref)
    assert not np.array_equal(ref, pool)  # the kept rows did land


def test_wrapper_validates_inputs():
    rng = np.random.default_rng(4)
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in _case(rng))
    with pytest.raises(ValueError, match="impl"):
        paged_attention(q, kp, vp, page_tables=tables, lengths=lengths,
                        impl="kernel")
    with pytest.raises(ValueError, match="int32"):
        paged_attention(q, kp, vp, page_tables=tables.long(),
                        lengths=lengths)
    with pytest.raises(ValueError, match="window"):
        paged_attention(q, kp, vp, page_tables=tables, lengths=lengths,
                        window=0)
