"""The PyTorch port's paged attention (pytorch_distributed_tpu_torch/ops/
paged_attention.py) held against the JAX package's.

Inputs are numpy arrays from a seed, fed to both packages. On the CPU the
port's wrapper runs its plain ``stream`` version; it is held against the
JAX Pallas kernel run in interpret mode and against the JAX ``gather``
impl, in f32; so is the plain model of the CUDA kernel's algorithm, a
split of each row's keys over several CTAs and a merge of their partial
softmax carries (``paged_attention_split_reference``). Online softmax reorders the reductions, so outputs agree
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
    _NEG_INF,
    paged_attention,
    paged_attention_split_reference,
    paged_combine,
    paged_split_partials,
    pages_per_split,
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


def _split(q, kp, vp, tables, lengths, window, pps):
    t = torch.from_numpy
    return paged_attention_split_reference(
        t(q), t(kp), t(vp), page_tables=t(tables), lengths=t(lengths),
        window=window, pps=pps,
    ).numpy()


@pytest.mark.parametrize("W,G,window", [
    (1, 1, None), (1, 2, 5), (1, 4, None),
    (5, 1, 5), (5, 2, None), (5, 4, 5),
])
def test_matches_jax_kernel_and_gather(W, G, window):
    """W in {1, 5}, GQA groups in {1, 2, 4}, window on and off, a
    zero-length row; the split model at 1 and 3 pages per split (a row's
    pages cut mid-run; with the window, leading splits left empty) and at
    the wrapper's choice."""
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
    for pps in (1, 3, None):
        out = _split(*case, window, pps)
        for ref in (ref_kernel, ref_gather):
            np.testing.assert_allclose(
                out, ref, rtol=0, atol=RTOL * np.abs(ref).max(),
                err_msg=f"split model, {pps} pages per split")
    # CPU tensors never reach the kernel, so the launch count stays put
    assert paged_attention.launches == before


@pytest.mark.parametrize("G", [1, 4])
def test_split_merge_weights_by_max_not_by_l(G):
    """W = 5 with a split boundary just past lengths[b]: query 0 of such a
    row sees none of the next split's keys (they are the later queries'
    own), so that split's carry for it ends with m = -1e30, l > 0 and an
    acc of the values it saw masked. Only the merge's weight e^(m - M) = 0
    wipes it. The split model matches the JAX kernel and gather; a merge
    that decides by l > 0, keeping such a split at full weight, does
    not."""
    rng = np.random.default_rng(50 + G)
    W, Hkv, ps, n = 5, 2, 8, 4
    q, kp, vp, tables, _ = _case(rng, B=3, W=W, Hq=G * Hkv, Hkv=Hkv, ps=ps,
                                 n=n)
    lengths = np.array([15, 7, 23], np.int32)   # boundaries at 16, 8, 24
    tables = np.arange(1, 3 * n + 1, dtype=np.int32).reshape(3, n)
    refs = [_jax(q, kp, vp, tables, lengths, impl, None)
            for impl in ("kernel", "gather")]
    out = _split(q, kp, vp, tables, lengths, None, 1)
    for ref in refs:
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=RTOL * np.abs(ref).max())

    t = torch.from_numpy
    m, l, acc, live = paged_split_partials(
        t(q), t(kp), t(vp), page_tables=t(tables), lengths=t(lengths),
        scale=1.0 / np.sqrt(q.shape[-1]), window=None, pps=1,
    )
    # row b, query 0, split lengths[b] // ps + 1: only masked keys
    for b, L in enumerate(lengths):
        s = L // ps + 1
        assert live[b, s]
        assert (m[b, 0, ..., s] == _NEG_INF).all()
        assert (l[b, 0, ..., s] == W - 1).all()
    # a merge that decides by l > 0: a split whose max is the sentinel
    # but whose l > 0 counts at full weight
    M = torch.where(live[:, None, None, None, :], m, -np.inf).amax(
        -1, keepdim=True)
    w = torch.where(m == _NEG_INF, (l > 0).float(), torch.exp(m - M))
    w = torch.where(live[:, None, None, None, :], w, 0.0)
    wrong = ((w[..., None] * acc).sum(-2) / (w * l).sum(-1)[..., None])
    wrong = wrong.reshape(out.shape).numpy()
    assert np.abs(wrong - refs[0]).max() > 100 * RTOL * np.abs(
        refs[0]).max()
    right = paged_combine(m, l, acc, live).reshape(out.shape).numpy()
    np.testing.assert_array_equal(right, out)


def test_pages_per_split_fills_the_card_from_shapes_alone():
    """At Llama-3-8B's decode tick (8 rows, 8 kv heads, a 64-page bucket)
    the split gives 8 pages a CTA and 512 CTAs, at least two per SM of an
    H100 (132); at every bucket width 1..64 the splits tile the table with
    no empty trailing split, within the kernel's page limit."""
    assert pages_per_split(8, 8, 64) == 8
    assert 8 * 8 * 64 // 8 >= 2 * 132
    for B, Hkv in ((1, 8), (8, 8), (3, 2), (64, 8), (256, 8)):
        for n in range(1, 65):
            pps = pages_per_split(B, Hkv, n)
            splits = -(-n // pps)
            assert 1 <= pps <= n and (splits - 1) * pps < n
    assert pages_per_split(512, 8, 5000) <= 1024


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
