"""The model families' head shapes through the port's plain attention
versions (the CPU path of the flash and paged kernels, and their
yardstick on the card), held against the JAX package.

* Flash at head_dim 96 (Phi-3) and 256 (Gemma, Pythia-1B): the plain
  blocked forward and its gradients against JAX ``flash_attention``, the
  Pallas kernels in interpret mode, as the JAX package's own tests run
  them on the CPU. Tolerances as ``tests/test_torch_flash_attention.py``:
  2e-5 (outputs) and 1e-4 (gradients) of the largest reference
  magnitude, f32 on both sides summed in different orders.
* Paged decode at head_dim 96 and 256, groups of 7 (Qwen2-7B) and 8
  (Gemma-2B's multi-query), with a window (Mistral): the port's
  ``stream`` and ``gather`` against JAX ``paged_attention`` with
  ``impl="stream"`` and ``"gather"``, to 1e-5 of the largest output.

Inputs are drawn with numpy from a seed and handed to both frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
)
from pytorch_distributed_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention,
)
from pytorch_distributed_tpu_torch.ops.flash_attention import flash_attention
from pytorch_distributed_tpu_torch.ops.paged_attention import paged_attention

OUT_RTOL = 2e-5
GRAD_RTOL = 1e-4
PAGED_RTOL = 1e-5

# name: (B, S, T, Hq, Hkv, D, causal, packed)
FLASH_CASES = {
    "d96_causal_gqa": (1, 32, 32, 4, 2, 96, True, False),
    "d256_mqa_causal": (1, 32, 32, 4, 1, 256, True, False),
    "d256_packed": (1, 32, 32, 2, 2, 256, True, True),
}


def _close(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    tol = rtol * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_plain_flash_matches_jax_at_family_head_dims(case):
    B, S, T, Hq, Hkv, D, causal, packed = FLASH_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    dout = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    seg = None
    if packed:
        seg = np.ones((B, S), np.int32)
        seg[:, 11:] = 2
        seg[:, 23:] = 3
    want, vjp = jax.vjp(
        lambda q, k, v: jax_flash_attention(
            q, k, v, causal=causal, block_q=16, block_k=16,
            segment_ids=None if seg is None else jnp.asarray(seg)),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(
        tq, tk, tv, causal=causal, block_q=16, block_k=16,
        segment_ids=None if seg is None else torch.from_numpy(seg))
    out.backward(torch.from_numpy(dout))
    _close(out.detach(), want, OUT_RTOL, "out")
    for name, t, w in zip("qkv", (tq, tk, tv), want_grads):
        _close(t.grad, w, GRAD_RTOL, f"d{name}")


def _paged_case(rng, *, B, W, Hq, Hkv, D, ps=8, n=6):
    """Ragged lengths (a zero-length row among them), distinct pages per
    row, garbage in the null page 0."""
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


@pytest.mark.parametrize("W,G,D,window", [
    (5, 1, 96, 5), (1, 7, 96, 9), (1, 8, 256, None), (2, 7, 256, 6),
], ids=["d96_verify_window", "d96_g7_window", "d256_g8_mqa",
        "d256_g7_window"])
def test_paged_stream_matches_jax_at_family_shapes(W, G, D, window):
    rng = np.random.default_rng(W * 1000 + G * 100 + D)
    Hkv = 1 if G == 8 else 2
    q, kp, vp, tables, lengths = _paged_case(rng, B=3, W=W, Hq=G * Hkv,
                                             Hkv=Hkv, D=D)
    for impl in ("stream", "gather"):
        ref = np.asarray(jax_paged_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            page_tables=jnp.asarray(tables), lengths=jnp.asarray(lengths),
            window=window, impl=impl))
        t = torch.from_numpy
        out = paged_attention(t(q), t(kp), t(vp), page_tables=t(tables),
                              lengths=t(lengths), window=window, impl=impl)
        _close(out, ref, PAGED_RTOL, impl)
