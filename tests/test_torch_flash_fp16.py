"""The port's flash attention in fp16 (its plain blocked versions, the
CPU route and the yardstick the card's fp16 kernels are held to) against
the JAX package's Pallas flash kernels in fp16, in interpret mode, on the
same numpy inputs and output cotangents: the forward and the vjp.

Both sides round at the Pallas rounding points (P to v's dtype before
P.V, dS to k's and q's before dS.K and dS^T.Q) and return fp16, from f32
sums taken in another order and over other blocks, so an entry lands a
few fp16 steps (2^-11 of itself) apart. Read here up to 2.5e-4 of the
largest output (the padded case) and 8.4e-4 of the largest gradient
(dk, GQA); limits 2e-3 and 5e-3. A wrong mask, scale or rounding point
reads ~1e-1 or more. The cases: causal and full, GQA, a ragged padding
mask (BERT's ``[B, T]`` key mask, non-causal), packed segments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
)
from pytorch_distributed_tpu_torch.ops.flash_attention import flash_attention
from tests.torch_parity import assert_close

OUT_RTOL, GRAD_RTOL = 2e-3, 5e-3

# name: (B, S, T, Hq, Hkv, D, causal, extras)
CASES = {
    "causal": (2, 48, 48, 4, 4, 16, True, {}),
    "full_gqa": (2, 32, 32, 4, 2, 16, False, {}),
    "padded": (3, 40, 40, 2, 2, 16, False, {"lengths": (8, 40)}),
    "segments": (2, 48, 48, 2, 1, 16, True, {"segments": True}),
}


def _inputs(case):
    B, S, T, Hq, Hkv, D, causal, extras = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    arrays = [rng.normal(size=shape).astype(np.float16) for shape in (
        (B, S, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D), (B, S, Hq, D))]
    kw = dict(causal=causal)
    if "lengths" in extras:
        lo, hi = extras["lengths"]
        lengths = rng.integers(lo, hi + 1, size=B)
        kw["kv_mask"] = np.arange(T)[None, :] < lengths[:, None]
    if extras.get("segments"):
        seg = np.ones((B, S), np.int32)
        for b in range(B):
            cuts = sorted(rng.choice(np.arange(3, S - 3), 2, replace=False))
            seg[b, cuts[0]:cuts[1]] = 2
            seg[b, cuts[1]:] = 3
        kw["segment_ids"] = seg
    return arrays, kw


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_flash_fp16_matches_jax_pallas_fp16(case):
    (q, k, v, dout), kw = _inputs(case)
    jkw = {key: (jnp.asarray(val) if isinstance(val, np.ndarray) else val)
           for key, val in kw.items()}
    want, vjp = jax.vjp(
        lambda q, k, v: jax_flash_attention(q, k, v, block_q=16,
                                            block_k=16, **jkw),
        *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tkw = {key: (torch.from_numpy(val) if isinstance(val, np.ndarray)
                 else val) for key, val in kw.items()}
    out = flash_attention(tq, tk, tv, block_q=16, block_k=16, **tkw)
    out.backward(torch.from_numpy(dout))
    assert want.dtype == jnp.float16 and out.dtype == torch.float16
    assert torch.isfinite(out).all()
    assert_close(out, want, OUT_RTOL, "out")
    for name, t, w in zip("qkv", (tq, tk, tv), want_grads):
        assert t.grad.dtype == torch.float16
        assert_close(t.grad, w, GRAD_RTOL, f"d{name}")


def test_fp16_overflow_reaches_the_gradients_as_inf():
    """A cotangent scaled past fp16's range (a loss scaled too far) comes
    out of the backward as inf, not clamped: what the loss scaler must
    see to skip the step."""
    (q, k, v, dout), kw = _inputs("causal")
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=True)
    out.backward(torch.from_numpy(dout) * 3e4)
    assert not all(torch.isfinite(t.grad).all() for t in (tq, tk, tv))
