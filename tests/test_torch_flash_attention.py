"""The PyTorch port's flash attention (its plain blocked versions, which
CPU tensors get) held against the JAX package's ``flash_attention`` (the
Pallas kernels, in interpret mode on the CPU) and against the port's own
einsum ``dot_product_attention``.

Inputs and output cotangents are drawn with numpy from a seed and handed
to both frameworks. Everything is f32, bar the models of the bf16
kernels' rounding at the end. Tolerances are relative to the
largest reference magnitude: 2e-5 for outputs and 1e-4 for gradients,
the bounds the JAX package's own flash-vs-einsum tests use. The two
sides sum in different orders and block the keys differently (the JAX
kernel picks divisor blocks, the port masks a ragged last block), so they
agree to a few f32 ulps of the largest term, not bitwise.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
)
from pytorch_distributed_tpu_torch.ops import attention as attn_mod
from pytorch_distributed_tpu_torch.ops import flash_attention as fa
from pytorch_distributed_tpu_torch.ops.attention import (
    attention,
    dot_product_attention,
)
from pytorch_distributed_tpu_torch.ops.flash_attention import flash_attention

# the module (the package's ``ops.flash_attention`` is the function)
jax_fa = importlib.import_module("pytorch_distributed_tpu.ops.flash_attention")
OUT_RTOL = 2e-5
GRAD_RTOL = 1e-4

# name: (B, S, T, Hq, Hkv, D, causal, extras)
CASES = {
    "causal": (2, 48, 48, 4, 4, 16, True, {}),
    "full": (2, 48, 48, 4, 4, 16, False, {}),
    "gqa_4_2": (2, 32, 32, 4, 2, 16, True, {}),
    "gqa_4_1": (1, 32, 32, 4, 1, 32, False, {}),
    "kv_mask": (3, 32, 32, 2, 2, 16, True, {"kv_mask": True}),
    "segment_ids": (2, 48, 48, 2, 1, 16, True, {"segments": True}),
    "sm_scale_1": (2, 32, 32, 2, 2, 16, False, {"sm_scale": 1.0}),
    "s_ne_t": (2, 24, 40, 2, 2, 16, False, {}),
    "s_ne_t_causal": (2, 40, 24, 2, 2, 16, True, {}),
    "ragged_block": (1, 40, 40, 2, 2, 16, True, {"block": 16}),
}


# longer cases for the rounding models below only: the bf16 forward
# kernel changes its running maximum every 64 keys, so these span several
# such tiles (the JAX vjp in interpret mode is too slow for them)
LONG_CASES = {
    "long_causal_gqa": (1, 256, 256, 4, 2, 64, True, {}),
    "long_segments": (1, 192, 192, 2, 2, 64, True, {"segments": True}),
}


def _inputs(case):
    B, S, T, Hq, Hkv, D, causal, extras = {**CASES, **LONG_CASES}[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    dout = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    kw = dict(causal=causal)
    valid = np.ones((B, S), bool)
    if extras.get("kv_mask"):
        # a ragged padded tail per row; batch row 0 has no key at all,
        # so its outputs are undefined (finite) and go ungraded
        lengths = np.array([0] + list(rng.integers(1, T + 1, size=B - 1)))
        kw["kv_mask"] = np.arange(T)[None, :] < lengths[:, None]
        valid[0] = False
    if extras.get("segments"):
        seg = np.zeros((B, S), np.int32)
        for b in range(B):
            cuts = sorted(rng.choice(np.arange(3, S - 3), 2, replace=False))
            seg[b, cuts[0]:cuts[1]] = 1
            seg[b, cuts[1]:] = 2
        kw["segment_ids"] = seg + 1
    if "sm_scale" in extras:
        kw["sm_scale"] = extras["sm_scale"]
    block = extras.get("block", 16)
    return (q, k, v, dout), kw, valid, block


def _close(got, want, rtol, what, valid=None):
    got, want = np.asarray(got), np.asarray(want)
    if valid is not None:
        got, want = got[valid], want[valid]
    tol = rtol * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _port(arrays, kw, block, fn=flash_attention):
    q, k, v, dout = (torch.from_numpy(a) for a in arrays)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    tkw = {key: (torch.from_numpy(val) if isinstance(val, np.ndarray)
                 else val) for key, val in kw.items()}
    if fn is flash_attention:
        out = fn(q, k, v, block_q=block, block_k=block, **tkw)
    else:  # dot_product_attention's names for the masks
        tkw["mask"] = tkw.pop("kv_mask", None)
        tkw["scale"] = tkw.pop("sm_scale", None)
        out = fn(q, k, v, **tkw)
    out.backward(dout)
    return out.detach().numpy(), [t.grad.numpy() for t in (q, k, v)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_flash_matches_jax_flash_fwd_and_vjp(case):
    arrays, kw, valid, block = _inputs(case)
    q, k, v, dout = (jnp.asarray(a) for a in arrays)
    jkw = {key: (jnp.asarray(val) if isinstance(val, np.ndarray) else val)
           for key, val in kw.items()}
    # the JAX kernel shrinks its blocks to divisors of S and T itself
    want, vjp = jax.vjp(
        lambda q, k, v: jax_flash_attention(
            q, k, v, block_q=16, block_k=16, **jkw
        ), q, k, v,
    )
    # ungraded rows get a zero cotangent on both sides
    cot = np.where(valid[:, :, None, None], arrays[3], 0.0)
    want_grads = vjp(jnp.asarray(cot))
    got, grads = _port(arrays[:3] + (cot,), kw, block)
    assert np.isfinite(got).all()
    _close(got, want, OUT_RTOL, "out", valid)
    for name, g, w in zip("qkv", grads, want_grads):
        _close(g, w, GRAD_RTOL, f"d{name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_flash_matches_port_einsum_attention(case):
    arrays, kw, valid, block = _inputs(case)
    cot = np.where(valid[:, :, None, None], arrays[3], 0.0)
    arrays = arrays[:3] + (cot,)
    got, grads = _port(arrays, kw, block)
    want, want_grads = _port(arrays, kw, block, fn=dot_product_attention)
    _close(got, want, OUT_RTOL, "out", valid)
    for name, g, w in zip("qkv", grads, want_grads):
        _close(g, w, GRAD_RTOL, f"d{name}")


def test_dispatch_is_per_call(monkeypatch):
    """On the CPU ``impl=None`` takes the einsum path and ``"flash"`` the
    plain flash version; a call flash cannot take refuses ``"flash"``."""
    calls = []
    real = attn_mod.flash_attention

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(attn_mod, "flash_attention", spy)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(1, 16, 2, 16)).astype(np.float32))
    seg = torch.ones(1, 16, dtype=torch.int32)
    ref = attention(q, q, q, causal=True, segment_ids=seg)
    assert calls == []
    out = attention(q, q, q, causal=True, segment_ids=seg, scale=1.0,
                    impl="flash")
    assert len(calls) == 1 and calls[0]["sm_scale"] == 1.0
    _close(out, attention(q, q, q, causal=True, scale=1.0, impl="xla"),
           OUT_RTOL, "flash vs xla")
    assert torch.isfinite(ref).all()
    for bad in (dict(q_offset=3), dict(window=4)):
        with pytest.raises(ValueError, match="impl='flash'"):
            attention(q, q, q, causal=True, impl="flash", **bad)
    for impl in (None, "flash", "xla"):   # only a [B, T] key mask
        with pytest.raises(ValueError, match=r"\[B, T\] key mask"):
            attention(q, q, q, impl=impl,
                      mask=torch.ones(1, 2, 16, 16, dtype=torch.bool))
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention(q, q, q, impl="pallas")


def test_flash_validates_like_jax():
    q = torch.zeros(2, 8, 4, 16)
    k = torch.zeros(2, 8, 3, 16)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="kv_mask must be"):
        flash_attention(q, q, q, kv_mask=torch.ones(2, 7, dtype=torch.bool))
    with pytest.raises(ValueError, match="self-attention"):
        kk = torch.zeros(2, 9, 4, 16)
        flash_attention(q, kk, kk, segment_ids=torch.ones(2, 8))
    with pytest.raises(ValueError, match="segment_ids must be"):
        flash_attention(q, q, q, segment_ids=torch.ones(2, 9))
    with pytest.raises(ValueError, match="impl must be"):
        flash_attention(q, q, q, impl="kernel")


# --------------------------------------------------------------------------
# the bf16 tensor-core kernels' rounding, modelled in PyTorch
# --------------------------------------------------------------------------

# the bf16 limits of the kernels against the plain versions
# (tests/test_torch_kernels_cuda.py and chip_smoke.py, FLASH_TOL, LSE_TOL)
BF16_OUT_TOL = dict(max=1e-2, norm=5e-3)
BF16_GRAD_TOL = dict(max=1e-2, norm=1e-3)
LSE_TOL = dict(max=1e-5, norm=1e-5)
# the bf16 forward kernel's key tile (csrc/flash_attention.cu, FwdTc::BN):
# it rounds P to bf16 against the running maximum of every FWD_BN keys
FWD_BN = 64
ROUNDING_CASES = ["causal", "gqa_4_2", "kv_mask", "segment_ids",
                  "s_ne_t_causal", *LONG_CASES]


def _bf16_case(case):
    """The case's q, k, v and dout rounded to bf16, its bias and segment
    ids as the kernels take them, and the forward's keywords."""
    arrays, kw, valid, _ = _inputs(case)
    q, k, v, dout = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    B, T = k.shape[:2]
    bias = seg = None
    if "kv_mask" in kw:
        bias = torch.zeros(B, T).masked_fill(
            ~torch.from_numpy(kw["kv_mask"]), fa._NEG_INF)
    if "segment_ids" in kw:
        seg = torch.from_numpy(kw["segment_ids"]).int()
    scale = kw.get("sm_scale", q.shape[-1] ** -0.5)
    return (q, k, v, dout), bias, seg, dict(sm_scale=scale,
                                            causal=kw["causal"]), valid


def _assert_within(got, want, tol, what):
    got, want = got.float(), want.float()
    diff = got - want
    assert diff.abs().max() <= tol["max"] * want.abs().max(), what
    assert diff.norm() <= tol["norm"] * want.norm(), what


@pytest.mark.parametrize("case", ROUNDING_CASES)
def test_fwd_kernel_rounding_fits_bf16_limits(case):
    """The bf16 forward kernel's rounding schedule (P rounded to bf16
    against the running maximum of each FWD_BN-key tile, l summed from
    the unrounded P: the plain version at ``block_k=FWD_BN``) holds
    the kernels' bf16 output limit and the lse limit against the JAX
    forward (the Pallas kernel in interpret mode, at its default blocks
    of 128, which round P against another schedule) on the same bf16
    inputs. Rows without a visible key are undefined and go ungraded."""
    (q, k, v, _), bias, seg, fkw, valid = _bf16_case(case)
    got, got_lse = fa._flash_fwd_plain(q, k, v, bias, seg, block_k=FWD_BN,
                                       **fkw)
    j = lambda t: None if t is None else jnp.asarray(  # noqa: E731
        t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy())
    want, want_lse = jax_fa._fwd(
        *(j(t).astype(jnp.bfloat16) for t in (q, k, v)), j(bias), j(seg),
        fkw["sm_scale"], fkw["causal"], 128, 128,
    )
    B, S, Hq, _ = q.shape
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    want_lse = torch.from_numpy(
        np.array(want_lse)[:, :, 0].reshape(B, Hq, S))
    rows = torch.from_numpy(valid)
    _assert_within(got.float()[rows], want[rows], BF16_OUT_TOL, "out")
    _assert_within(got_lse.transpose(1, 2)[rows],
                   want_lse.transpose(1, 2)[rows], LSE_TOL, "lse")


def _dkv_tensor_core_model(q, k, v, dout, lse, delta, bias, seg, *,
                           sm_scale, causal, block_q=64):
    """dK and dV as the bf16 tensor-core dkv kernel rounds them: products
    of bf16 operands summed in f32, q tile by q tile; dS rounded to bf16
    before dS^T.Q; P kept in f32 for P^T.dO as P = hi + lo, hi = bf16(P),
    lo = bf16(P - hi), two bf16 products."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg, dog = fa._grouped(q, Hkv), fa._grouped(dout, Hkv)
    kf = k.permute(0, 2, 1, 3).float()
    vf = v.permute(0, 2, 1, 3).float()
    lse_g = lse.reshape(B, Hkv, G, S, 1)
    delta_g = delta.reshape(B, Hkv, G, S, 1)
    dk = torch.zeros((B, Hkv, T, D))
    dv = torch.zeros((B, Hkv, T, D))
    bf = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    for q0 in range(0, S, block_q):
        rows = slice(q0, q0 + block_q)
        qb, dob = qg[:, :, :, rows], dog[:, :, :, rows]
        p = torch.exp(fa._scores(qb, kf, bias, seg, sm_scale, causal, q0, 0)
                      - lse_g[:, :, :, rows])
        hi = bf(p)
        lo = bf(p - hi)
        dv = dv + torch.einsum("bhgst,bhgsd->bhtd", hi, dob)
        dv = dv + torch.einsum("bhgst,bhgsd->bhtd", lo, dob)
        dp = torch.einsum("bhgsd,bhtd->bhgst", dob, vf)
        ds = bf(p * (dp - delta_g[:, :, :, rows]) * sm_scale)
        dk = dk + torch.einsum("bhgst,bhgsd->bhtd", ds, qb)
    return (dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


@pytest.mark.parametrize("case", ROUNDING_CASES)
def test_dkv_kernel_rounding_fits_bf16_limits(case):
    """The bf16 dkv kernel's rounding (P split into bf16 hi + lo for dV,
    dS in bf16 for dK) stays within the kernels' bf16 gradient limits of
    the plain version, which keeps P in f32."""
    (q, k, v, dout), bias, seg, fkw, _ = _bf16_case(case)
    out, lse = fa._flash_fwd_plain(q, k, v, bias, seg, **fkw)
    args = (q, k, v, dout, lse, fa._delta(dout, out), bias, seg)
    want = fa._flash_dkv_plain(*args, **fkw)
    got = _dkv_tensor_core_model(*args, **fkw)
    for name, g, w in zip(("dk", "dv"), got, want):
        _assert_within(g, w, BF16_GRAD_TOL, name)
