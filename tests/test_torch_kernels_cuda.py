"""The PyTorch port's CUDA kernels on the card (marker ``cuda``).

The kernels have no CPU mode, so every test here skips without a CUDA
card. This file imports no JAX, so it also runs on a machine that has
none; there, skip the JAX-importing ``conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_kernels_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu_torch import (
    EngineConfig,
    LlamaConfig,
    LlamaForCausalLM,
    Request,
    ServeEngine,
    generate,
    paged_attention,
)
from pytorch_distributed_tpu_torch.runtime.precision import Policy

pytestmark = pytest.mark.cuda

# kernel vs its plain version, relative to max|reference|: f32 differs in
# summation order only; bf16 rounds the probabilities and the output
RTOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _case(gen, *, B, W, Hq, Hkv, D, ps, n, dtype, device, lengths=None):
    """Ragged lengths (one zero) or the ``lengths`` given, distinct live
    pages per row, null-page tails holding garbage."""
    if lengths is None:
        lengths = torch.randint(0, n * ps - W + 1, (B,), generator=gen)
        lengths[0] = 0
    else:
        lengths = torch.tensor(lengths)
    P1 = B * n + 1
    tables = torch.zeros(B, n, dtype=torch.int32)
    for b in range(B):
        live = -(-(int(lengths[b]) + W) // ps)
        tables[b, :live] = torch.arange(1 + b * n, 1 + b * n + live)
    kw = dict(generator=gen)
    q = torch.randn(B, W, Hq, D, **kw)
    kp = torch.randn(P1, ps, Hkv, D, **kw)
    vp = torch.randn(P1, ps, Hkv, D, **kw)
    kp[0], vp[0] = 1e4, -1e4
    to = lambda t: t.to(device=device, dtype=dtype)  # noqa: E731
    return to(q), to(kp), to(vp), tables.to(device), lengths.int().to(device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("W,G,D,window,n,lengths", [
    (1, 4, 128, None, 5, None), (5, 4, 128, None, 5, None),
    (1, 2, 64, 7, 5, None), (3, 8, 256, None, 5, None),
    # a longer pool: at B = 3, Hkv = 2 the split walks one 16-key page
    # per CTA, 64 splits; rows through every split, a window
    (1, 4, 128, None, 64, None), (5, 4, 64, 100, 64, [1019, 0, 600]),
    # W = 5 with the next split starting just past lengths[b]: query 0
    # sees none of its keys (its carry ends at the -1e30 sentinel, l > 0)
    (5, 4, 128, None, 64, [15, 47, 1007]), (5, 1, 256, None, 64, [31, 0, 15]),
])
def test_kernel_matches_plain_versions(cuda, dtype, W, G, D, window, n,
                                       lengths):
    gen = torch.Generator().manual_seed(W * 100 + G * 10 + D + n)
    Hkv = 2
    q, kp, vp, tables, lengths = _case(
        gen, B=3, W=W, Hq=G * Hkv, Hkv=Hkv, D=D, ps=16, n=n,
        dtype=getattr(torch, dtype), device=cuda, lengths=lengths,
    )
    args = dict(page_tables=tables, lengths=lengths, window=window)
    before = paged_attention.launches
    out = paged_attention(q, kp, vp, **args)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    for impl in ("stream", "gather"):
        ref = paged_attention(q, kp, vp, impl=impl, **args).float()
        assert paged_attention.launches == before + 1  # plain: not counted
        tol = RTOL[dtype] * ref.abs().max().item()
        assert (out.float() - ref).abs().max().item() <= tol, impl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernel_is_deterministic(cuda, dtype):
    """The splits' carries merge in split order (no atomics), so two
    launches on the same inputs give the same bits: GQA, W = 5, many
    splits, a window."""
    gen = torch.Generator().manual_seed(14)
    q, kp, vp, tables, lengths = _case(
        gen, B=4, W=5, Hq=8, Hkv=2, D=128, ps=16, n=64,
        dtype=getattr(torch, dtype), device=cuda,
    )
    args = dict(page_tables=tables, lengths=lengths, window=300)
    first = paged_attention(q, kp, vp, **args)
    second = paged_attention(q, kp, vp, **args)
    assert torch.equal(first, second)


def test_kernel_refuses_what_it_does_not_take(cuda):
    gen = torch.Generator().manual_seed(0)
    q, kp, vp, tables, lengths = _case(
        gen, B=2, W=1, Hq=4, Hkv=2, D=48, ps=16, n=2,
        dtype=torch.float32, device=cuda,
    )
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention(q, kp, vp, page_tables=tables, lengths=lengths)
    q, kp, vp, tables, lengths = _case(
        gen, B=2, W=1, Hq=4, Hkv=2, D=64, ps=16, n=2,
        dtype=torch.float16, device=cuda,
    )
    with pytest.raises(ValueError, match="bfloat16"):
        paged_attention(q, kp, vp, page_tables=tables, lengths=lengths)


def test_engine_on_cuda_matches_generate(cuda):
    """A small f32 Llama on the card (head_dim 64: the kernel takes 64,
    128 and 256): engine streams equal solo generate, and the kernel
    launched once per layer per decode tick."""
    cfg = dataclasses.replace(
        LlamaConfig.tiny(), hidden_size=128, num_heads=2, num_kv_heads=1
    )
    model = LlamaForCausalLM(cfg, device=cuda, policy=Policy.full())
    model.init_weights(torch.Generator(device=cuda).manual_seed(0), std=0.1)
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(1, cfg.vocab_size, size=p), n)
            for p, n in ((5, 6), (17, 9), (30, 4), (3, 12))]
    engine = ServeEngine(model, EngineConfig(
        num_slots=3, max_len=64, prefill_chunk=8, page_size=8,
    ))
    paged_attention.launches = 0
    handles = [engine.submit(r) for r in reqs]
    engine.run_until_drained()
    assert paged_attention.launches == engine.decode_ticks * cfg.num_layers
    for r, h in zip(reqs, handles):
        ref = generate(model, r.prompt_ids[None],
                       max_new_tokens=r.max_new_tokens)
        assert h.tokens == ref[0, r.prompt_len:].tolist()


# --------------------------------------------------------------------------
# flash attention (csrc/flash_attention.cu) against its plain versions
# --------------------------------------------------------------------------

from pytorch_distributed_tpu_torch.ops import flash_attention as fa  # noqa: E402

# kernel vs plain, two limits per tensor (as in chip_smoke.py): "norm" on
# ||got - ref|| / ||ref||, which a kernel wrong on any sizeable share of
# rows or keys fails, and "max" on max|got - ref| / max|ref|, which one
# wrong entry near the top fails. f32: the sums run in another order
# (64-key tiles, one FMA chain per dot product) than the plain einsums, a
# few ulp of the largest term; the gradients sum up to 2 * S products
# with cancellation, so they get 5x that. bf16: both round P (forward)
# or dS (backward) to bf16 at the same points, but from f32 values that
# already differ by those ulps, so an entry can land one bf16 step apart
# (at most 2^-7 of itself) while most agree; the forward rounds P against
# a running maximum that the kernel updates every 64 keys and the plain
# version every 128, while the backward recomputes P from the same lse on
# both sides, so its entries differ more rarely than the forward's
# (readings on an H100 in chip_smoke.py's FLASH_TOL).
FLASH_TOL = {
    "float32": {"out": dict(max=1e-5, norm=1e-5),
                "grad": dict(max=5e-5, norm=1e-5)},
    "bfloat16": {"out": dict(max=1e-2, norm=5e-3),
                 "grad": dict(max=1e-2, norm=1e-3)},
    # fp16 rounds at the same points with 3 more mantissa bits; H100
    # readings over these cases (tensor-core kernels): max 5.2e-4 (out,
    # segments_straddle) and 5.1e-4 (dk, GQA at D=128); norm 2.0e-4 (out)
    # and 1.2e-4 (dv, Llama's row)
    "float16": {"out": dict(max=2e-3, norm=1e-3),
                "grad": dict(max=2e-3, norm=5e-4)},
}

FLASH_CASES = {
    # name: (B, S, T, Hq, Hkv, D, causal, extras). bf16 runs on the tensor
    # cores: 64-row tiles of queries (fwd, dq) or keys (dkv) per CTA, 64
    # rows of the other axis streamed at a time (32 in dq and dkv at
    # D = 128) and computed 32 (fwd, dq) or 16 (dkv) at a time; f32 runs
    # on the CUDA cores in 64 x 64 tiles. The cases below cover their
    # ragged edges.
    "causal_ragged": (2, 200, 200, 4, 2, 64, True, {}),
    "full_gqa4": (2, 130, 130, 8, 2, 128, False, {}),
    "kv_mask": (3, 96, 96, 2, 2, 32, True, {"kv_mask": True}),
    "segments": (2, 256, 256, 4, 4, 64, True, {"segments": True}),
    "scale_one": (1, 64, 64, 2, 1, 16, False, {"sm_scale": 1.0}),
    "s_lt_t": (2, 100, 160, 4, 2, 64, True, {}),
    "s_gt_t": (2, 160, 100, 4, 2, 64, True, {}),
    "s_one": (3, 1, 70, 4, 2, 64, False, {}),
    "s_one_kv_mask": (2, 1, 40, 2, 1, 32, False, {"kv_mask": True}),
    "st_65_causal": (2, 65, 65, 4, 4, 64, True, {}),
    "d16_causal": (2, 77, 77, 4, 2, 16, True, {}),
    "d32_full": (2, 90, 131, 2, 2, 32, False, {}),
    "gqa4_causal": (2, 150, 150, 8, 2, 64, True, {}),
    "gqa4_causal_d128": (1, 100, 100, 8, 2, 128, True, {}),
    # segment boundaries just inside and across the 32- and 64-row tiles
    "segments_straddle": (2, 200, 200, 4, 2, 128, True,
                          {"cuts": (31, 63, 65, 130, 191)}),
    # Llama-3-8B's training rows: 32 query heads over 8 kv heads of 128,
    # causal, S = 2048, plain and packed
    "llama_train_row": (1, 2048, 2048, 32, 8, 128, True, {}),
    "llama_packed_row": (1, 2048, 2048, 32, 8, 128, True,
                         {"segments": True}),
    # BERT-base's fine-tune batch: 12 heads of 64, non-causal, a padded
    # tail per row (lengths 16-128, as padded GLUE sentences): one
    # 128-key tile per row, the padding inside it
    "bert": (32, 128, 128, 12, 12, 64, False, {"lengths": (16, 128)}),
}


def _flash_inputs(gen, B, S, T, Hq, Hkv, D, dtype, device, extras):
    kw = dict(generator=gen)
    q = torch.randn(B, S, Hq, D, **kw)
    k = torch.randn(B, T, Hkv, D, **kw)
    v = torch.randn(B, T, Hkv, D, **kw)
    bias = seg = None
    if extras.get("kv_mask") or "lengths" in extras:
        lo, hi = extras.get("lengths", (T // 3, T))
        lengths = torch.randint(lo, hi + 1, (B,), generator=gen)
        mask = torch.arange(T)[None, :] < lengths[:, None]
        bias = torch.zeros(B, T).masked_fill(~mask, fa._NEG_INF).to(device)
    if extras.get("segments"):
        seg = torch.zeros(B, S, dtype=torch.int32)
        for b in range(B):
            cuts = sorted(torch.randperm(S - 2, generator=gen)[:3].add(1)
                          .tolist())
            for i, (lo, hi) in enumerate(zip([0] + cuts, cuts + [S])):
                seg[b, lo:hi] = i + 1
        seg = seg.to(device)
    if "cuts" in extras:
        cuts = list(extras["cuts"])
        seg = torch.zeros(B, S, dtype=torch.int32)
        for i, (lo, hi) in enumerate(zip([0] + cuts, cuts + [S])):
            seg[:, lo:hi] = i + 1
        seg = seg.to(device)
    to = lambda t: t.to(device=device, dtype=dtype)  # noqa: E731
    return to(q), to(k), to(v), bias, seg


def _assert_close(out, ref, tol, what):
    """``tol``: a FLASH_TOL entry, or one number for both limits."""
    if not isinstance(tol, dict):
        tol = dict(max=tol, norm=tol)
    ref = ref.float()
    diff = out.float() - ref
    err = diff.abs().max().item()
    assert err <= tol["max"] * ref.abs().max().item(), (what, err)
    norm = (diff.norm() / ref.norm().clamp_min(1e-30)).item()
    assert norm <= tol["norm"], (what, norm)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernels_match_plain_versions(cuda, dtype, case):
    B, S, T, Hq, Hkv, D, causal, extras = FLASH_CASES[case]
    gen = torch.Generator().manual_seed(sum(map(ord, case)))
    q, k, v, bias, seg = _flash_inputs(
        gen, B, S, T, Hq, Hkv, D, getattr(torch, dtype), cuda, extras
    )
    scale = extras.get("sm_scale", 1.0 / D ** 0.5)
    kw = dict(sm_scale=scale, causal=causal)
    tol = FLASH_TOL[dtype]
    counts = (fa.flash_fwd.launches, fa.flash_dq.launches,
              fa.flash_dkv.launches)
    out, lse = fa.flash_fwd(q, k, v, bias, seg, **kw)
    ref, ref_lse = fa._flash_fwd_plain(q, k, v, bias, seg, **kw)
    torch.cuda.synchronize()
    _assert_close(out, ref, tol["out"], "out")
    _assert_close(lse, ref_lse, 1e-5, "lse")
    dout = torch.randn(out.shape, generator=gen).to(cuda, out.dtype)
    delta = fa._delta(dout, out)
    args = (q, k, v, dout, lse, delta, bias, seg)
    dq = fa.flash_dq(*args, **kw)
    dk, dv = fa.flash_dkv(*args, **kw)
    torch.cuda.synchronize()
    _assert_close(dq, fa._flash_dq_plain(*args, **kw), tol["grad"], "dq")
    rdk, rdv = fa._flash_dkv_plain(*args, **kw)
    _assert_close(dk, rdk, tol["grad"], "dk")
    _assert_close(dv, rdv, tol["grad"], "dv")
    assert (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == tuple(c + 1 for c in counts)
    for t in (out, lse, dq, dk, dv):
        assert torch.isfinite(t).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_backward_kernels_are_deterministic(cuda, dtype):
    """Each CTA owns its output tile (no atomics), so two launches on the
    same inputs give the same bits: GQA, causal, packed segments."""
    B, S, T, Hq, Hkv, D = 2, 300, 300, 8, 2, 64
    gen = torch.Generator().manual_seed(11)
    q, k, v, _, seg = _flash_inputs(gen, B, S, T, Hq, Hkv, D,
                                    getattr(torch, dtype), cuda,
                                    {"cuts": (40, 100, 170)})
    kw = dict(sm_scale=D ** -0.5, causal=True)
    out, lse = fa.flash_fwd(q, k, v, None, seg, **kw)
    dout = torch.randn(out.shape, generator=gen).to(cuda, out.dtype)
    args = (q, k, v, dout, lse, fa._delta(dout, out), None, seg)
    first = (fa.flash_dq(*args, **kw),) + fa.flash_dkv(*args, **kw)
    second = (fa.flash_dq(*args, **kw),) + fa.flash_dkv(*args, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_forward_kernel_is_deterministic(cuda, dtype):
    """Each CTA owns its q tile, so two forward launches on the same
    inputs give the same bits: GQA, causal, packed segments."""
    B, S, T, Hq, Hkv, D = 2, 300, 300, 8, 2, 64
    gen = torch.Generator().manual_seed(12)
    q, k, v, _, seg = _flash_inputs(gen, B, S, T, Hq, Hkv, D,
                                    getattr(torch, dtype), cuda,
                                    {"cuts": (40, 100, 170)})
    kw = dict(sm_scale=D ** -0.5, causal=True)
    first = fa.flash_fwd(q, k, v, None, seg, **kw)
    second = fa.flash_fwd(q, k, v, None, seg, **kw)
    for name, a, b in zip(("out", "lse"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_forward_with_a_fully_masked_row(cuda, dtype, causal):
    """A kv_mask that hides every key of one batch row: that row's
    output is undefined (as in the JAX package) but finite, and so is its
    lse (-1e30 + log l); the other rows match the plain version."""
    B, S, T, Hq, Hkv, D = 3, 100, 100, 4, 2, 64
    gen = torch.Generator().manual_seed(13)
    q, k, v, _, _ = _flash_inputs(gen, B, S, T, Hq, Hkv, D,
                                  getattr(torch, dtype), cuda, {})
    keep = torch.ones(B, T, dtype=torch.bool)
    keep[1] = False
    keep[2, 70:] = False
    bias = torch.zeros(B, T).masked_fill(~keep, fa._NEG_INF).to(cuda)
    kw = dict(sm_scale=D ** -0.5, causal=causal)
    out, lse = fa.flash_fwd(q, k, v, bias, None, **kw)
    ref, ref_lse = fa._flash_fwd_plain(q, k, v, bias, None, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    rows = torch.tensor([0, 2])
    _assert_close(out[rows], ref[rows], FLASH_TOL[dtype]["out"], "out")
    _assert_close(lse[rows], ref_lse[rows], 1e-5, "lse")


def test_flash_autograd_on_strided_qkv(cuda):
    """q, k, v as strided views of one fused projection (GPT-2's layout)
    through flash_attention's autograd: one launch of each kernel, and
    the gradients of the plain path."""
    gen = torch.Generator().manual_seed(5)
    B, S, H, D = 2, 150, 4, 64
    qkv = torch.randn(B, S, 3, H, D, generator=gen).to(cuda, torch.float32)
    outs = {}
    for impl in (None, "plain"):
        x = qkv.clone().requires_grad_()
        before = fa.flash_fwd.launches, fa.flash_dq.launches
        out = fa.flash_attention(x[:, :, 0], x[:, :, 1], x[:, :, 2],
                                 causal=True, impl=impl)
        (out.square().sum()).backward()
        after = fa.flash_fwd.launches, fa.flash_dq.launches
        assert after == (tuple(b + 1 for b in before) if impl is None
                         else before)
        outs[impl] = (out.detach(), x.grad)
    _assert_close(outs[None][0], outs["plain"][0], 1e-5, "out")
    _assert_close(outs[None][1], outs["plain"][1], 5e-5, "grad")


def test_flash_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q, q, q, sm_scale=1.0, causal=True)
    h = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="float16"):
        fa.flash_fwd(h, h, h, sm_scale=1.0, causal=True)


def test_gpt2_step_flash_matches_einsum_on_cuda(cuda):
    """One f32 training step of a small GPT-2 (head_dim 64) with the
    flash kernels and one with the einsum attention, dropout off: the
    losses agree to 1e-5 and every parameter's (clipped) gradient to 1e-4
    of its largest magnitude (sums in another order). The key bias is
    left out: its gradient is zero in exact arithmetic, so both sides
    hold rounding noise. Parameters after the Adam step are not compared:
    Adam divides by |g| + 1e-8, so an entry whose gradient is near 1e-8
    turns a 1e-12 rounding difference into a step difference of lr / 40
    (measured on an H100: 2e-5 in ``wte`` at lr 1e-3)."""
    from pytorch_distributed_tpu_torch import (
        GPT2Config, GPT2LMHead, TrainState, build_train_step,
        causal_lm_loss_fn, optim,
    )

    cfg = dataclasses.replace(GPT2Config.tiny(), hidden_size=128,
                              num_heads=2, dropout_rate=0.0)
    ids = torch.randint(0, cfg.vocab_size, (4, 64),
                        generator=torch.Generator().manual_seed(1)).to(cuda)
    results = []
    for impl in (None, "xla"):
        model = GPT2LMHead(cfg, device=cuda, policy=Policy.full())
        model.init_weights(torch.Generator(device=cuda).manual_seed(0))
        opt = optim.clip_grad_norm(optim.AdamW(model, lr=1e-3), 1.0)
        step = build_train_step(causal_lm_loss_fn(model, attn_impl=impl),
                                accum_steps=2)
        fwd = fa.flash_fwd.launches
        state, metrics = step(TrainState(model, opt), {"input_ids": ids})
        launched = fa.flash_fwd.launches - fwd
        assert launched == (cfg.num_layers * 2 if impl is None else 0)
        D = cfg.hidden_size
        grads = {n: p.grad for n, p in model.named_parameters()}
        for n, g in grads.items():
            if n.endswith("attn_qkv.bias"):
                grads[n] = torch.cat([g[:D], g[2 * D:]])
        results.append((float(metrics["loss"]), grads))
    assert abs(results[0][0] - results[1][0]) <= 1e-5 * abs(results[1][0])
    for n, g in results[0][1].items():
        _assert_close(g, results[1][1][n], 1e-4, n)


def test_llama_step_flash_matches_einsum_on_cuda(cuda):
    """One f32 step of a small Llama at Llama-3-8B's head shape (head_dim
    128, 4 query heads per kv head), full remat, the chunked loss, with
    the flash kernels and with the einsum attention: the losses agree to
    1e-5 and every gradient to 1e-4 of its largest magnitude (sums in
    another order). Under remat the forward kernel runs twice per layer,
    dq and dkv once."""
    from pytorch_distributed_tpu_torch import causal_lm_loss_fn

    cfg = dataclasses.replace(
        LlamaConfig.tiny(), hidden_size=512, num_heads=4, num_kv_heads=1,
        intermediate_size=1024, max_seq_len=512, remat=True)
    ids = torch.randint(0, cfg.vocab_size, (2, 256),
                        generator=torch.Generator().manual_seed(3)).to(cuda)
    results = []
    for impl in (None, "xla"):
        model = LlamaForCausalLM(cfg, device=cuda, policy=Policy.full())
        model.init_weights(torch.Generator(device=cuda).manual_seed(0))
        before = (fa.flash_fwd.launches, fa.flash_dq.launches,
                  fa.flash_dkv.launches)
        loss, _ = causal_lm_loss_fn(model, vocab_chunk_size=200,
                                    attn_impl=impl)({"input_ids": ids}, None)
        loss.backward()
        torch.cuda.synchronize()
        launched = tuple(n - b for n, b in zip(
            (fa.flash_fwd.launches, fa.flash_dq.launches,
             fa.flash_dkv.launches), before))
        L = cfg.num_layers
        assert launched == ((2 * L, L, L) if impl is None else (0, 0, 0))
        results.append((loss.item(), {n: p.grad for n, p in
                                      model.named_parameters()}))
    assert abs(results[0][0] - results[1][0]) <= 1e-5 * abs(results[1][0])
    for n, g in results[0][1].items():
        _assert_close(g, results[1][1][n], 1e-4, n)


@pytest.mark.parametrize("policy", ["full", "fp16"])
def test_bert_step_flash_matches_einsum_on_cuda(cuda, policy):
    """One step's loss and gradients of a small BERT classifier at
    BERT-base's head shape (head_dim 64, non-causal) on a ragged padded
    batch, with the flash kernels and with the einsum attention, dropout
    off. f32 (``Policy.full()``, the CUDA-core kernels): the loss to
    1e-5 and every gradient to 1e-4 of its largest magnitude (sums in
    another order). fp16 (``Policy.fp16()``, the tensor-core kernels):
    the kernels round P and dS to fp16 where the einsum path keeps f32,
    so the loss to 1e-3 and each gradient to 2e-2 of its norm
    (||flash - einsum|| / ||einsum||), the GPT-2 smoke's q/k/v limit. The
    key bias is left out: its gradient is zero in exact arithmetic. Each
    flash kernel launches once a layer."""
    from pytorch_distributed_tpu_torch.models.bert import (
        BertConfig,
        BertForSequenceClassification,
    )
    from pytorch_distributed_tpu_torch.train import (
        text_classification_loss_fn,
    )

    pol = Policy.full() if policy == "full" else Policy.fp16()
    cfg = dataclasses.replace(BertConfig.tiny(), hidden_size=256,
                              num_heads=4, intermediate_size=512,
                              dropout_rate=0.0)
    gen = torch.Generator().manual_seed(4)
    B, S = 8, 128
    lengths = torch.randint(16, S + 1, (B,), generator=gen)
    mask = torch.arange(S)[None, :] < lengths[:, None]
    batch = {"input_ids": torch.randint(0, cfg.vocab_size, (B, S),
                                        generator=gen).to(cuda),
             "attention_mask": mask.to(cuda),
             "label": torch.randint(0, 2, (B,), generator=gen).to(cuda)}
    results = []
    for impl in (None, "xla"):
        model = BertForSequenceClassification(cfg, device=cuda, policy=pol)
        model.init_weights(torch.Generator(device=cuda).manual_seed(0))
        before = (fa.flash_fwd.launches, fa.flash_dq.launches,
                  fa.flash_dkv.launches)
        loss, _ = text_classification_loss_fn(model, attn_impl=impl)(
            batch, None)
        loss.backward()
        torch.cuda.synchronize()
        launched = tuple(n - b for n, b in zip(
            (fa.flash_fwd.launches, fa.flash_dq.launches,
             fa.flash_dkv.launches), before))
        L = cfg.num_layers
        assert launched == ((L, L, L) if impl is None else (0, 0, 0))
        results.append((loss.item(), {n: p.grad for n, p in
                                      model.named_parameters()}))
    loss_rtol = 1e-5 if policy == "full" else 1e-3
    assert abs(results[0][0] - results[1][0]) <= loss_rtol * abs(
        results[1][0])
    for n, g in results[0][1].items():
        if n.endswith("attn.key.bias"):
            continue
        ref = results[1][1][n]
        if policy == "full":
            _assert_close(g, ref, 1e-4, n)
        else:
            err = ((g.float() - ref.float()).norm()
                   / ref.float().norm().clamp_min(1e-30)).item()
            assert err <= 2e-2, (n, err)


def test_lora_step_flash_launches_on_cuda(cuda):
    """One LoRA step of a small BERT classifier (``Policy.full()``, the
    CUDA-core kernels, dropout off) with the flash kernels and with the
    einsum attention: each flash kernel launches once a layer with the
    base frozen (dq and dkv run for the q/k/v adapters alone), the base
    gets no gradient, and the adapters' gradients agree to 1e-4 of their
    largest magnitude (sums in another order)."""
    from pytorch_distributed_tpu_torch import LoRAModel
    from pytorch_distributed_tpu_torch.models.bert import (
        BertConfig,
        BertForSequenceClassification,
    )
    from pytorch_distributed_tpu_torch.train import (
        text_classification_loss_fn,
    )

    cfg = dataclasses.replace(BertConfig.tiny(), hidden_size=256,
                              num_heads=4, intermediate_size=512,
                              dropout_rate=0.0)
    gen = torch.Generator().manual_seed(5)
    B, S = 8, 128
    lengths = torch.randint(16, S + 1, (B,), generator=gen)
    batch = {"input_ids": torch.randint(0, cfg.vocab_size, (B, S),
                                        generator=gen).to(cuda),
             "attention_mask": (torch.arange(S)[None, :]
                                < lengths[:, None]).to(cuda),
             "label": torch.randint(0, 2, (B,), generator=gen).to(cuda)}
    grads = []
    for impl in (None, "xla"):
        base = BertForSequenceClassification(cfg, device=cuda,
                                             policy=Policy.full())
        base.init_weights(torch.Generator(device=cuda).manual_seed(0))
        model = LoRAModel(base, rank=4, generator=torch.Generator(
            device=cuda).manual_seed(1))
        for ab in model.adapters().values():
            with torch.no_grad():
                ab["b"].normal_(0, 0.05, generator=torch.Generator(
                    device=cuda).manual_seed(2))
        before = (fa.flash_fwd.launches, fa.flash_dq.launches,
                  fa.flash_dkv.launches)
        loss, _ = text_classification_loss_fn(model, attn_impl=impl)(
            batch, None)
        loss.backward()
        torch.cuda.synchronize()
        launched = tuple(n - b for n, b in zip(
            (fa.flash_fwd.launches, fa.flash_dq.launches,
             fa.flash_dkv.launches), before))
        L = cfg.num_layers
        assert launched == ((L, L, L) if impl is None else (0, 0, 0))
        assert all(p.grad is None for p in base.parameters()
                   if not p.requires_grad)
        grads.append({n: p.grad for n, p in model.named_parameters()
                      if p.requires_grad})
    assert grads[0].keys() == grads[1].keys() and grads[0]
    for n, g in grads[0].items():
        _assert_close(g, grads[1][n], 1e-4, n)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_decode_residency_on_cuda(cuda, kind):
    """A bf16 Llama (width 1024, 4 layers) through ``QuantizedModel``
    with ``quantize_for_scan_dequant``'s tree: the resident weights are
    ``quantized_bytes`` exactly, the decode's peak above them stays under
    one layer's bf16 weights (plus an f32 copy of the largest one, the
    transient of its dequantization), the cache and the logits, and the
    greedy tokens equal those of the same model with the dequantized
    weights loaded as plain bf16 (the same products on the same
    weights)."""
    from pytorch_distributed_tpu_torch.ops import (
        QuantizedModel,
        dequantize_tree,
        quantize_for_scan_dequant,
        quantized_bytes,
    )
    from pytorch_distributed_tpu_torch.ops.attention import cache_bytes

    cfg = LlamaConfig(vocab_size=4096, hidden_size=1024, num_layers=4,
                      num_heads=8, num_kv_heads=2, intermediate_size=3584,
                      max_seq_len=256)

    def build():
        m = LlamaForCausalLM(cfg, device=cuda)
        return m.init_weights(torch.Generator(device=cuda).manual_seed(0))

    tree = quantize_for_scan_dequant(build(), kind)
    plain = build()
    plain.load_state_dict(dequantize_tree(tree, torch.bfloat16))
    ids = torch.randint(1, cfg.vocab_size, (4, 64), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    want = generate(plain, ids, max_new_tokens=8)
    layer = sum(p.numel() * 2 for p in plain.layers[0].parameters())
    largest = max(p.numel() for p in plain.layers[0].parameters())
    cache = cache_bytes(plain.init_cache(4, 72))
    del plain
    qm = QuantizedModel(build(), tree, dtype=torch.bfloat16)
    resident = sum(t.numel() * t.element_size()
                   for t in list(qm.parameters()) + list(qm.buffers()))
    assert resident == quantized_bytes(tree)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    got = generate(qm, ids, max_new_tokens=8)
    peak = torch.cuda.max_memory_allocated(cuda) - base
    logits = 3 * 4 * 64 * cfg.vocab_size * 4
    assert peak <= layer + 4 * largest + cache + logits, (peak, layer)
    assert torch.equal(got, want)
