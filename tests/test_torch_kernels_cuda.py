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


def _case(gen, *, B, W, Hq, Hkv, D, ps, n, dtype, device):
    """Ragged lengths (one zero), distinct live pages per row, null-page
    tails holding garbage."""
    lengths = torch.randint(0, n * ps - W + 1, (B,), generator=gen)
    lengths[0] = 0
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
@pytest.mark.parametrize("W,G,D,window", [
    (1, 4, 128, None), (5, 4, 128, None), (1, 2, 64, 7), (3, 8, 256, None),
])
def test_kernel_matches_plain_versions(cuda, dtype, W, G, D, window):
    gen = torch.Generator().manual_seed(W * 100 + G * 10 + D)
    Hkv = 2
    q, kp, vp, tables, lengths = _case(
        gen, B=3, W=W, Hq=G * Hkv, Hkv=Hkv, D=D, ps=16, n=5,
        dtype=getattr(torch, dtype), device=cuda,
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
