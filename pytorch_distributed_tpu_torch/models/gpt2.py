"""GPT-2 in PyTorch: the port of ``pytorch_distributed_tpu/models/gpt2.py``.

Pre-LN decoder with learned positions and a weight-tied LM head (logits
through the transposed token embedding). The layers are an
``nn.ModuleList`` (the JAX package scans one stacked block), causal
self-attention goes through ``ops.attention.attention`` (the flash
kernels on the card), and packed rows carry ``segment_ids`` and
per-document ``positions``.

The dtype policy works as flax's ``dtype``/``param_dtype`` pair does:
parameters live in ``policy.param_dtype`` and every product casts them
to ``policy.compute_dtype``; LayerNorm takes its statistics in f32 and
returns the compute dtype; the tied head multiplies in the compute dtype
and returns f32 logits. Dropout (residuals and embeddings only, never
the attention weights) draws its masks from the ``generator`` the
caller passes, so a step's masks depend on its seed alone. With
``config.remat`` each block runs under ``torch.utils.checkpoint``
(``models/scan.py``), its generator replayed in the recompute.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_tpu_torch.models.scan import remat_call
from pytorch_distributed_tpu_torch.ops.attention import (
    attention,
    decode_cache,
    init_layer_cache,
    validate_write_pos,
)
from pytorch_distributed_tpu_torch.runtime.device import (
    DeviceLike,
    resolve_device,
)
from pytorch_distributed_tpu_torch.runtime.precision import Policy

# flax's truncated_normal draws in [-2, 2] and divides by the std of that
# truncated unit normal, so the kept draws have the asked-for variance
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50_257
    n_positions: int = 1_024
    hidden_size: int = 1_024
    num_layers: int = 24
    num_heads: int = 16
    dropout_rate: float = 0.1
    layer_norm_eps: float = 1e-5
    # recompute each block's activations in the backward (models/scan.py)
    remat: bool = False
    remat_policy: str = "full"  # full | dots | dots_no_batch
    # > 0 turns every FFN into a mixture of experts: not ported
    moe_experts: int = 0
    # "int8" rests the decode KV cache (dense or paged) quantized
    # (ops/attention.py; lossy); None = exact
    kv_cache_quantize: Optional[str] = None

    def __post_init__(self):
        if self.kv_cache_quantize not in (None, "int8"):
            raise ValueError(
                f"kv_cache_quantize must be None or 'int8', got "
                f"{self.kv_cache_quantize!r}"
            )

    @property
    def intermediate_size(self) -> int:
        return 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def medium(cls) -> "GPT2Config":  # the recipe's size (355M params)
        return cls()

    @classmethod
    def small(cls) -> "GPT2Config":
        return cls(hidden_size=768, num_layers=12, num_heads=12)

    @classmethod
    def tiny(cls) -> "GPT2Config":
        return cls(
            vocab_size=512, n_positions=64, hidden_size=64, num_layers=2,
            num_heads=4,
        )


class Dense(nn.Module):
    """``y = x W^T + b``: W ``[out, in]`` and b kept in the policy's
    param dtype, both cast to its compute dtype for the product."""

    def __init__(self, in_features: int, out_features: int, *,
                 policy: Policy, device):
        super().__init__()
        kw = dict(device=device, dtype=policy.param_dtype)
        self.weight = nn.Parameter(torch.empty(out_features, in_features, **kw))
        self.bias = nn.Parameter(torch.zeros(out_features, **kw))
        self.compute_dtype = policy.compute_dtype

    def forward(self, x):
        cd = self.compute_dtype
        return F.linear(x.to(cd), self.weight.to(cd), self.bias.to(cd))


class LayerNorm(nn.Module):
    """LayerNorm with f32 statistics (flax's, at any dtype); returns the
    compute dtype."""

    def __init__(self, dim: int, eps: float, *, policy: Policy, device):
        super().__init__()
        kw = dict(device=device, dtype=policy.param_dtype)
        self.weight = nn.Parameter(torch.ones(dim, **kw))
        self.bias = nn.Parameter(torch.zeros(dim, **kw))
        self.eps = eps
        self.compute_dtype = policy.compute_dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


def dropout(x, rate: float, train: bool, generator):
    """Inverted dropout with a mask drawn from ``generator``: kept entries
    are divided by ``1 - rate`` (flax's ``nn.Dropout``)."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError(
            "train=True with dropout needs a generator (see "
            "runtime.prng.generator_for)"
        )
    keep = torch.empty(x.shape, device=x.device, dtype=x.dtype)
    keep.bernoulli_(1.0 - rate, generator=generator)
    return torch.where(keep.bool(), x / (1.0 - rate), torch.zeros_like(x))


class _F32Logits(torch.autograd.Function):
    """``x [N, D] @ w [V, D]^T`` with both in the compute dtype and f32
    output: the JAX head's einsum with ``preferred_element_type=f32``.
    The backward multiplies in the compute dtype too."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_cuda:
            return torch.mm(x, w.t(), out_dtype=torch.float32)
        return torch.mm(x.float(), w.float().t())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w, g.t() @ x


def tied_logits(x, wte, compute_dtype):
    """[B, S, D] hidden -> [B, S, V] f32 logits through the tied
    embedding, multiplied in ``compute_dtype``."""
    B, S, D = x.shape
    x = x.to(compute_dtype).reshape(B * S, D)
    w = wte.to(compute_dtype)
    if compute_dtype == torch.float32:
        logits = x @ w.t()
    else:
        logits = _F32Logits.apply(x, w)
    return logits.reshape(B, S, -1)


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config, *, policy: Policy, device):
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden_size
        kw = dict(policy=policy, device=device)
        self.ln1 = LayerNorm(D, cfg.layer_norm_eps, **kw)
        self.attn_qkv = Dense(D, 3 * D, **kw)  # out = (3, heads, head_dim)
        self.attn_out = Dense(D, D, **kw)      # in = (heads, head_dim)
        self.ln2 = LayerNorm(D, cfg.layer_norm_eps, **kw)
        self.mlp_up = Dense(D, cfg.intermediate_size, **kw)
        self.mlp_down = Dense(cfg.intermediate_size, D, **kw)

    def forward(self, x, segment_ids, *, train: bool, generator,
                attn_impl: Optional[str] = None, layer_cache=None,
                write_pos=None, kv_mask=None, paged=None):
        cfg = self.cfg
        B, S, D = x.shape
        H, hd = cfg.num_heads, cfg.head_dim
        qkv = self.attn_qkv(self.ln1(x)).view(B, S, 3, H, hd)
        # strided views of one tensor: the flash kernels read them in place
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if layer_cache is not None:
            k, v, offset = decode_cache(layer_cache, k, v,
                                        write_pos=write_pos, paged=paged)
            attn = attention(q, k, v, causal=True, q_offset=offset,
                             mask=kv_mask, paged=paged, impl=attn_impl)
        else:
            attn = attention(
                q, k, v, causal=True, segment_ids=segment_ids,
                impl=attn_impl
            )
        attn = self.attn_out(attn.reshape(B, S, D))
        x = x + dropout(attn, cfg.dropout_rate, train, generator)
        h = F.gelu(self.mlp_up(self.ln2(x)), approximate="tanh")
        h = self.mlp_down(h)
        return x + dropout(h, cfg.dropout_rate, train, generator)


class GPT2LMHead(nn.Module):
    """Causal LM: returns [B, S, vocab] logits (head tied to ``wte``) in
    the policy's output dtype, or the final hidden states with
    ``return_hidden=True``."""

    def __init__(self, config: GPT2Config, *, device: DeviceLike = None,
                 policy: Policy = Policy()):
        super().__init__()
        if config.moe_experts > 0:
            raise NotImplementedError(
                "mixture-of-experts FFNs are not ported (ROADMAP A10)"
            )
        device = resolve_device(device)
        self.config = config
        self.policy = policy
        D = config.hidden_size
        kw = dict(device=device, dtype=policy.param_dtype)
        self.wte = nn.Embedding(config.vocab_size, D, **kw)
        self.wpe = nn.Embedding(config.n_positions, D, **kw)
        self.blocks = nn.ModuleList(
            GPT2Block(config, policy=policy, device=device)
            for _ in range(config.num_layers)
        )
        self.ln_f = LayerNorm(D, config.layer_norm_eps, policy=policy,
                              device=device)

    @property
    def device(self) -> torch.device:
        return self.ln_f.weight.device

    def init_cache(self, batch: int, length: int):
        """Zeroed per-layer dense caches ``[batch, length, H, hd]`` in the
        compute dtype (int8 payloads and f32 scales with
        ``kv_cache_quantize="int8"``)."""
        cfg = self.config
        return [
            init_layer_cache(batch, length, cfg.num_heads, cfg.head_dim,
                             dtype=self.policy.compute_dtype,
                             device=self.device,
                             quantize=cfg.kv_cache_quantize)
            for _ in range(cfg.num_layers)
        ]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Seeded weights drawn as flax's initializers draw them: every
        Dense kernel lecun-normal (truncated at 2 std, variance
        1/fan_in), embeddings normal with variance 1/hidden_size, biases
        zero, LayerNorm scales one."""
        D = self.config.hidden_size
        for name, p in self.named_parameters():
            if name.startswith(("wte.", "wpe.")):
                draw = torch.randn(p.shape, generator=generator,
                                   device=p.device, dtype=torch.float32)
                p.copy_(draw / math.sqrt(D))
            elif ".ln" in name or name.startswith("ln_f."):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:  # a Dense weight [out, in]
                draw = torch.empty(p.shape, device=p.device,
                                   dtype=torch.float32)
                nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                p.copy_(draw / (math.sqrt(p.shape[1]) * _TRUNC_STD))
        return self

    def forward(
        self,
        input_ids: torch.Tensor,
        positions: Optional[torch.Tensor] = None,
        *,
        segment_ids: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        decode: bool = False,
        return_hidden: bool = False,
        attn_impl: Optional[str] = None,
        cache=None,
        write_pos: Optional[torch.Tensor] = None,
        cache_len: Optional[int] = None,
        kv_mask: Optional[torch.Tensor] = None,
        paged=None,
    ):
        """``train=True`` applies dropout with masks from ``generator``;
        ``attn_impl`` is passed to every block's ``attention`` call
        (``None``: flash on the card, ``"flash"`` or ``"xla"`` to force
        one).

        ``decode=True`` is KV-cache decode, with the Llama model's
        contract: ``write_pos`` [B] and ``positions`` [B, S] are required
        (the learned ``wpe`` is looked up at exactly those positions, so
        left-padded rows count real tokens only), ``cache`` defaults to
        zeroed ``[B, cache_len]`` buffers, ``kv_mask`` [B, T] (left-padded
        prompts) is for decode only, and it returns ``(logits, cache)``.
        The attention over a dense cache is the einsum path, as in the JAX
        package (the cache offset is per row). With ``paged`` (the serving
        engine's ``PagedView``) the cache is the page pool and attention
        streams it through the paged-attention kernel, as Llama's does."""
        cfg = self.config
        B, S = input_ids.shape
        if S > cfg.n_positions:
            raise ValueError(f"sequence {S} > n_positions {cfg.n_positions}")
        if cache_len is not None and cache_len > cfg.n_positions:
            raise ValueError(
                f"cache_len {cache_len} > n_positions {cfg.n_positions}")
        if paged is not None and not decode:
            raise ValueError("a paged view needs decode=True")
        if segment_ids is not None and decode:
            raise ValueError(
                "segment_ids (packed training) and decode (KV cache) are "
                "mutually exclusive")
        if kv_mask is not None and not decode:
            raise ValueError(
                "kv_mask is for KV-cache decode (left-padded prompts); "
                "training masks go through the loss/segment machinery")
        validate_write_pos(write_pos, decode, positions)
        if decode and write_pos is None:
            raise ValueError("decode=True needs write_pos and positions")
        if not decode and cache is not None:
            raise ValueError("a cache needs decode=True")
        if decode and cache is None:
            cache = self.init_cache(B, cache_len or cfg.n_positions)
        if positions is None:
            positions = torch.arange(S, device=input_ids.device)[None, :]
        x = self.wte(input_ids) + self.wpe(positions)
        x = dropout(x, cfg.dropout_rate, train, generator)
        x = x.to(self.policy.compute_dtype)
        if decode:
            for block, layer_cache in zip(self.blocks, cache):
                x = block(x, None, train=train, generator=generator,
                          attn_impl=attn_impl, layer_cache=layer_cache,
                          write_pos=write_pos, kv_mask=kv_mask, paged=paged)
            x = self.ln_f(x)
            logits = tied_logits(x, self.wte.weight,
                                 self.policy.compute_dtype)
            return logits.to(self.policy.output_dtype), cache
        remat = cfg.remat and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                x = remat_call(block, x, segment_ids, train=train,
                               generator=generator, attn_impl=attn_impl,
                               policy=cfg.remat_policy)
            else:
                x = block(x, segment_ids, train=train, generator=generator,
                          attn_impl=attn_impl)
        x = self.ln_f(x)
        if return_hidden:
            return x.to(self.policy.output_dtype)
        logits = tied_logits(x, self.wte.weight, self.policy.compute_dtype)
        return logits.to(self.policy.output_dtype)
