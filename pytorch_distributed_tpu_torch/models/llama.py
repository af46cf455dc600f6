"""Llama-3 in PyTorch: the port of ``pytorch_distributed_tpu/models/llama.py``.

Decoder with RMSNorm, rotary positions (theta 500k), grouped-query
attention (32 q / 8 kv heads at 8B) and a SwiGLU MLP. The layers are an
``nn.ModuleList`` (the JAX package scans one stacked block), and the
per-layer KV cache is an explicit argument and return value of
``forward`` (the JAX package keeps it in flax's ``cache`` collection).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_tpu_torch.ops.attention import (
    apply_rope,
    attention,
    decode_cache,
    rope_frequencies,
    validate_write_pos,
)
from pytorch_distributed_tpu_torch.ops.paged_attention import PagedView
from pytorch_distributed_tpu_torch.runtime.device import (
    DeviceLike,
    resolve_device,
)
from pytorch_distributed_tpu_torch.runtime.precision import Policy

#: per-layer (k, v) buffers: dense [B, T, Hkv, D] or a page pool
KVCache = List[Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Context-window extension for RoPE: ``type`` "linear" (position
    interpolation) or "llama3" (HF Llama-3.1 frequency-dependent
    scheme)."""

    type: str = "llama3"
    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8_192


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    hidden_size: int = 4_096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    intermediate_size: int = 14_336
    max_seq_len: int = 8_192
    rope_theta: float = 500_000.0
    rms_eps: float = 1e-5
    # position i sees keys in (i - window, i] only; None = full causal
    sliding_window: Optional[int] = None
    rope_scaling: Optional[RopeScaling] = None
    # "int8" KV caches are not ported: the kernel takes fp pools only
    kv_cache_quantize: Optional[str] = None

    def __post_init__(self):
        if self.kv_cache_quantize not in (None, "int8"):
            raise ValueError(
                f"kv_cache_quantize must be None or 'int8', got "
                f"{self.kv_cache_quantize!r}"
            )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        return cls(
            vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=128, max_seq_len=128,
        )


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, *, device, dtype):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x):
        x32 = x.float()
        rms = torch.sqrt(x32.square().mean(dim=-1, keepdim=True) + self.eps)
        return (x32 / rms * self.weight.float()).to(x.dtype)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        D, hd = cfg.hidden_size, cfg.head_dim
        lin = lambda i, o: nn.Linear(  # noqa: E731
            i, o, bias=False, device=device, dtype=dtype
        )
        self.attn_norm = RMSNorm(D, cfg.rms_eps, device=device, dtype=dtype)
        self.q = lin(D, cfg.num_heads * hd)
        self.k = lin(D, cfg.num_kv_heads * hd)
        self.v = lin(D, cfg.num_kv_heads * hd)
        self.o = lin(cfg.num_heads * hd, D)
        self.mlp_norm = RMSNorm(D, cfg.rms_eps, device=device, dtype=dtype)
        self.gate = lin(D, cfg.intermediate_size)
        self.up = lin(D, cfg.intermediate_size)
        self.down = lin(cfg.intermediate_size, D)

    def forward(self, x, cos, sin, positions, layer_cache, write_pos,
                paged: Optional[PagedView], attn_impl: Optional[str] = None):
        cfg = self.cfg
        B, S, _ = x.shape
        hd = cfg.head_dim
        h = self.attn_norm(x)
        q = self.q(h).view(B, S, cfg.num_heads, hd)
        k = self.k(h).view(B, S, cfg.num_kv_heads, hd)
        v = self.v(h).view(B, S, cfg.num_kv_heads, hd)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        offset = 0
        if layer_cache is not None:
            k, v, offset = decode_cache(
                layer_cache, k, v, write_pos=write_pos, paged=paged
            )
        attn = attention(
            q, k, v, causal=True, q_offset=offset,
            window=cfg.sliding_window, paged=paged, impl=attn_impl,
        )
        x = x + self.o(attn.reshape(B, S, cfg.num_heads * hd))
        h = self.mlp_norm(x)
        return x + self.down(F.silu(self.gate(h)) * self.up(h))


class LlamaForCausalLM(nn.Module):
    """Returns [B, S, vocab] logits (and the cache when decoding).
    Untied LM head (the Llama-3 layout)."""

    def __init__(self, config: LlamaConfig, *, device: DeviceLike = None,
                 policy: Policy = Policy()):
        super().__init__()
        if config.kv_cache_quantize is not None:
            raise NotImplementedError(
                "int8 KV caches are not ported (the paged-attention kernel "
                "takes fp pools only; see ROADMAP)"
            )
        if policy.param_dtype != policy.compute_dtype:
            raise ValueError(
                "the port keeps weights in the compute dtype: policy "
                f"param_dtype {policy.param_dtype} != compute_dtype "
                f"{policy.compute_dtype}"
            )
        device = resolve_device(device)
        self.config = config
        self.policy = policy
        dt = policy.param_dtype
        self.embed = nn.Embedding(
            config.vocab_size, config.hidden_size, device=device, dtype=dt
        )
        self.layers = nn.ModuleList(
            LlamaBlock(config, device=device, dtype=dt)
            for _ in range(config.num_layers)
        )
        self.final_norm = RMSNorm(
            config.hidden_size, config.rms_eps, device=device, dtype=dt
        )
        self.lm_head = nn.Linear(
            config.hidden_size, config.vocab_size, bias=False,
            device=device, dtype=dt,
        )
        self._rope: dict = {}

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02):
        """Seeded random weights: every matrix normal(0, std), norms one."""
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(
                    p.shape, generator=generator, device=p.device,
                    dtype=torch.float32,
                ).mul_(std))
        return self

    def init_cache(self, batch: int, length: int) -> KVCache:
        """Zeroed per-layer (k, v) buffers [batch, length, Hkv, D] in the
        compute dtype. The serving pool calls it with batch = page frames
        and length = page size."""
        cfg = self.config
        shape = (batch, length, cfg.num_kv_heads, cfg.head_dim)
        kw = dict(device=self.device, dtype=self.policy.compute_dtype)
        return [
            (torch.zeros(shape, **kw), torch.zeros(shape, **kw))
            for _ in range(cfg.num_layers)
        ]

    def _rope_tables(self, length: int):
        tabs = self._rope.get(length)
        if tabs is None:
            cfg = self.config
            tabs = rope_frequencies(
                cfg.head_dim, length, cfg.rope_theta,
                scaling=cfg.rope_scaling, device=self.device,
            )
            self._rope[length] = tabs
        return tabs

    def forward(
        self,
        input_ids: torch.Tensor,
        positions: Optional[torch.Tensor] = None,
        *,
        cache: Optional[KVCache] = None,
        write_pos: Optional[torch.Tensor] = None,
        decode: bool = False,
        cache_len: Optional[int] = None,
        paged: Optional[PagedView] = None,
        attn_impl: Optional[str] = None,
    ):
        """``decode=False``: a plain causal pass, returns logits.

        ``decode=True``: per-row KV-cache decode, returns
        ``(logits, cache)``. ``write_pos`` [B] and ``positions`` [B, S]
        are required; ``cache`` defaults to zeroed ``[B, cache_len]``
        buffers; with ``paged`` the cache is the page pool and attention
        streams it through the paged-attention kernel.

        ``attn_impl`` is passed to every layer's ``attention`` call
        (``None``: flash on the card where it applies, ``"flash"`` or
        ``"xla"`` to force one).
        """
        cfg = self.config
        B, S = input_ids.shape
        if cache_len is not None and cache_len > cfg.max_seq_len:
            raise ValueError(
                f"cache_len {cache_len} > max_seq_len {cfg.max_seq_len}"
            )
        validate_write_pos(write_pos, decode, positions)
        if decode and write_pos is None:
            raise ValueError("decode=True needs write_pos and positions")
        if not decode and (cache is not None or paged is not None):
            raise ValueError("a cache or paged view needs decode=True")
        x = self.embed(input_ids).to(self.policy.compute_dtype)
        if decode:
            table_len = cache_len or cfg.max_seq_len
            if cache is None:
                cache = self.init_cache(B, table_len)
        elif positions is None:
            table_len = S
        else:
            table_len = cfg.max_seq_len
        cos, sin = self._rope_tables(table_len)
        for i, layer in enumerate(self.layers):
            x = layer(
                x, cos, sin, positions,
                cache[i] if decode else None, write_pos, paged,
                attn_impl=attn_impl,
            )
        logits = self.lm_head(self.final_norm(x)).to(self.policy.output_dtype)
        return (logits, cache) if decode else logits
