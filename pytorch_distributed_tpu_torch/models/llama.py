"""Llama-3 in PyTorch: the port of ``pytorch_distributed_tpu/models/llama.py``.

Decoder with RMSNorm, rotary positions (theta 500k), grouped-query
attention (32 q / 8 kv heads at 8B) and a SwiGLU MLP. The layers are an
``nn.ModuleList`` (the JAX package scans one stacked block), and the
per-layer KV cache is an explicit argument and return value of
``forward`` (the JAX package keeps it in flax's ``cache`` collection).

The dtype policy works as flax's ``dtype``/``param_dtype`` pair does:
parameters live in ``policy.param_dtype`` (f32 under
``Policy.train()``, bf16 for serving) and every product casts its weight
to ``policy.compute_dtype`` at the use; RMSNorm takes its statistics and
multiplies by its scale in f32 and returns its input's dtype; the head
multiplies in the compute dtype and the logits leave in the output
dtype. Packed training rows carry ``segment_ids`` and per-document
``positions`` (the flash kernels mask across documents). With
``config.remat`` each block recomputes its activations in the backward
(``models/scan.py``): the checkpoint sits inside the block's own
``forward``, so a block wrapped by FSDP gathers its weights once for the
forward and once for the recompute. Llama has no dropout: ``train``
changes nothing in the forward, as in the JAX model.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_tpu_torch.models.scan import remat_call
from pytorch_distributed_tpu_torch.ops.attention import (
    apply_rope,
    attention,
    decode_cache,
    init_layer_cache,
    rope_frequencies,
    validate_write_pos,
)
from pytorch_distributed_tpu_torch.ops.paged_attention import PagedView
from pytorch_distributed_tpu_torch.runtime.device import (
    DeviceLike,
    resolve_device,
)
from pytorch_distributed_tpu_torch.runtime.mesh import row_shard
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
    # "int8": the decode cache (dense or paged) rests quantized (lossy);
    # paged int8 pools attend on the gather path, not the kernel
    kv_cache_quantize: Optional[str] = None
    # recompute each block's activations in the backward (models/scan.py)
    remat: bool = False
    remat_policy: str = "full"  # full | dots | dots_no_batch

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


class Linear(nn.Linear):
    """``y = x W^T`` (no bias), W ``[out, in]`` kept in the policy's
    param dtype and cast, with x, to its compute dtype for the product
    (no copy when the two agree, as when serving)."""

    def __init__(self, in_features: int, out_features: int, *,
                 policy: Policy, device):
        super().__init__(in_features, out_features, bias=False,
                         device=device, dtype=policy.param_dtype)
        self.compute_dtype = policy.compute_dtype

    def forward(self, x):
        cd = self.compute_dtype
        return F.linear(x.to(cd), self.weight.to(cd))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device, policy: Policy):
        super().__init__()
        self.cfg = cfg
        D, hd = cfg.hidden_size, cfg.head_dim
        dtype = policy.param_dtype
        lin = lambda i, o: Linear(  # noqa: E731
            i, o, policy=policy, device=device
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
                paged: Optional[PagedView], attn_impl: Optional[str] = None,
                segment_ids=None, mask=None):
        cfg = self.cfg
        if cfg.remat and layer_cache is None and torch.is_grad_enabled():
            def run(x, cos, sin, positions, segment_ids, mask, generator):
                return self._forward(x, cos, sin, positions, None, None,
                                     None, attn_impl, segment_ids, mask)
            return remat_call(run, x, cos, sin, positions, segment_ids,
                              mask, generator=None, policy=cfg.remat_policy)
        return self._forward(x, cos, sin, positions, layer_cache, write_pos,
                             paged, attn_impl, segment_ids, mask)

    def _forward(self, x, cos, sin, positions, layer_cache, write_pos,
                 paged, attn_impl, segment_ids, mask):
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
            q, k, v, causal=True, q_offset=offset, mask=mask,
            segment_ids=segment_ids, window=cfg.sliding_window, paged=paged,
            impl=attn_impl,
        )
        x = x + self.o(attn.reshape(B, S, cfg.num_heads * hd))
        h = self.mlp_norm(x)
        return x + self.down(F.silu(self.gate(h)) * self.up(h))


class LlamaForCausalLM(nn.Module):
    """Returns [B, S, vocab] logits (and the cache when decoding), or the
    final hidden states with ``return_hidden=True``. Untied LM head (the
    Llama-3 layout)."""

    def __init__(self, config: LlamaConfig, *, device: DeviceLike = None,
                 policy: Policy = Policy()):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.policy = policy
        dt = policy.param_dtype
        self.embed = nn.Embedding(
            config.vocab_size, config.hidden_size, device=device, dtype=dt
        )
        self.layers = nn.ModuleList(
            LlamaBlock(config, device=device, policy=policy)
            for _ in range(config.num_layers)
        )
        self.final_norm = RMSNorm(
            config.hidden_size, config.rms_eps, device=device, dtype=dt
        )
        self.lm_head = Linear(config.hidden_size, config.vocab_size,
                              policy=policy, device=device)
        self._rope: dict = {}

    @property
    def device(self) -> torch.device:
        return self.final_norm.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02):
        """Seeded random weights: every matrix normal(0, std), norms one.

        Each matrix is drawn whole, in ``named_parameters`` order, and a
        parameter sharded by FSDP keeps only its own rows of the draw, one
        tensor at a time: the weights are the same at every world size,
        and no rank ever holds more than one whole matrix."""
        for name, p in self.named_parameters():
            local, start, _ = row_shard(p)
            if name.endswith("norm.weight"):
                local.fill_(1.0)
                continue
            full = torch.randn(p.shape, generator=generator,
                               device=local.device, dtype=torch.float32)
            local.copy_(full[start:start + local.shape[0]].mul_(std))
            del full
        return self

    def init_cache(self, batch: int, length: int) -> KVCache:
        """Zeroed per-layer (k, v) buffers [batch, length, Hkv, D] in the
        compute dtype (with ``kv_cache_quantize="int8"``: int8 payloads
        and f32 per-token scales). The serving pool calls it with batch =
        page frames and length = page size."""
        cfg = self.config
        return [
            init_layer_cache(batch, length, cfg.num_kv_heads, cfg.head_dim,
                             dtype=self.policy.compute_dtype,
                             device=self.device,
                             quantize=cfg.kv_cache_quantize)
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
        segment_ids: Optional[torch.Tensor] = None,
        kv_mask: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        return_hidden: bool = False,
    ):
        """``decode=False``: a plain causal pass, returns logits (the final
        hidden states in the output dtype with ``return_hidden``, for the
        chunked-vocab loss). ``segment_ids`` [B, S] (packed rows, with
        per-document ``positions``) keep attention inside each document;
        ``train`` and ``generator`` (the train step's dropout stream) are
        accepted as GPT-2's are: Llama has no dropout and draws nothing.

        ``decode=True``: per-row KV-cache decode, returns
        ``(logits, cache)``. ``write_pos`` [B] and ``positions`` [B, S]
        are required; ``cache`` defaults to zeroed ``[B, cache_len]``
        buffers; with ``paged`` the cache is the page pool and attention
        streams it through the paged-attention kernel.

        ``kv_mask`` [B, T] (left-padded prompts) is for decode only.

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
        if segment_ids is not None and decode:
            raise ValueError(
                "segment_ids (packed training) and decode (KV cache) are "
                "mutually exclusive")
        if kv_mask is not None and not decode:
            raise ValueError(
                "kv_mask is for KV-cache decode (left-padded prompts); "
                "training masks go through the loss/segment machinery")
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
                attn_impl=attn_impl, segment_ids=segment_ids, mask=kv_mask,
            )
        x = self.final_norm(x)
        if return_hidden:
            return x.to(self.policy.output_dtype)
        logits = self.lm_head(x).to(self.policy.output_dtype)
        return (logits, cache) if decode else logits
