"""Vision Transformer (ViT) image classification: the port of
``pytorch_distributed_tpu/models/vit.py``.

Images come in NHWC, as the JAX model and the port's uint8 pipelines
give them. The patch embedding is one strided convolution (the port's
weight ``[D, 3, ps, ps]``, HF's layout; flax's kernel is ``[ps, ps, 3,
D]``) whose ``[B, D, h, w]`` output is flattened row-major over the
patch grid, as the JAX model flattens its NHWC output. A ``cls`` token
(or ``mean`` pooling), learned positions, pre-LN encoder blocks with
separate q/k/v projections, bidirectional attention through
``ops.attention`` (the flash kernels on the card: at ViT-B/16's 197
tokens the 64-row tiles end in a ragged 5-row tail), exact-erf GELU,
LayerNorm eps 1e-6, and the logits in the policy's output dtype.
Dropout draws its masks from the train step's generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_tpu_torch.models.gpt2 import (
    _TRUNC_STD,
    Dense,
    LayerNorm,
    dropout,
)
from pytorch_distributed_tpu_torch.ops.attention import attention
from pytorch_distributed_tpu_torch.runtime.device import (
    DeviceLike,
    resolve_device,
)
from pytorch_distributed_tpu_torch.runtime.precision import Policy


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    dropout_rate: float = 0.0
    pooling: str = "cls"  # cls | mean
    layer_norm_eps: float = 1e-6  # HF ViT uses 1e-12

    @classmethod
    def base(cls) -> "ViTConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "ViTConfig":  # test/smoke configuration
        return cls(
            image_size=32, patch_size=8, num_classes=10, hidden_size=64,
            num_layers=2, num_heads=4, mlp_dim=128,
        )

    def __post_init__(self):
        if self.pooling not in ("cls", "mean"):
            raise ValueError(
                f"pooling must be 'cls' or 'mean', got {self.pooling!r}")

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, *, policy: Policy, device):
        super().__init__()
        self.cfg = cfg
        D, eps = cfg.hidden_size, cfg.layer_norm_eps
        kw = dict(policy=policy, device=device)
        self.attn_ln = LayerNorm(D, eps, **kw)
        self.query = Dense(D, D, **kw)   # out = (heads, head_dim)
        self.key = Dense(D, D, **kw)
        self.value = Dense(D, D, **kw)
        self.out = Dense(D, D, **kw)     # in = (heads, head_dim)
        self.mlp_ln = LayerNorm(D, eps, **kw)
        self.mlp_up = Dense(D, cfg.mlp_dim, **kw)
        self.mlp_down = Dense(cfg.mlp_dim, D, **kw)

    def forward(self, x, *, train: bool, generator,
                attn_impl: Optional[str] = None):
        cfg = self.cfg
        B, S, D = x.shape
        shape = (B, S, cfg.num_heads, cfg.head_dim)
        h = self.attn_ln(x)
        q = self.query(h).view(shape)
        k = self.key(h).view(shape)
        v = self.value(h).view(shape)
        attn = attention(q, k, v, impl=attn_impl)   # bidirectional
        attn = self.out(attn.reshape(B, S, D))
        x = x + dropout(attn, cfg.dropout_rate, train, generator)
        h = F.gelu(self.mlp_up(self.mlp_ln(x)), approximate="none")
        h = self.mlp_down(h)
        return x + dropout(h, cfg.dropout_rate, train, generator)


class ViT(nn.Module):
    """``[B, H, W, 3]`` images -> ``[B, num_classes]`` logits."""

    def __init__(self, config: ViTConfig, *, device: DeviceLike = None,
                 policy: Policy = Policy()):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.policy = policy
        cfg, D, ps = config, config.hidden_size, config.patch_size
        kw = dict(policy=policy, device=device)
        pkw = dict(device=device, dtype=policy.param_dtype)
        self.patch_embed = nn.Conv2d(3, D, ps, stride=ps, **pkw)
        n_tokens = cfg.num_patches + (1 if cfg.pooling == "cls" else 0)
        if cfg.pooling == "cls":
            self.cls_token = nn.Parameter(torch.zeros(1, 1, D, **pkw))
        self.pos_embedding = nn.Parameter(torch.zeros(1, n_tokens, D, **pkw))
        self.blocks = nn.ModuleList(
            ViTBlock(cfg, **kw) for _ in range(cfg.num_layers))
        self.final_ln = LayerNorm(D, cfg.layer_norm_eps, **kw)
        self.head = Dense(D, cfg.num_classes, **kw)

    @property
    def device(self) -> torch.device:
        return self.final_ln.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Seeded weights drawn as flax's initializers draw them: Dense
        and conv kernels lecun-normal (truncated at 2 std, variance
        1/fan_in), biases and the cls token zero, positions normal with
        std 0.02, LayerNorm scales one."""
        for name, p in self.named_parameters():
            if name == "pos_embedding":
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=p.device) * 0.02)
            elif name.endswith("_ln.weight"):
                p.fill_(1.0)
            elif p.ndim == 1 or name == "cls_token":
                p.zero_()
            else:   # a Dense weight [out, in] or the conv's [D, 3, ps, ps]
                draw = torch.empty(p.shape, device=p.device,
                                   dtype=torch.float32)
                nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                fan_in = math.prod(p.shape[1:])
                p.copy_(draw / (math.sqrt(fan_in) * _TRUNC_STD))
        return self

    def forward(self, images: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                attn_impl: Optional[str] = None) -> torch.Tensor:
        """``train=True`` applies dropout with masks from ``generator``;
        ``attn_impl`` is passed to every block's ``attention`` call
        (``None``: flash on the card, ``"flash"`` or ``"xla"`` to force
        one)."""
        cfg = self.config
        B, H, W, _ = images.shape
        if H != cfg.image_size or W != cfg.image_size:
            raise ValueError(f"expected {cfg.image_size}x{cfg.image_size} "
                             f"images, got {H}x{W}")
        ct = self.policy.compute_dtype
        conv = self.patch_embed
        x = F.conv2d(images.to(ct).permute(0, 3, 1, 2).contiguous(),
                     conv.weight.to(ct), conv.bias.to(ct),
                     stride=cfg.patch_size)
        x = x.flatten(2).transpose(1, 2)   # [B, patches, D], row-major
        if cfg.pooling == "cls":
            x = torch.cat([self.cls_token.to(ct).expand(B, 1, -1), x], dim=1)
        x = x + self.pos_embedding.to(ct)
        x = dropout(x, cfg.dropout_rate, train, generator)
        for block in self.blocks:
            x = block(x, train=train, generator=generator,
                      attn_impl=attn_impl)
        x = self.final_ln(x)
        pooled = x[:, 0] if cfg.pooling == "cls" else x.mean(dim=1)
        return self.head(pooled).to(self.policy.output_dtype)


def vit_partition_rules():
    """Megatron-style TP over the JAX ViT's leaves, BERT's shapes: the
    q/k/v kernels ``[hidden, heads, head_dim]`` and their biases on
    heads, the attention output on its input heads, the MLP on its hidden
    dim, the head on classes."""
    from pytorch_distributed_tpu_torch.parallel.rules import P

    return [
        (r"(query|key|value)/kernel", P(None, "tp", None)),
        (r"(query|key|value)/bias", P("tp", None)),
        (r"out/kernel", P("tp", None, None)),
        (r"mlp_up/kernel", P(None, "tp")),
        (r"mlp_up/bias", P("tp")),
        (r"mlp_down/kernel", P("tp", None)),
        (r"head/kernel", P(None, "tp")),
    ]
