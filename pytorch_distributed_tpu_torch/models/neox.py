"""GPT-NeoX / Pythia: the port of ``pytorch_distributed_tpu/models/neox.py``.

The Pythia suite (Biderman et al. 2023) runs the GPT-NeoX block, a
decoder of its own beside GPT-2 and the Llama body:

* parallel residual: ``x + attn(ln1(x)) + mlp(ln2(x))``, attention and
  MLP reading the same input; ``use_parallel_residual=False`` is the
  sequential form;
* partial rotary: the first ``rotary_pct`` of each head's dims rotate,
  the rest pass through;
* a fused QKV in HF's per-head ``(H, 3, hd)`` order along its output
  axis, so the HF and JAX layouts are reshapes of the port's weight;
* LayerNorm with bias, an exact (erf) gelu MLP, an untied ``embed_out``.

The KV cache is the dense one, through ``generate``: the JAX NeoX has no
paged form, and neither has the port (a paged view raises). Parameters
live in ``policy.param_dtype`` and every product runs in the compute
dtype, as in ``models/gpt2.py``, whose ``Dense`` and ``LayerNorm`` the
block shares.

``neox_partition_rules`` places the JAX leaves for tensor parallelism
(a rule table; NeoX trains data-parallel or with FSDP in the port).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_tpu_torch.models.gpt2 import Dense, LayerNorm
from pytorch_distributed_tpu_torch.models.llama import KVCache
from pytorch_distributed_tpu_torch.models.scan import remat_call
from pytorch_distributed_tpu_torch.ops.attention import (
    apply_rope,
    attention,
    decode_cache,
    init_layer_cache,
    rope_frequencies,
    validate_write_pos,
)
from pytorch_distributed_tpu_torch.runtime.device import (
    DeviceLike,
    resolve_device,
)
from pytorch_distributed_tpu_torch.runtime.mesh import row_shard
from pytorch_distributed_tpu_torch.runtime.precision import Policy


@dataclasses.dataclass(frozen=True)
class NeoXConfig:
    vocab_size: int = 50_304
    hidden_size: int = 2_048
    num_layers: int = 16
    num_heads: int = 8
    intermediate_size: int = 8_192
    max_seq_len: int = 2_048
    rope_theta: float = 10_000.0
    rotary_pct: float = 0.25
    layer_norm_eps: float = 1e-5
    use_parallel_residual: bool = True
    remat: bool = False
    remat_policy: str = "full"  # full | dots | dots_no_batch

    def __post_init__(self):
        rot = self.rotary_dim
        if rot < 2 or rot % 2:
            raise ValueError(
                f"rotary_pct {self.rotary_pct} gives rotary dim {rot} "
                f"of head_dim {self.head_dim}; need an even dim >= 2"
            )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.rotary_pct)

    @classmethod
    def pythia_1b(cls) -> "NeoXConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "NeoXConfig":
        return cls(
            vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_seq_len=128, rotary_pct=0.5,
        )


def _partial_rope(x, cos, sin, positions):
    """Rotate the first ``rot`` dims (the tables' width), pass the rest."""
    rot = cos.shape[-1] * 2
    if rot == x.shape[-1]:
        return apply_rope(x, cos, sin, positions)
    rotated = apply_rope(x[..., :rot], cos, sin, positions)
    return torch.cat([rotated, x[..., rot:]], dim=-1)


class NeoXBlock(nn.Module):
    def __init__(self, cfg: NeoXConfig, *, device, policy: Policy):
        super().__init__()
        self.cfg = cfg
        D, H, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
        kw = dict(policy=policy, device=device)
        self.ln1 = LayerNorm(D, cfg.layer_norm_eps, **kw)
        self.qkv = Dense(D, H * 3 * hd, **kw)   # [H, (q, k, v), hd] out
        self.attn_out = Dense(H * hd, D, **kw)
        self.ln2 = LayerNorm(D, cfg.layer_norm_eps, **kw)
        self.mlp_up = Dense(D, cfg.intermediate_size, **kw)
        self.mlp_down = Dense(cfg.intermediate_size, D, **kw)

    def forward(self, x, cos, sin, positions, layer_cache, write_pos,
                attn_impl: Optional[str] = None, segment_ids=None,
                mask=None):
        cfg = self.cfg
        if cfg.remat and layer_cache is None and torch.is_grad_enabled():
            def run(x, cos, sin, positions, segment_ids, mask, generator):
                return self._forward(x, cos, sin, positions, None, None,
                                     attn_impl, segment_ids, mask)
            return remat_call(run, x, cos, sin, positions, segment_ids,
                              mask, generator=None, policy=cfg.remat_policy)
        return self._forward(x, cos, sin, positions, layer_cache, write_pos,
                             attn_impl, segment_ids, mask)

    def _forward(self, x, cos, sin, positions, layer_cache, write_pos,
                 attn_impl, segment_ids, mask):
        cfg = self.cfg
        B, S, _ = x.shape
        H, hd = cfg.num_heads, cfg.head_dim
        qkv = self.qkv(self.ln1(x)).view(B, S, H, 3, hd)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        q = _partial_rope(q, cos, sin, positions)
        k = _partial_rope(k, cos, sin, positions)
        offset = 0
        if layer_cache is not None:
            k, v, offset = decode_cache(layer_cache, k, v,
                                        write_pos=write_pos, paged=None)
        attn = attention(q, k, v, causal=True, q_offset=offset, mask=mask,
                         segment_ids=segment_ids, impl=attn_impl)
        attn = self.attn_out(attn.reshape(B, S, H * hd))

        def mlp(h):   # HF NeoX: exact (erf) gelu
            return self.mlp_down(F.gelu(self.mlp_up(h)))

        if cfg.use_parallel_residual:
            # one junction: attention and MLP both read x
            return x + attn + mlp(self.ln2(x))
        x = x + attn
        return x + mlp(self.ln2(x))


class NeoXForCausalLM(nn.Module):
    """Returns [B, S, vocab] logits (and the cache when decoding), or the
    final hidden states with ``return_hidden=True``; untied ``embed_out``
    (Pythia). ``forward`` takes ``LlamaForCausalLM``'s arguments, so
    ``generate`` and the trainer drive either; a ``paged`` view raises."""

    def __init__(self, config: NeoXConfig, *, device: DeviceLike = None,
                 policy: Policy = Policy()):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.policy = policy
        D = config.hidden_size
        self.embed = nn.Embedding(config.vocab_size, D, device=device,
                                  dtype=policy.param_dtype)
        self.layers = nn.ModuleList(
            NeoXBlock(config, device=device, policy=policy)
            for _ in range(config.num_layers)
        )
        self.final_norm = LayerNorm(D, config.layer_norm_eps, policy=policy,
                                    device=device)
        self.embed_out = nn.Linear(D, config.vocab_size, bias=False,
                                   device=device, dtype=policy.param_dtype)
        self._rope: dict = {}

    @property
    def device(self) -> torch.device:
        return self.final_norm.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02):
        """Seeded random weights: every matrix and bias normal(0, std),
        LayerNorm scales one and biases zero. Drawn whole in
        ``named_parameters`` order, a sharded parameter keeping its own
        rows (as ``LlamaForCausalLM.init_weights``)."""
        for name, p in self.named_parameters():
            local, start, _ = row_shard(p)
            if name.startswith("final_norm.") or ".ln" in name:
                local.fill_(1.0 if name.endswith("weight") else 0.0)
                continue
            full = torch.randn(p.shape, generator=generator,
                               device=local.device, dtype=torch.float32)
            local.copy_(full[start:start + local.shape[0]].mul_(std))
            del full
        return self

    def init_cache(self, batch: int, length: int) -> KVCache:
        """Zeroed per-layer dense (k, v) buffers [batch, length, H, hd] in
        the compute dtype."""
        cfg = self.config
        return [
            init_layer_cache(batch, length, cfg.num_heads, cfg.head_dim,
                             dtype=self.policy.compute_dtype,
                             device=self.device)
            for _ in range(cfg.num_layers)
        ]

    def _rope_tables(self, length: int):
        tabs = self._rope.get(length)
        if tabs is None:
            cfg = self.config
            tabs = rope_frequencies(cfg.rotary_dim, length, cfg.rope_theta,
                                    device=self.device)
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
        paged=None,
        attn_impl: Optional[str] = None,
        segment_ids: Optional[torch.Tensor] = None,
        kv_mask: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        return_hidden: bool = False,
    ):
        """As :meth:`LlamaForCausalLM.forward`: a plain causal pass
        (``decode=False``) or per-row dense KV-cache decode
        (``decode=True``, ``write_pos`` and ``positions`` required).
        NeoX has no dropout: ``train`` and ``generator`` draw nothing."""
        cfg = self.config
        B, S = input_ids.shape
        if paged is not None:
            raise NotImplementedError(
                "NeoX has no paged decode form (nor has the JAX NeoX): "
                "generate with its dense cache")
        if cache_len is not None and cache_len > cfg.max_seq_len:
            raise ValueError(
                f"cache_len {cache_len} > max_seq_len {cfg.max_seq_len}"
            )
        validate_write_pos(write_pos, decode, positions)
        if decode and write_pos is None:
            raise ValueError("decode=True needs write_pos and positions")
        if not decode and cache is not None:
            raise ValueError("a cache needs decode=True")
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
            x = layer(x, cos, sin, positions,
                      cache[i] if decode else None, write_pos,
                      attn_impl=attn_impl, segment_ids=segment_ids,
                      mask=kv_mask)
        x = self.final_norm(x)
        if return_hidden:
            return x.to(self.policy.output_dtype)
        cd = self.policy.compute_dtype
        logits = F.linear(x.to(cd), self.embed_out.weight.to(cd))
        logits = logits.to(self.policy.output_dtype)
        return (logits, cache) if decode else logits


def neox_partition_rules():
    """Megatron TP: the fused qkv shards on its head axis, attn_out on
    the same axis (its input side), the MLP on its hidden dim."""
    from pytorch_distributed_tpu_torch.parallel.rules import P
    from pytorch_distributed_tpu_torch.parallel.sharding import stacked

    return [
        (r"/qkv/kernel", stacked(P(None, "tp", None, None))),
        (r"/qkv/bias", stacked(P("tp", None, None))),
        (r"/attn_out/kernel", stacked(P("tp", None, None))),
        (r"/mlp_up/kernel", stacked(P(None, "tp"))),
        (r"/mlp_up/bias", stacked(P("tp"))),
        (r"/mlp_down/kernel", stacked(P("tp", None))),
        (r"embed/embedding", P(None, "tp")),
        (r"embed_out/kernel", P(None, "tp")),
    ]
