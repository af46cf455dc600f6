"""Mixtral, the sparse mixture-of-experts decoder: the port of
``pytorch_distributed_tpu/models/mixtral.py``.

A Llama-3 body (RMSNorm, RoPE, grouped-query attention) whose FFN is
``ops.moe.MoEMLP`` with Mixtral's per-expert SwiGLU
(``w_out(silu(x w_gate) * x w_in)``, HF's ``w2(silu(w1 x) * w3 x)``)
and top-2 renormalised routing in f32, through the Llama block's FFN
hook: remat, the chunked loss, KV-cache decode, the paged serving tick,
FSDP and TP are the Llama model's. ``capacity_factor=None`` (the
default) is the drop-free dispatch HF computes; a finite factor is the
Switch bounded-capacity dispatch for training. Each layer's Switch
load-balance loss comes back through the model's outputs
(``return_aux=True``; ``train.causal_lm_loss_fn(moe_aux_weight=...)``
adds its weighted sum).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from pytorch_distributed_tpu_torch.models.llama import (
    LlamaBlock,
    LlamaConfig,
    LlamaForCausalLM,
    llama_partition_rules,
)
from pytorch_distributed_tpu_torch.ops.moe import MoEMLP
from pytorch_distributed_tpu_torch.runtime.precision import Policy


@dataclasses.dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    # Mixtral-8x7B geometry (vocab and theta differ from Llama-3)
    vocab_size: int = 32_000
    hidden_size: int = 4_096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    intermediate_size: int = 14_336
    max_seq_len: int = 32_768
    rope_theta: float = 1_000_000.0
    num_experts: int = 8
    top_k: int = 2
    # None = drop-free dispatch (HF-exact, serving); finite = Switch
    # bounded-capacity dispatch for training throughput
    capacity_factor: Optional[float] = None

    @classmethod
    def mixtral_8x7b(cls) -> "MixtralConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "MixtralConfig":
        return cls(
            vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=96, max_seq_len=128,
            num_experts=4, top_k=2,
        )


class MixtralBlock(LlamaBlock):
    """The Llama block with the dense SwiGLU MLP swapped for the MoE."""

    def _build_ffn(self, cfg, lin, *, device, policy: Policy):
        self.moe = MoEMLP(
            cfg.hidden_size, cfg.num_experts, cfg.intermediate_size,
            k=cfg.top_k, capacity_factor=cfg.capacity_factor,
            activation="swiglu", policy=policy, device=device)

    def _ffn(self, h):
        return self.moe(h)


class MixtralForCausalLM(LlamaForCausalLM):
    """Returns [B, S, vocab] logits (``generation.generate`` and the serve
    engine work unchanged); ``return_aux=True`` adds the layers' summed
    load-balance loss."""

    block_cls = MixtralBlock


def mixtral_partition_rules(ep_axis: str = "ep", tp_axis: str = "tp"):
    """Llama's attention, embedding and head rules and the expert tensors'
    (``ops.moe.moe_partition_rules``: experts over ``ep``, each expert's
    hidden dim over ``tp``, the router replicated), with the scan-stacked
    layer axis in front."""
    from pytorch_distributed_tpu_torch.ops.moe import moe_partition_rules
    from pytorch_distributed_tpu_torch.parallel.sharding import stacked

    return llama_partition_rules() + [
        (rf"/moe/{name}", stacked(spec))
        for name, spec in moe_partition_rules(ep_axis, tp_axis)
    ]
