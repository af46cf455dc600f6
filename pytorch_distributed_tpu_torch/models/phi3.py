"""Phi-3: the port of ``pytorch_distributed_tpu/models/phi3.py``.

Phi-3-mini is the Llama decoder (RMSNorm, full rotary, SwiGLU, untied
head, no biases) at head_dim 96 (3072 / 32); HF stores its q/k/v
projections fused as ``qkv_proj`` and its gate/up as ``gate_up_proj``,
which ``interop.load_phi3_weights`` splits onto the Llama layout (and
``export_phi3_weights`` fuses again). This module is configuration only.

``phi3_partition_rules`` is Llama's: it places the split Llama layout's
leaves, which is the JAX model's.
"""

from __future__ import annotations

import dataclasses

from pytorch_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    llama_partition_rules,
)

phi3_partition_rules = llama_partition_rules


@dataclasses.dataclass(frozen=True)
class Phi3Config(LlamaConfig):
    # Phi-3-mini-4k geometry (multi-head: kv heads == heads)
    vocab_size: int = 32_064
    hidden_size: int = 3_072
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    intermediate_size: int = 8_192
    max_seq_len: int = 4_096
    rope_theta: float = 10_000.0

    @classmethod
    def phi3_mini(cls) -> "Phi3Config":
        return cls()

    @classmethod
    def tiny(cls) -> "Phi3Config":
        return cls(
            vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=4, intermediate_size=128, max_seq_len=128,
        )


class Phi3ForCausalLM(LlamaForCausalLM):
    """The Llama machinery end to end; only the HF layout differs."""
