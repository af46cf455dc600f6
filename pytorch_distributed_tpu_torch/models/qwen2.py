"""Qwen2/Qwen2.5: the port of ``pytorch_distributed_tpu/models/qwen2.py``.

Qwen2 is the Llama decoder with biases on the q/k/v projections only
(``attention_bias=True``; o/gate/up/down stay bias-free) and its own
vocabulary and rope theta. This module is configuration only; the HF
layout is Llama's with the biases carried
(``interop.load_qwen2_weights``).

``qwen2_partition_rules`` is Llama's: the rule engine replicates
Qwen2-7B's 4 kv heads on a tp of 8. The JAX rules leave the q/k/v biases
replicated, which column-parallel projections cannot use as they are:
a Qwen2 model under ``tp > 1`` raises (ROADMAP A10.1).
"""

from __future__ import annotations

import dataclasses

from pytorch_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    llama_partition_rules,
)

qwen2_partition_rules = llama_partition_rules


@dataclasses.dataclass(frozen=True)
class Qwen2Config(LlamaConfig):
    # Qwen2-7B geometry (28 query heads over 4 kv heads: groups of 7)
    vocab_size: int = 152_064
    hidden_size: int = 3_584
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    intermediate_size: int = 18_944
    max_seq_len: int = 32_768
    rope_theta: float = 1_000_000.0
    attention_bias: bool = True

    @classmethod
    def qwen2_7b(cls) -> "Qwen2Config":
        return cls()

    @classmethod
    def tiny(cls) -> "Qwen2Config":
        return cls(
            vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=128, max_seq_len=128,
        )


class Qwen2ForCausalLM(LlamaForCausalLM):
    """The Llama machinery end to end; the config's biases do the work."""
