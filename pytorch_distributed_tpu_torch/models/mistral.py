"""Mistral-7B: the port of ``pytorch_distributed_tpu/models/mistral.py``.

Mistral is the Llama decoder with sliding-window attention: position
``i`` attends to keys in ``(i - window, i]`` only (Jiang et al. 2023).
The window lives in the shared attention (``ops.attention``'s einsum
path for an uncached forward, the paged kernel's band mask in the decode
tick), so this module is configuration only; the HF layout is Llama's
(``interop.load_mistral_weights``).

``mistral_partition_rules`` is Llama's (tensor parallelism; the window
is exact under both sequence-parallel modes).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from pytorch_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    llama_partition_rules,
)

mistral_partition_rules = llama_partition_rules


@dataclasses.dataclass(frozen=True)
class MistralConfig(LlamaConfig):
    # Mistral-7B-v0.1 geometry
    vocab_size: int = 32_000
    hidden_size: int = 4_096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    intermediate_size: int = 14_336
    max_seq_len: int = 32_768
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = 4_096

    @classmethod
    def mistral_7b(cls) -> "MistralConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "MistralConfig":
        return cls(
            vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=128, max_seq_len=128,
            sliding_window=8,
        )


class MistralForCausalLM(LlamaForCausalLM):
    """The Llama machinery end to end; the config's window does the work."""
