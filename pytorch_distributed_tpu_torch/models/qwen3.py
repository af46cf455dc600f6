"""Qwen3: the port of ``pytorch_distributed_tpu/models/qwen3.py``.

Qwen3 drops Qwen2's projection biases and RMS-normalises each head's
query and key (one ``[head_dim]`` scale each, shared by the heads)
before rotary: ``qk_norm=True`` on the shared config. This module is
configuration only; the HF layout is Llama's with the two norm scales
carried (``interop.load_qwen3_weights``).

``qwen3_partition_rules`` is Llama's (tensor parallelism).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from pytorch_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    llama_partition_rules,
)

qwen3_partition_rules = llama_partition_rules


@dataclasses.dataclass(frozen=True)
class Qwen3Config(LlamaConfig):
    # Qwen3-8B geometry (head_dim 128, decoupled from hidden/heads)
    vocab_size: int = 151_936
    hidden_size: int = 4_096
    num_layers: int = 36
    num_heads: int = 32
    num_kv_heads: int = 8
    intermediate_size: int = 12_288
    max_seq_len: int = 32_768
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    override_head_dim: Optional[int] = 128
    qk_norm: bool = True

    @classmethod
    def qwen3_8b(cls) -> "Qwen3Config":
        return cls()

    @classmethod
    def tiny(cls) -> "Qwen3Config":
        return cls(
            vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=128, max_seq_len=128,
            override_head_dim=16,
        )


class Qwen3ForCausalLM(LlamaForCausalLM):
    """The Llama machinery end to end; the config's QK norms do the
    work."""
