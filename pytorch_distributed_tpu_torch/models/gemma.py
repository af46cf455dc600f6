"""Gemma: the port of ``pytorch_distributed_tpu/models/gemma.py``.

Gemma (Mesnard et al. 2024) is the Llama decoder with a zero-centred
RMSNorm scale applied as ``(1 + scale)``, a tanh-approximate-gelu gate,
embeddings times ``sqrt(hidden)`` after the lookup, a head dim of 256
decoupled from ``hidden / heads``, and a head tied to the embedding.
Each is a field of the shared :class:`LlamaConfig` (``rms_offset``,
``hidden_act``, ``scale_embedding``, ``override_head_dim``,
``tie_word_embeddings``), so this module is configuration only; the HF
layout is Llama's (``interop.load_gemma_weights``).

``gemma_partition_rules`` takes the kv-head count from the config: the
MQA Gemma-2B replicates k/v (each tp rank then keeps the one kv head
its query heads use), Gemma-7B shards them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from pytorch_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    llama_partition_rules,
)



def gemma_partition_rules(config=None, num_kv_heads=None):
    """Llama's TP rules with the kv-head count taken from ``config``
    (``num_kv_heads == 1``: the forced MQA replicate form); with no
    arguments, the shape-based decision. A positional int is the kv-head
    count (the JAX package's older signature)."""
    if isinstance(config, int):
        config, num_kv_heads = None, config
    if config is not None and num_kv_heads is not None:
        raise ValueError("pass config or num_kv_heads, not both")
    if config is not None:
        num_kv_heads = config.num_kv_heads
    return llama_partition_rules(num_kv_heads=num_kv_heads)


@dataclasses.dataclass(frozen=True)
class GemmaConfig(LlamaConfig):
    # Gemma-2B geometry (multi-query: 1 kv head)
    vocab_size: int = 256_000
    hidden_size: int = 2_048
    num_layers: int = 18
    num_heads: int = 8
    num_kv_heads: int = 1
    intermediate_size: int = 16_384
    max_seq_len: int = 8_192
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    override_head_dim: Optional[int] = 256
    rms_offset: bool = True
    hidden_act: str = "gelu"
    scale_embedding: bool = True
    tie_word_embeddings: bool = True

    @classmethod
    def gemma_2b(cls) -> "GemmaConfig":
        return cls()

    @classmethod
    def gemma_7b(cls) -> "GemmaConfig":
        return cls(
            hidden_size=3_072, num_layers=28, num_heads=16,
            num_kv_heads=16, intermediate_size=24_576,
        )

    @classmethod
    def tiny(cls) -> "GemmaConfig":
        return cls(
            vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=1, intermediate_size=128, max_seq_len=128,
            override_head_dim=16,
        )


class GemmaForCausalLM(LlamaForCausalLM):
    """The Llama machinery end to end; the config's fields do the work."""
