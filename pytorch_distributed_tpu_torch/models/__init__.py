"""models/ of the PyTorch/CUDA port: GPT-2, BERT, ResNet, the Llama body
with its families (Gemma, Mistral, Qwen2, Qwen3, Phi-3, tied
Llama-3.2), Mixtral, GPT-NeoX/Pythia, ViT and T5, under the JAX
package's names."""

from pytorch_distributed_tpu_torch.models.bert import bert_partition_rules
from pytorch_distributed_tpu_torch.models.gemma import (
    GemmaConfig,
    GemmaForCausalLM,
    gemma_partition_rules,
)
from pytorch_distributed_tpu_torch.models.gpt2 import gpt2_partition_rules
from pytorch_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    RopeScaling,
    llama_partition_rules,
)
from pytorch_distributed_tpu_torch.models.mistral import (
    MistralConfig,
    MistralForCausalLM,
    mistral_partition_rules,
)
from pytorch_distributed_tpu_torch.models.mixtral import (
    MixtralConfig,
    MixtralForCausalLM,
    mixtral_partition_rules,
)
from pytorch_distributed_tpu_torch.models.neox import (
    NeoXConfig,
    NeoXForCausalLM,
    neox_partition_rules,
)
from pytorch_distributed_tpu_torch.models.phi3 import (
    Phi3Config,
    Phi3ForCausalLM,
    phi3_partition_rules,
)
from pytorch_distributed_tpu_torch.models.qwen2 import (
    Qwen2Config,
    Qwen2ForCausalLM,
    qwen2_partition_rules,
)
from pytorch_distributed_tpu_torch.models.qwen3 import (
    Qwen3Config,
    Qwen3ForCausalLM,
    qwen3_partition_rules,
)
from pytorch_distributed_tpu_torch.models.t5 import (
    T5Config,
    T5ForConditionalGeneration,
    generate_encdec,
    shift_right,
    t5_partition_rules,
)
from pytorch_distributed_tpu_torch.models.vit import (
    ViT,
    ViTConfig,
    vit_partition_rules,
)

__all__ = [
    "GemmaConfig", "GemmaForCausalLM", "gemma_partition_rules",
    "LlamaConfig", "LlamaForCausalLM", "RopeScaling",
    "llama_partition_rules", "MistralConfig", "MistralForCausalLM",
    "mistral_partition_rules", "MixtralConfig", "MixtralForCausalLM",
    "mixtral_partition_rules", "NeoXConfig", "NeoXForCausalLM",
    "neox_partition_rules", "Phi3Config", "Phi3ForCausalLM",
    "phi3_partition_rules", "Qwen2Config", "Qwen2ForCausalLM",
    "qwen2_partition_rules", "Qwen3Config", "Qwen3ForCausalLM",
    "qwen3_partition_rules", "bert_partition_rules", "gpt2_partition_rules",
    "ViT", "ViTConfig", "vit_partition_rules", "T5Config",
    "T5ForConditionalGeneration", "generate_encdec", "shift_right",
    "t5_partition_rules",
]
