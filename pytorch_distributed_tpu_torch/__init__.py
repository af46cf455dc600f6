"""pytorch_distributed_tpu_torch — the PyTorch/CUDA port of
``pytorch_distributed_tpu``, slice by slice.

This slice serves Llama-3 through the continuous-batching engine, with
decode attention in a hand-written CUDA kernel for Hopper
(``csrc/paged_attention.cu``). Entry points run on the CUDA card unless
the caller passes ``device="cpu"``. The package imports ``torch`` and
``numpy``, never ``jax`` or the JAX package.

    import torch
    from pytorch_distributed_tpu_torch import (
        EngineConfig, LlamaConfig, LlamaForCausalLM, Request, ServeEngine,
    )

    model = LlamaForCausalLM(LlamaConfig.llama3_8b())
    model.init_weights(torch.Generator("cuda").manual_seed(0))
    engine = ServeEngine(model, EngineConfig(num_slots=8, max_len=2048))
"""

from pytorch_distributed_tpu_torch.generation import generate
from pytorch_distributed_tpu_torch.interop import llama_params_from_jax
from pytorch_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
)
from pytorch_distributed_tpu_torch.ops.paged_attention import paged_attention
from pytorch_distributed_tpu_torch.runtime.device import (
    default_device,
    device_info,
)
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.serve import (
    EngineConfig,
    Request,
    RequestStatus,
    ServeEngine,
)

__all__ = [
    "generate", "llama_params_from_jax", "LlamaConfig", "LlamaForCausalLM",
    "paged_attention", "default_device", "device_info", "Policy",
    "EngineConfig", "Request", "RequestStatus", "ServeEngine",
]
