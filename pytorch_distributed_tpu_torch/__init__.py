"""pytorch_distributed_tpu_torch — the PyTorch/CUDA port of
``pytorch_distributed_tpu``, slice by slice.

The slices so far: serving Llama-3 through the continuous-batching
engine, with decode attention in a hand-written CUDA kernel for Hopper
(``csrc/paged_attention.cu``); training GPT-2 on one card, with
attention forward and backward in hand-written flash kernels
(``csrc/flash_attention.cu``); training ResNet-50 data-parallel
(``torch.distributed`` process group, DDP with global BatchNorm
statistics, uint8 image data normalized on the card, SGD); and the JAX
recipe's GPT-2 run (ZeRO-1, remat, the chunked-vocab loss, BPE corpora)
with checkpoints both packages restore; the JAX recipe's Llama-3-8B
run, FSDP full-shard (FSDP2 over the ``fsdp`` mesh axis, each rank
checkpointing its own rows); and the JAX recipe's BERT-base fine-tune
(DDP, bf16 or fp16 with dynamic loss scaling, the flash kernels in
either dtype at its padded, non-causal shape); and generation (GPT-2
and Llama KV-cache decode with ragged prompts, penalties and an int8
cache, beam search, speculative decoding), int8/int4 weight
quantization (``ops.QuantizedModel``) and LoRA (``LoRAModel``, the BERT
recipe's ``--lora``). Entry points
run on the CUDA card unless the caller passes ``device="cpu"``. The
package imports ``torch`` and ``numpy``, never ``jax`` or the JAX
package.

    import torch
    from pytorch_distributed_tpu_torch import (
        EngineConfig, LlamaConfig, LlamaForCausalLM, Request, ServeEngine,
    )

    model = LlamaForCausalLM(LlamaConfig.llama3_8b())
    model.init_weights(torch.Generator("cuda").manual_seed(0))
    engine = ServeEngine(model, EngineConfig(num_slots=8, max_len=2048))

    python -m pytorch_distributed_tpu_torch.recipes.gpt2 --size medium \
        --batch-size 8 --accum-steps 1 --seq-len 1024 --steps-per-epoch 20
    torchrun --nproc-per-node 4 -m \
        pytorch_distributed_tpu_torch.recipes.resnet50_imagenet \
        --batch-size 512 --steps-per-epoch 20
    torchrun --nproc-per-node 4 -m \
        pytorch_distributed_tpu_torch.recipes.llama_fsdp --size 8b \
        --fsdp 4 --batch-size 8 --seq-len 2048 --remat --vocab-chunk 8192
    python -m pytorch_distributed_tpu_torch.recipes.bert_finetune \
        --steps-per-epoch 20 --fp16
"""

from pytorch_distributed_tpu_torch import optim
from pytorch_distributed_tpu_torch.data import (
    ArrayDataset,
    DataLoader,
    DistributedSampler,
    SyntheticImageDataset,
    SyntheticTextDataset,
    TokenizedTextDataset,
    Tokenizer,
    device_normalizer_for,
    host_flip_transform,
    make_device_normalizer,
    pack_documents,
    packed_loss_mask,
)
from pytorch_distributed_tpu_torch.generation import generate, generate_beam
from pytorch_distributed_tpu_torch.interop import (
    bert_params_from_jax,
    bert_params_to_jax,
    gpt2_params_from_jax,
    gpt2_params_to_jax,
    llama_params_from_jax,
    llama_params_to_jax,
    lora_params_from_jax,
    lora_params_to_jax,
    quantized_params_from_jax,
    quantized_params_to_jax,
    resnet_params_from_jax,
    resnet_params_to_jax,
)
from pytorch_distributed_tpu_torch.lora import (
    LoRAModel,
    lora_init,
    lora_merge,
    lora_param_count,
)
from pytorch_distributed_tpu_torch.models.bert import (
    BertConfig,
    BertForMaskedLM,
    BertForSequenceClassification,
    BertModel,
    mask_tokens,
)
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from pytorch_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
)
from pytorch_distributed_tpu_torch.models.resnet import (
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)
from pytorch_distributed_tpu_torch.ops.attention import attention
from pytorch_distributed_tpu_torch.ops.flash_attention import flash_attention
from pytorch_distributed_tpu_torch.ops.paged_attention import paged_attention
from pytorch_distributed_tpu_torch.parallel import FSDP, DataParallel, ZeRO1
from pytorch_distributed_tpu_torch.runtime.device import (
    default_device,
    device_info,
)
from pytorch_distributed_tpu_torch.runtime.distributed import (
    ReduceOp,
    all_reduce,
    barrier,
    broadcast,
    destroy_process_group,
    get_backend,
    get_rank,
    get_world_size,
    init_process_group,
    is_initialized,
)
from pytorch_distributed_tpu_torch.runtime.mesh import (
    MeshSpec,
    data_axes,
    make_mesh,
)
from pytorch_distributed_tpu_torch.runtime.precision import (
    GradScaler,
    Policy,
    ScalerState,
    autocast,
    current_policy,
    use_policy,
)
from pytorch_distributed_tpu_torch.runtime.prng import generator_for, seed_all
from pytorch_distributed_tpu_torch.speculative import generate_speculative
from pytorch_distributed_tpu_torch.serve import (
    EngineConfig,
    Request,
    RequestStatus,
    ServeEngine,
)
from pytorch_distributed_tpu_torch.train import (
    EX_TEMPFAIL,
    CheckpointCorrupted,
    Preempted,
    Trainer,
    TrainerConfig,
    TrainingDiverged,
    TrainState,
    accuracy,
    build_train_step,
    causal_lm_eval_step,
    causal_lm_loss_fn,
    classification_eval_step,
    classification_loss_fn,
    cross_entropy,
    fit_elastic,
    masked_lm_loss_fn,
    restore_checkpoint,
    save_checkpoint,
    text_classification_loss_fn,
    topk_accuracy,
    verify_checkpoint,
)

__all__ = [
    "optim", "ArrayDataset", "DataLoader", "DistributedSampler",
    "SyntheticImageDataset", "SyntheticTextDataset", "TokenizedTextDataset",
    "Tokenizer", "device_normalizer_for",
    "host_flip_transform", "make_device_normalizer", "pack_documents",
    "packed_loss_mask", "generate", "generate_beam",
    "generate_speculative", "LoRAModel", "lora_init", "lora_merge",
    "lora_param_count", "lora_params_from_jax", "lora_params_to_jax",
    "quantized_params_from_jax", "quantized_params_to_jax",
    "bert_params_from_jax",
    "bert_params_to_jax", "gpt2_params_from_jax",
    "gpt2_params_to_jax", "llama_params_from_jax", "llama_params_to_jax",
    "resnet_params_from_jax",
    "resnet_params_to_jax", "BertConfig", "BertForMaskedLM",
    "BertForSequenceClassification", "BertModel", "mask_tokens",
    "GPT2Config",
    "GPT2LMHead", "LlamaConfig", "LlamaForCausalLM", "ResNet", "ResNet18",
    "ResNet34", "ResNet50", "ResNet101", "ResNet152", "attention",
    "flash_attention", "paged_attention", "FSDP", "DataParallel", "ZeRO1",
    "default_device", "device_info", "ReduceOp", "all_reduce", "barrier",
    "broadcast", "destroy_process_group", "get_backend", "get_rank",
    "get_world_size", "init_process_group", "is_initialized", "MeshSpec",
    "data_axes", "make_mesh",
    "GradScaler", "Policy", "ScalerState", "autocast", "current_policy",
    "use_policy", "generator_for", "seed_all", "EngineConfig", "Request",
    "RequestStatus", "ServeEngine", "EX_TEMPFAIL", "CheckpointCorrupted",
    "Preempted", "Trainer", "TrainerConfig", "TrainingDiverged",
    "TrainState", "accuracy", "build_train_step", "causal_lm_eval_step",
    "causal_lm_loss_fn", "classification_eval_step",
    "classification_loss_fn", "cross_entropy", "fit_elastic",
    "masked_lm_loss_fn", "restore_checkpoint", "save_checkpoint",
    "text_classification_loss_fn", "topk_accuracy",
    "verify_checkpoint",
]
