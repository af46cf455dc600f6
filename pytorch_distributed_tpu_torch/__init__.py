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
checkpointing its own rows), with tensor parallelism over ``tp`` and
sequence parallelism (ring or Ulysses attention) over ``sp``; and the JAX recipe's BERT-base fine-tune
(DDP, bf16 or fp16 with dynamic loss scaling, the flash kernels in
either dtype at its padded, non-causal shape); and generation (GPT-2
and Llama KV-cache decode with ragged prompts, penalties and an int8
cache, beam search, speculative decoding), int8/int4 weight
quantization (``ops.QuantizedModel``) and LoRA (``LoRAModel``, the BERT
recipe's ``--lora``); and image-classification training complete: the
ResNet-18/CIFAR-10 recipe, the native augmenting pipeline over
``native/prefetch.cpp``, image folders with a quarantine, compressed
gradient sync (bf16, fp16, int8 with error feedback) as a DDP hook,
ZeRO-1 for ResNet, EMA and the JSONL and TensorBoard writers; and
mixture-of-experts (``ops.moe.MoEMLP``, Mixtral, GPT-2's experts) with
expert parallelism over an ``ep`` mesh axis, and the ViT-B/16 recipe;
and T5 (relative-position bias in the attention dispatch and the ring,
``generate_encdec``, the seq2seq losses, tensor parallelism, the JAX and
HF converters) with its seq2seq recipe; and pipeline parallelism over a
``pp`` mesh axis (GPT-2's GPipe form under its recipe's ``--pp``, and the
host-dispatched 1F1B executor with its stage link).
Entry points
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
    python -m pytorch_distributed_tpu_torch.recipes.resnet18_cifar10 \
        --data-dir /data --epochs 1
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
    FolderImagePipeline,
    ImageBatchPipeline,
    ImageFolderDataset,
    SampleQuarantine,
    SyntheticImageDataset,
    SyntheticTextDataset,
    TokenizedTextDataset,
    Tokenizer,
    device_normalizer_for,
    host_flip_transform,
    load_cifar10,
    make_device_normalizer,
    pack_documents,
    packed_loss_mask,
)
from pytorch_distributed_tpu_torch.generation import (
    generate,
    generate_beam,
    sample_logits,
)
from pytorch_distributed_tpu_torch.interop import (
    bert_params_from_jax,
    bert_params_to_jax,
    export_bert_weights,
    export_gemma_weights,
    export_gpt2_weights,
    export_llama_weights,
    export_mistral_weights,
    export_mixtral_weights,
    export_neox_weights,
    export_phi3_weights,
    export_qwen2_weights,
    export_qwen3_weights,
    export_vit_weights,
    gpt2_params_from_jax,
    gpt2_params_to_jax,
    llama_params_from_jax,
    llama_params_to_jax,
    load_bert_weights,
    load_gemma_weights,
    load_gpt2_weights,
    load_llama_weights,
    load_mistral_weights,
    load_mixtral_weights,
    load_neox_weights,
    load_phi3_weights,
    load_qwen2_weights,
    load_qwen3_weights,
    load_t5_weights,
    export_t5_weights,
    load_vit_weights,
    lora_params_from_jax,
    lora_params_to_jax,
    mixtral_params_from_jax,
    mixtral_params_to_jax,
    neox_params_from_jax,
    neox_params_to_jax,
    quantized_params_from_jax,
    quantized_params_to_jax,
    resnet_params_from_jax,
    resnet_params_to_jax,
    t5_params_from_jax,
    t5_params_to_jax,
    vit_params_from_jax,
    vit_params_to_jax,
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
from pytorch_distributed_tpu_torch.models import (
    GemmaConfig,
    GemmaForCausalLM,
    LlamaConfig,
    LlamaForCausalLM,
    MistralConfig,
    MistralForCausalLM,
    MixtralConfig,
    MixtralForCausalLM,
    NeoXConfig,
    NeoXForCausalLM,
    Phi3Config,
    Phi3ForCausalLM,
    Qwen2Config,
    Qwen2ForCausalLM,
    Qwen3Config,
    Qwen3ForCausalLM,
    T5Config,
    T5ForConditionalGeneration,
    ViT,
    ViTConfig,
    bert_partition_rules,
    gemma_partition_rules,
    gpt2_partition_rules,
    llama_partition_rules,
    mistral_partition_rules,
    mixtral_partition_rules,
    neox_partition_rules,
    phi3_partition_rules,
    qwen2_partition_rules,
    qwen3_partition_rules,
    generate_encdec,
    shift_right,
    t5_partition_rules,
    vit_partition_rules,
)
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
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
from pytorch_distributed_tpu_torch.ops.moe import MoEMLP, moe_partition_rules
from pytorch_distributed_tpu_torch.ops.paged_attention import paged_attention
from pytorch_distributed_tpu_torch.parallel import (
    FSDP,
    DataParallel,
    ZeRO1,
    compress_hook,
    disable_sequence_parallel,
    enable_sequence_parallel,
    ring_attention,
    sequence_parallel,
    sequence_parallel_mode,
    sync_grads,
    pipeline_forward,
    ulysses_attention,
)
from pytorch_distributed_tpu_torch.parallel.pipeline_lm import (
    PipelineParallel,
    gpt2_pipeline_logits,
    pipelined_causal_lm_loss_fn,
)
from pytorch_distributed_tpu_torch.parallel.pipeline_schedule import (
    HostPipelineStep,
)
from pytorch_distributed_tpu_torch.runtime.device import (
    default_device,
    device_info,
    max_memory_allocated,
    memory_allocated,
    memory_stats,
    memory_summary,
)
from pytorch_distributed_tpu_torch.runtime.distributed import (
    ReduceOp,
    StageLink,
    Subgroup,
    all_gather,
    all_gather_into_tensor,
    all_gather_object,
    all_reduce,
    all_to_all,
    all_to_all_single,
    barrier,
    broadcast,
    broadcast_object_list,
    destroy_process_group,
    gather,
    get_backend,
    get_rank,
    get_world_size,
    init_process_group,
    is_initialized,
    monitored_barrier,
    new_group,
    permute,
    reduce,
    reduce_scatter,
    reduce_scatter_tensor,
    scatter,
    scatter_object_list,
)
from pytorch_distributed_tpu_torch.runtime.mesh import (
    MeshSpec,
    current_mesh,
    data_axes,
    make_mesh,
    mesh_axis_size,
    set_current_mesh,
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
    InProcPrefixStore,
    Request,
    RequestStatus,
    Router,
    ServeEngine,
    SpecConfig,
)
from pytorch_distributed_tpu_torch.train import (
    EX_TEMPFAIL,
    CheckpointCorrupted,
    MetricsWriter,
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
    read_metrics,
    seq2seq_eval_step,
    seq2seq_lm_loss_fn,
    restore_checkpoint,
    save_checkpoint,
    text_classification_loss_fn,
    topk_accuracy,
    verify_checkpoint,
)

__all__ = [
    "optim", "ArrayDataset", "DataLoader", "DistributedSampler",
    "FolderImagePipeline", "ImageBatchPipeline", "ImageFolderDataset",
    "SampleQuarantine", "load_cifar10",
    "SyntheticImageDataset", "SyntheticTextDataset", "TokenizedTextDataset",
    "Tokenizer", "device_normalizer_for",
    "host_flip_transform", "make_device_normalizer", "pack_documents",
    "packed_loss_mask", "generate", "generate_beam", "sample_logits",
    "generate_speculative", "LoRAModel", "lora_init", "lora_merge",
    "lora_param_count", "lora_params_from_jax", "lora_params_to_jax",
    "quantized_params_from_jax", "quantized_params_to_jax",
    "bert_params_from_jax",
    "bert_params_to_jax", "gpt2_params_from_jax",
    "gpt2_params_to_jax", "llama_params_from_jax", "llama_params_to_jax",
    "neox_params_from_jax", "neox_params_to_jax", "load_gpt2_weights",
    "export_gpt2_weights", "load_llama_weights", "export_llama_weights",
    "load_mistral_weights", "export_mistral_weights", "load_qwen2_weights",
    "export_qwen2_weights", "load_qwen3_weights", "export_qwen3_weights",
    "load_gemma_weights", "export_gemma_weights", "load_phi3_weights",
    "export_phi3_weights", "load_neox_weights", "export_neox_weights",
    "GemmaConfig", "GemmaForCausalLM", "MistralConfig",
    "MistralForCausalLM", "NeoXConfig", "NeoXForCausalLM", "Phi3Config",
    "Phi3ForCausalLM", "Qwen2Config", "Qwen2ForCausalLM", "Qwen3Config",
    "Qwen3ForCausalLM", "bert_partition_rules", "gemma_partition_rules",
    "gpt2_partition_rules", "llama_partition_rules",
    "mistral_partition_rules", "neox_partition_rules",
    "phi3_partition_rules", "qwen2_partition_rules",
    "qwen3_partition_rules",
    "MixtralConfig", "MixtralForCausalLM", "mixtral_partition_rules",
    "MoEMLP", "moe_partition_rules", "ViT", "ViTConfig",
    "vit_partition_rules", "load_mixtral_weights", "export_mixtral_weights",
    "mixtral_params_from_jax", "mixtral_params_to_jax", "load_vit_weights",
    "export_vit_weights", "vit_params_from_jax", "vit_params_to_jax",
    "load_bert_weights", "export_bert_weights", "T5Config",
    "T5ForConditionalGeneration", "generate_encdec", "shift_right",
    "t5_partition_rules", "load_t5_weights", "export_t5_weights",
    "t5_params_from_jax", "t5_params_to_jax", "seq2seq_lm_loss_fn",
    "seq2seq_eval_step",
    "memory_stats", "memory_allocated", "max_memory_allocated",
    "memory_summary", "current_mesh", "set_current_mesh", "mesh_axis_size",
    "resnet_params_from_jax",
    "resnet_params_to_jax", "BertConfig", "BertForMaskedLM",
    "BertForSequenceClassification", "BertModel", "mask_tokens",
    "GPT2Config",
    "GPT2LMHead", "LlamaConfig", "LlamaForCausalLM", "ResNet", "ResNet18",
    "ResNet34", "ResNet50", "ResNet101", "ResNet152", "attention",
    "flash_attention", "paged_attention", "FSDP", "DataParallel", "ZeRO1",
    "compress_hook", "sync_grads", "disable_sequence_parallel",
    "enable_sequence_parallel", "ring_attention", "sequence_parallel",
    "sequence_parallel_mode", "ulysses_attention", "pipeline_forward",
    "PipelineParallel", "gpt2_pipeline_logits",
    "pipelined_causal_lm_loss_fn", "HostPipelineStep", "StageLink",
    "default_device", "device_info", "ReduceOp", "all_gather",
    "all_gather_into_tensor", "all_reduce", "all_to_all",
    "all_to_all_single", "reduce_scatter", "reduce_scatter_tensor",
    "barrier", "Subgroup", "all_gather_object", "broadcast_object_list",
    "gather", "monitored_barrier", "new_group", "permute", "reduce",
    "scatter", "scatter_object_list",
    "broadcast", "destroy_process_group", "get_backend", "get_rank",
    "get_world_size", "init_process_group", "is_initialized", "MeshSpec",
    "data_axes", "make_mesh",
    "GradScaler", "Policy", "ScalerState", "autocast", "current_policy",
    "use_policy", "generator_for", "seed_all", "EngineConfig",
    "InProcPrefixStore", "Request", "RequestStatus", "Router",
    "ServeEngine", "SpecConfig", "EX_TEMPFAIL", "CheckpointCorrupted",
    "MetricsWriter", "read_metrics",
    "Preempted", "Trainer", "TrainerConfig", "TrainingDiverged",
    "TrainState", "accuracy", "build_train_step", "causal_lm_eval_step",
    "causal_lm_loss_fn", "classification_eval_step",
    "classification_loss_fn", "cross_entropy", "fit_elastic",
    "masked_lm_loss_fn", "restore_checkpoint", "save_checkpoint",
    "text_classification_loss_fn", "topk_accuracy",
    "verify_checkpoint",
]
