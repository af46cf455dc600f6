"""Parallelism strategies of the port: data parallelism (DDP, ZeRO-1,
FSDP, with tensor parallelism over ``tp``), the compressed gradient sync,
sequence parallelism (ring and Ulysses attention), pipeline parallelism
(``pipeline_forward``'s GPipe form; GPT-2's in ``parallel.pipeline_lm``,
the host 1F1B executor in ``parallel.pipeline_schedule``), and the
partition rules and their inference."""

from pytorch_distributed_tpu_torch.parallel.ddp import (
    compress_hook,
    no_sync,
    sync_grads,
)
from pytorch_distributed_tpu_torch.parallel.pipeline import (
    merge_microbatches,
    pipeline_forward,
    split_microbatches,
)
from pytorch_distributed_tpu_torch.parallel.rules import (
    PartitionSpec,
    TensorRule,
    compile_rule,
    engine_rules,
    max_divisible_tp,
    replicated_rule,
)
from pytorch_distributed_tpu_torch.parallel.sequence import (
    disable_sequence_parallel,
    enable_sequence_parallel,
    ring_attention,
    sequence_parallel,
    sequence_parallel_attention,
    sequence_parallel_mode,
    ulysses_attention,
)
from pytorch_distributed_tpu_torch.parallel.sharding import (
    REPLICATED,
    PartitionRules,
    infer_opt_tree_shardings,
    infer_placements,
    infer_sharding,
    infer_tree_shardings,
    path_str,
    shard_along,
    stacked,
)
from pytorch_distributed_tpu_torch.parallel.strategies import (
    FSDP,
    DataParallel,
    ZeRO1,
    ZeroShards,
    tp_plan,
)

__all__ = ["DataParallel", "ZeRO1", "ZeroShards", "FSDP", "tp_plan",
           "compress_hook",
           "no_sync", "sync_grads", "pipeline_forward",
           "split_microbatches", "merge_microbatches", "PartitionSpec", "TensorRule",
           "compile_rule", "engine_rules", "max_divisible_tp",
           "replicated_rule", "disable_sequence_parallel",
           "enable_sequence_parallel", "ring_attention", "sequence_parallel",
           "sequence_parallel_attention", "sequence_parallel_mode",
           "ulysses_attention", "REPLICATED", "PartitionRules",
           "infer_opt_tree_shardings", "infer_placements", "infer_sharding",
           "infer_tree_shardings", "path_str", "shard_along", "stacked"]
