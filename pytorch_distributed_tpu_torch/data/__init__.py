"""The data layer the GPT-2 training slice uses."""

from pytorch_distributed_tpu_torch.data.datasets import (
    ArrayDataset,
    SyntheticTextDataset,
    stack_items,
)
from pytorch_distributed_tpu_torch.data.loader import DataLoader
from pytorch_distributed_tpu_torch.data.packing import (
    pack_documents,
    packed_loss_mask,
)
from pytorch_distributed_tpu_torch.data.sampler import GlobalBatchSampler

__all__ = [
    "ArrayDataset", "SyntheticTextDataset", "stack_items", "DataLoader",
    "pack_documents", "packed_loss_mask", "GlobalBatchSampler",
]
