"""The data layer of the GPT-2 and ResNet training slices."""

from pytorch_distributed_tpu_torch.data.datasets import (
    ArrayDataset,
    SyntheticImageDataset,
    SyntheticTextDataset,
    stack_items,
)
from pytorch_distributed_tpu_torch.data.loader import DataLoader
from pytorch_distributed_tpu_torch.data.native_pipeline import (
    device_normalizer_for,
    host_flip_transform,
    make_device_normalizer,
)
from pytorch_distributed_tpu_torch.data.packing import (
    pack_documents,
    packed_loss_mask,
)
from pytorch_distributed_tpu_torch.data.sampler import (
    DistributedSampler,
    GlobalBatchSampler,
)
from pytorch_distributed_tpu_torch.data.tokenizer import (
    TokenizedTextDataset,
    Tokenizer,
)

__all__ = [
    "ArrayDataset", "SyntheticImageDataset", "SyntheticTextDataset",
    "stack_items", "DataLoader", "device_normalizer_for",
    "host_flip_transform", "make_device_normalizer", "pack_documents",
    "packed_loss_mask", "DistributedSampler", "GlobalBatchSampler",
    "TokenizedTextDataset", "Tokenizer",
]
