"""The data layer of the training slices: datasets (CIFAR-10 pickles,
image folders, synthetic and tokenized text), the prefetching loader,
the native and PIL batch pipelines, and the device normalizer."""

from pytorch_distributed_tpu_torch.data.datasets import (
    ArrayDataset,
    SyntheticImageDataset,
    SyntheticTextDataset,
    load_cifar10,
    stack_items,
)
from pytorch_distributed_tpu_torch.data.image_folder import (
    FolderImagePipeline,
    ImageFolderDataset,
)
from pytorch_distributed_tpu_torch.data.loader import DataLoader
from pytorch_distributed_tpu_torch.data.native_pipeline import (
    BadSampleBudgetExceeded,
    HostStagingRing,
    ImageBatchPipeline,
    SampleQuarantine,
    device_normalizer_for,
    gather_rows,
    host_flip_transform,
    is_transient_io_error,
    make_device_normalizer,
    read_with_retries,
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
    "load_cifar10", "stack_items", "FolderImagePipeline",
    "ImageFolderDataset", "DataLoader", "BadSampleBudgetExceeded",
    "HostStagingRing", "ImageBatchPipeline", "SampleQuarantine",
    "gather_rows", "is_transient_io_error", "read_with_retries",
    "device_normalizer_for",
    "host_flip_transform", "make_device_normalizer", "pack_documents",
    "packed_loss_mask", "DistributedSampler", "GlobalBatchSampler",
    "TokenizedTextDataset", "Tokenizer",
]
