"""Attention, the kernels' wrappers, the chunked-vocab loss and weight
quantization (the JAX package's ``ops``)."""

from pytorch_distributed_tpu_torch.ops.quant import (
    QuantizedModel,
    dequantize_tree,
    quantize_for_scan_dequant,
    quantize_tree_int4,
    quantize_tree_int8,
    quantized_apply_fn,
    quantized_bytes,
)

__all__ = [
    "QuantizedModel", "dequantize_tree", "quantize_for_scan_dequant",
    "quantize_tree_int4", "quantize_tree_int8", "quantized_apply_fn",
    "quantized_bytes",
]
