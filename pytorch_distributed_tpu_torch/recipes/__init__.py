"""Runnable entry points of the port (``python -m
pytorch_distributed_tpu_torch.recipes.<name>``)."""
