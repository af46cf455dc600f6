"""Device discovery for the PyTorch/CUDA port.

The port runs on a CUDA card. Every entry point resolves its device
through :func:`resolve_device`: ``None`` means the card, and a machine
without one raises instead of carrying on quietly on the CPU. The CPU is
used only when the caller names it (``device="cpu"``), as the tests do.

:func:`peak_flops` is the card's dense bf16 peak (the MFU denominator),
None off the card; :func:`memory_stats`, :func:`memory_allocated`,
:func:`max_memory_allocated` and :func:`memory_summary` read
``torch.cuda``'s allocator, as the JAX package's do its devices'.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def default_device() -> torch.device:
    """The CUDA card, or a ``RuntimeError`` when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run the port's plain PyTorch path on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> :func:`default_device`; anything else as given."""
    if device is None:
        return default_device()
    return torch.device(device)


def device_info() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them
    (``name, power.limit``, one line per card). Raises when
    ``nvidia-smi`` is missing or fails: a number measured on the card is
    only written down beside these two facts."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=30,
    )
    return out.stdout.strip()



#: dense bf16 (and fp16) tensor-core peak FLOP/s of a card, by
#: ``torch.cuda.get_device_name()``: NVIDIA's data sheet for the H100 SXM
#: part, without sparsity, at its full power limit of 700 W (a card set
#: below it runs slower under load; ``device_info`` prints the limit)
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def peak_flops(device: DeviceLike = None) -> Optional[float]:
    """The card's dense bf16 peak FLOP/s (:data:`PEAK_BF16_FLOPS`), or
    None off the card (no CUDA device, a CPU device) or for a card the
    table does not hold: the MFU denominator the JAX package's
    ``peak_flops`` is, per card."""
    if not torch.cuda.is_available():
        return None
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type != "cuda":
        return None
    return PEAK_BF16_FLOPS.get(torch.cuda.get_device_name(dev))


def _cuda_index(device: Optional[int]):
    return torch.cuda.current_device() if device is None else device


def memory_stats(device: Optional[int] = None) -> dict:
    """``torch.cuda.memory_stats`` of one card (the current one unless
    given); ``{}`` without a card."""
    if not torch.cuda.is_available():
        return {}
    return torch.cuda.memory_stats(_cuda_index(device))


def memory_allocated(device: Optional[int] = None) -> int:
    """Live bytes of the caching allocator on one card (0 without one)."""
    if not torch.cuda.is_available():
        return 0
    return torch.cuda.memory_allocated(_cuda_index(device))


def max_memory_allocated(device: Optional[int] = None) -> int:
    """Peak allocated bytes since the last ``reset_peak_memory_stats``
    (0 without a card)."""
    if not torch.cuda.is_available():
        return 0
    return torch.cuda.max_memory_allocated(_cuda_index(device))


def memory_summary(device: Optional[int] = None) -> str:
    """One line per card: allocated, peak and reserved bytes, and the
    card's total; the first thing to read on an out-of-memory error."""
    if not torch.cuda.is_available():
        return "no CUDA device"
    idx = range(torch.cuda.device_count()) if device is None else [device]
    lines = ["device                     in_use      peak  reserved     total"]
    for i in idx:
        gb = lambda v: f"{v / 1e9:8.2f}G"  # noqa: E731
        lines.append(
            f"cuda:{i} {torch.cuda.get_device_name(i)[:16]:17s} "
            f"{gb(torch.cuda.memory_allocated(i))} "
            f"{gb(torch.cuda.max_memory_allocated(i))} "
            f"{gb(torch.cuda.memory_reserved(i))} "
            f"{gb(torch.cuda.get_device_properties(i).total_memory)}")
    return "\n".join(lines)
