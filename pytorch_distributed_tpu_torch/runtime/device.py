"""Device discovery for the PyTorch/CUDA port.

The port runs on a CUDA card. Every entry point resolves its device
through :func:`resolve_device`: ``None`` means the card, and a machine
without one raises instead of carrying on quietly on the CPU. The CPU is
used only when the caller names it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import subprocess
from typing import Union

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

