"""The device half of ``pytorch_distributed_tpu/data/native_pipeline.py``:
normalize (and flip) raw uint8 image batches on the card.

The loader ships ``[B, H, W, C]`` uint8 pixels, a quarter of the bytes of
f32, and the train step's ``batch_transform`` turns them into
``(px * scale - mean) * stdinv`` in f32 on the card. With ``flip=True``
the transform first flips a random half of the images left to right, on
the raw uint8: it then takes ``(batch, generator)``, and the coin comes
from that ``torch.Generator`` (``build_train_step`` derives one from the
step), not from JAX's bits. ``host_flip_transform`` is the host-side
flip for f32 batches. ``ImageBatchPipeline``, the staging ring and the
native prefetch library are not ported (ROADMAP A2).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def flip_images(img: torch.Tensor, coin: torch.Tensor) -> torch.Tensor:
    """``img[b]`` flipped along W where ``coin[b]`` is true ([B, H, W, C])."""
    return torch.where(coin[:, None, None, None], img.flip(2), img)


def make_device_normalizer(mean, stdinv, *, key: str = "image",
                           scale: float = 1.0, flip: bool = False):
    """Batch transform ``(img * scale - mean) * stdinv`` for uint8 image
    batches (others pass through unchanged); with ``flip=True`` it takes
    ``(batch, generator=None, *, coin=None)`` and flips the images whose
    ``coin`` (drawn from ``generator`` unless given: one fair coin an
    image) is true, before normalizing."""
    mean = np.asarray(mean, np.float32)
    stdinv = np.asarray(stdinv, np.float32)

    def _normalize_img(img):
        if img.dtype != torch.uint8:
            return img
        c = img.shape[-1]
        if mean.size not in (1, c) or stdinv.size not in (1, c):
            raise ValueError(
                f"normalizer mean/std have {mean.size} channels "
                f"but the image has {c}"
            )
        m = torch.as_tensor(mean, device=img.device)
        s = torch.as_tensor(stdinv, device=img.device)
        return (img.to(torch.float32) * scale - m) * s

    if not flip:

        def normalize(batch):
            return {**batch, key: _normalize_img(batch[key])}

        return normalize

    def flip_normalize(batch, generator: Optional[torch.Generator] = None,
                       *, coin: Optional[torch.Tensor] = None):
        img = batch[key]
        if coin is None:
            coin = torch.rand(img.shape[0], generator=generator,
                              device=img.device) < 0.5
        return {**batch, key: _normalize_img(flip_images(img, coin))}

    # build_train_step hands a generator to transforms that carry this
    flip_normalize._ptd_takes_rng = True
    return flip_normalize


def device_normalizer_for(mean, std, *, flip: bool = False,
                          key: str = "image"):
    """Device normalizer from unit-domain (torchvision) mean/std for raw
    uint8 batches."""
    mean = np.asarray(mean, np.float32)
    stdinv = 1.0 / np.asarray(std, np.float32)
    return make_device_normalizer(
        mean, stdinv, key=key, scale=1.0 / 255.0, flip=flip
    )


def host_flip_transform(seed: int, *, key: str = "image"):
    """Host-side random horizontal flip, a DataLoader ``transform`` for
    numpy batches (the f32 counterpart of the fused device flip); the
    same draws as the JAX package's for the same seed."""
    rng = np.random.default_rng(seed)

    def transform(batch):
        flip = rng.random(batch[key].shape[0]) < 0.5
        batch[key] = np.where(
            flip[:, None, None, None], batch[key][:, :, ::-1, :], batch[key],
        )
        return batch

    return transform
