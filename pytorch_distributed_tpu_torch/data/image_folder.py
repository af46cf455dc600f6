"""Image folders: the port of ``pytorch_distributed_tpu/data/image_folder.py``.

``ImageFolderDataset`` indexes ``root/<class>/<image>`` (classes sorted,
torchvision's ``ImageFolder``); ``FolderImagePipeline`` is a
``DataLoader`` ``fetch`` that decodes with PIL in a thread pool (PIL's
decoders release the interpreter lock), then for training crops a
random scale and aspect (``RandomResizedCrop``), resizes to ``crop`` and
flips half, or for evaluation resizes the shorter side to ``resize`` and
center-crops; it ships uint8 (the card normalizes) or host-normalized
f32. Each sample's augmentation comes from a child of
``numpy.random.default_rng([seed, epoch, crc32(indices), n])`` spawned in
order, as in the JAX pipeline, so the batches are the JAX package's.

Faults: a transient read error is retried ``io_retries`` times with
backoff; a file that does not decode is quarantined
(``SampleQuarantine``, shared between pipelines over one disk) and its
slot takes the next readable sample, at most ``_PROBE_CAP`` fresh
decode attempts a slot; more than ``bad_sample_budget`` quarantined
samples raise ``BadSampleBudgetExceeded``.

PIL is imported inside the functions that decode: the package imports
without it.
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
import zlib
from typing import Optional, Sequence

import numpy as np

from pytorch_distributed_tpu_torch.data.native_pipeline import (
    SampleQuarantine,
    _StagingMixin,
    is_transient_io_error,
    make_device_normalizer,
    read_with_retries,
)
from pytorch_distributed_tpu_torch.runtime import faults

_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
_PROBE_CAP = 16  # fresh decode attempts per batch slot before giving up


class ImageFolderDataset:
    """Index of ``root/<class>/<image>`` files; decoding happens in the
    pipeline."""

    def __init__(self, root: str):
        self.root = root
        self.classes = sorted(d for d in os.listdir(root)
                              if os.path.isdir(os.path.join(root, d)))
        if not self.classes:
            raise ValueError(f"no class directories under {root!r}")
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples = []
        for c in self.classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(_EXTS):
                    self.samples.append((os.path.join(cdir, fn),
                                         self.class_to_idx[c]))
        if not self.samples:
            raise ValueError(f"no images found under {root!r}")

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int):
        """One decoded sample, uint8 HWC (tests; batches go through
        :class:`FolderImagePipeline`)."""
        from PIL import Image

        path, label = self.samples[int(i)]
        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGB"))
        return {"image": arr, "label": np.int32(label)}


class FolderImagePipeline(_StagingMixin):
    """``DataLoader`` ``fetch``: decode, crop, flip, ship uint8 (or f32
    with ``device_normalize=False``). See the module docstring.
    ``num_threads``: decode pool width (0: one per core, 1: in the
    calling thread)."""

    def __init__(
        self,
        crop: int,
        *,
        train: bool = True,
        resize: int = 256,
        mean: Sequence[float] = (0.485, 0.456, 0.406),
        std: Sequence[float] = (0.229, 0.224, 0.225),
        seed: int = 0,
        scale: tuple = (0.08, 1.0),
        ratio: tuple = (3 / 4, 4 / 3),
        device_normalize: bool = True,
        num_threads: int = 0,
        reuse_staging: Optional[bool] = None,
        io_retries: int = 2,
        retry_backoff_s: float = 0.05,
        bad_sample_budget: int = 100,
        quarantine: Optional[SampleQuarantine] = None,
    ):
        self.crop = crop
        self.train = train
        self.resize = resize
        self.mean = np.asarray(mean, np.float32) * 255.0
        self.stdinv = 1.0 / (np.asarray(std, np.float32) * 255.0)
        self.seed = seed
        self.scale = scale
        self.ratio = ratio
        self.device_normalize = device_normalize
        self.num_threads = num_threads
        self.io_retries = int(io_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.quarantine = (quarantine if quarantine is not None
                           else SampleQuarantine(bad_sample_budget))
        self._init_staging(reuse_staging)
        self.epoch = 0
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._executor_lock = threading.Lock()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _pool(self) -> concurrent.futures.ThreadPoolExecutor:
        with self._executor_lock:
            if self._executor is None:
                self._executor = concurrent.futures.ThreadPoolExecutor(
                    self.num_threads or (os.cpu_count() or 1),
                    thread_name_prefix="folder-decode")
            return self._executor

    def close(self) -> None:
        """Release the decode pool's threads (made again on next use)."""
        with self._executor_lock:
            ex, self._executor = self._executor, None
        if ex is not None:
            ex.shutdown(wait=True)

    def _train_crop(self, im, rng):
        from PIL import Image

        W, H = im.size
        area = W * H
        for _ in range(10):
            target = area * rng.uniform(*self.scale)
            ar = np.exp(rng.uniform(np.log(self.ratio[0]),
                                    np.log(self.ratio[1])))
            w = int(round(np.sqrt(target * ar)))
            h = int(round(np.sqrt(target / ar)))
            if 0 < w <= W and 0 < h <= H:
                x = rng.integers(0, W - w + 1)
                y = rng.integers(0, H - h + 1)
                box = (x, y, x + w, y + h)
                break
        else:   # the center square of the short side
            s = min(W, H)
            box = ((W - s) // 2, (H - s) // 2,
                   (W - s) // 2 + s, (H - s) // 2 + s)
        out = im.resize((self.crop, self.crop), Image.BILINEAR, box=box)
        if rng.random() < 0.5:
            out = out.transpose(Image.FLIP_LEFT_RIGHT)
        return out

    def _eval_crop(self, im):
        from PIL import Image

        W, H = im.size
        s = self.resize / min(W, H)
        im = im.resize((max(1, round(W * s)), max(1, round(H * s))),
                       Image.BILINEAR)
        W, H = im.size
        x, y = (W - self.crop) // 2, (H - self.crop) // 2
        return im.crop((x, y, x + self.crop, y + self.crop))

    def _decode(self, path: str):
        from PIL import Image

        def attempt():
            # data.fetch: a transient read error (retried); data.decode:
            # permanent rot (quarantined)
            faults.check("data.fetch", path=path)
            with Image.open(path) as im:
                faults.check("data.decode", path=path)
                return im.convert("RGB")   # materialized: safe after close

        return read_with_retries(attempt, retries=self.io_retries,
                                 backoff_s=self.retry_backoff_s, what=path)

    def __call__(self, dataset: ImageFolderDataset, indices: np.ndarray):
        idx = np.asarray(indices, np.int64)
        n = len(idx)
        # the f32 mode's uint8 decode buffer is not what ships: it never
        # comes from the ring, whose copies the loader would not register
        out = (self._out_buffer((n, self.crop, self.crop, 3), np.uint8)
               if self.device_normalize
               else np.empty((n, self.crop, self.crop, 3), np.uint8))
        labels = self._out_buffer((n,), np.int32)
        rng = np.random.default_rng(
            [self.seed, self.epoch, zlib.crc32(idx.tobytes()), n])
        rngs = rng.spawn(n) if self.train else [None] * n

        def work(j):
            # walk forward from the drawn index past quarantined and bad
            # samples, at most _PROBE_CAP fresh decode attempts
            n_samples = len(dataset.samples)
            im = None
            attempts = 0
            for probe in range(n_samples):
                path, label = dataset.samples[
                    (int(idx[j]) + probe) % n_samples]
                if path in self.quarantine:
                    continue
                if attempts >= _PROBE_CAP:
                    break
                attempts += 1
                try:
                    im = self._decode(path)
                    break
                except Exception as e:
                    reason = f"{type(e).__name__}: {e}"
                    if is_transient_io_error(e):
                        self.quarantine.note_transient(path, reason)
                    else:   # may raise BadSampleBudgetExceeded: the stop
                        self.quarantine.add(path, reason)
            if im is None:
                raise RuntimeError(
                    f"no readable sample found for index {int(idx[j])}: "
                    f"{attempts} probe(s) failed ({len(self.quarantine)} "
                    f"quarantined, {self.quarantine.transient_events} "
                    "transient substitutions): storage outage or dataset rot")
            im = (self._train_crop(im, rngs[j]) if self.train
                  else self._eval_crop(im))
            out[j] = np.asarray(im)
            labels[j] = label

        if self.num_threads == 1 or n <= 1:
            for j in range(n):
                work(j)
        else:
            list(self._pool().map(work, range(n)))   # raises a work error
        if self.device_normalize:
            batch = {"image": out, "label": labels}
        else:
            batch = {"image": (out.astype(np.float32) - self.mean)
                     * self.stdinv, "label": labels}
        self._finish_staging()
        return batch

    def device_normalizer(self):
        """The card's ``(px - mean) * stdinv`` for this pipeline's uint8
        batches (its mean and stdinv are in the 0..255 domain)."""
        return make_device_normalizer(self.mean, self.stdinv, scale=1.0)
