"""Native batch assembly and the device normalizer: the port of
``pytorch_distributed_tpu/data/native_pipeline.py``.

The host half. ``native/prefetch.cpp`` is loaded through ctypes, built
at first use into the port's build directory
(``utils/native_build.build_native_library("prefetch")``; the
checked-in ``native/libprefetch.so`` is never loaded), and its calls
release the interpreter lock, so its threads use the host's cores.

* :class:`ImageBatchPipeline` is a ``DataLoader`` ``fetch``: it gathers
  a batch of uint8 ``[N, H, W, C]`` images, random-crops (after
  ``pad`` pixels of reflect padding, made once for the whole dataset)
  and flips them for training or center-crops them for evaluation, in
  one native pass, and ships raw uint8 (``device_normalize``, the
  default: the card normalizes) or host-normalized f32. The crop
  offsets and flips come from ``numpy.random.default_rng([seed, epoch,
  crc32(indices), n])`` in the JAX pipeline's draw order, so a batch is
  bitwise the JAX package's for the same dataset, seed, epoch and
  indices.
* :func:`gather_rows` is the threaded row gather.
* :class:`HostStagingRing` hands out reusable host batch buffers,
  pinned when a CUDA card is present. A buffer is reused only after
  the CUDA event recorded behind its ``non_blocking`` copy to the card
  has completed; one still being assembled or queued is never reused (a
  fresh one-shot buffer is handed out instead). A pipeline uses it when
  a loader that places batches on a CUDA card marks it device-fed.
* :class:`SampleQuarantine`, :class:`BadSampleBudgetExceeded`,
  :func:`is_transient_io_error` and :func:`read_with_retries` are the
  fault policy of the decoding pipelines (``data/image_folder.py``).

The device half normalizes (and flips) raw uint8 image batches on the
card: the train step's ``batch_transform`` turns ``[B, H, W, C]`` uint8
into ``(px * scale - mean) * stdinv`` in f32. With ``flip=True`` the
transform first flips a random half of the images left to right, on the
raw uint8: it then takes ``(batch, generator)``, and the coin comes from
that ``torch.Generator`` (``build_train_step`` derives one from the
step), not from JAX's bits. ``host_flip_transform`` is the host-side
flip for f32 batches.
"""

from __future__ import annotations

import ctypes
import errno
import threading
import time
import zlib
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from pytorch_distributed_tpu_torch.runtime import faults
from pytorch_distributed_tpu_torch.utils.logging import get_logger
from pytorch_distributed_tpu_torch.utils.native_build import (
    build_native_library,
)

logger = get_logger(__name__)

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _load() -> ctypes.CDLL:
    """``libprefetch`` built from ``native/prefetch.cpp``; a failed build
    raises (there is no numpy fallback)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_native_library("prefetch",
                                                   extra_flags=("-pthread",)))
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            lib.pf_gather_rows.argtypes = [p, ctypes.c_uint64, i64, p, i64,
                                           p, i32]
            lib.pf_gather_rows.restype = i32
            lib.pf_image_batch.argtypes = [p, i64, i32, i32, i32, p, i64, p,
                                           p, p, p, p, p, i32, i32, i32]
            lib.pf_image_batch.restype = i32
            lib.pf_image_batch_u8.argtypes = [p, i64, i32, i32, i32, p, i64,
                                              p, p, p, p, i32, i32, i32]
            lib.pf_image_batch_u8.restype = i32
            _lib = lib
    return _lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"prefetch {what} failed (rc={rc})")


# --------------------------------------------------------------------------
# Staging: reusable (pinned) host buffers, fenced by the copies' events.
# --------------------------------------------------------------------------
class HostStagingRing:
    """Rotating pool of ``depth`` host buffers per (shape, dtype).

    :meth:`get` returns the next buffer as a numpy array over a torch
    tensor (pinned when CUDA is available; :meth:`tensor_for` returns
    that tensor). A buffer is BUSY from ``get`` until the consumer
    registers the copy out of it (:meth:`register_transfer`, with the
    CUDA event recorded after the copy) or the pipeline releases it
    (:meth:`release`, host-fed); when rotation lands on a busy buffer,
    ``get`` hands out a fresh one-shot buffer instead. Before a
    registered buffer is handed out again, ``get`` waits for its event.
    A copy that aliases the buffer (a "copy" to the CPU) evicts it from
    the ring for good. Thread-safe."""

    def __init__(self, depth: int = 2):
        if depth < 2:
            raise ValueError(f"staging depth must be >= 2, got {depth}")
        self.depth = depth
        self._slots: Dict[tuple, list] = {}   # key -> [buffers, next]
        self._tensors: Dict[int, torch.Tensor] = {}   # data ptr -> tensor
        self._pending: Dict[int, object] = {}   # data ptr -> event
        self._busy: set = set()
        self._lock = threading.Lock()
        self.reused = 0      # buffers handed out again
        self.one_shot = 0    # fresh buffers because rotation hit a busy one
        self.waits = 0       # gets that waited for a copy's event

    @staticmethod
    def _alloc(shape, dtype) -> torch.Tensor:
        t = torch.from_numpy(np.empty(0, dtype))   # the torch dtype
        return torch.empty(tuple(shape), dtype=t.dtype,
                           pin_memory=torch.cuda.is_available())

    def get(self, shape, dtype) -> np.ndarray:
        key = (tuple(shape), np.dtype(dtype))
        event = None
        with self._lock:
            slots = self._slots.setdefault(key, [[], 0])
            bufs, i = slots
            if len(bufs) < self.depth:
                t = self._alloc(shape, dtype)
                bufs.append(t)
            else:
                slots[1] = (i + 1) % self.depth
                t = bufs[i]
                if t.data_ptr() in self._busy:
                    self.one_shot += 1
                    return self._alloc(shape, dtype).numpy()
                self.reused += 1
                event = self._pending.pop(t.data_ptr(), None)
            self._tensors[t.data_ptr()] = t
            self._busy.add(t.data_ptr())
        if event is not None:
            self.waits += 1
            event.synchronize()
        return t.numpy()

    def holds(self, t: torch.Tensor) -> bool:
        """Whether ``t`` is one of the ring's buffers."""
        with self._lock:
            return self._tensors.get(t.data_ptr()) is t

    def tensor_for(self, arr: np.ndarray) -> Optional[torch.Tensor]:
        """The ring's tensor behind ``arr`` (one of its buffers, whole),
        or None."""
        with self._lock:
            t = self._tensors.get(arr.ctypes.data)
        if t is None or t.numel() * t.element_size() != arr.nbytes:
            return None
        return t

    def register_transfer(self, host: torch.Tensor, placed: torch.Tensor,
                          event) -> None:
        """``placed`` is the copy out of ring buffer ``host``, complete
        when ``event`` is (``event.synchronize()`` waits for it)."""
        ptr = host.data_ptr()
        with self._lock:
            if ptr not in self._tensors:
                return
            if placed.data_ptr() == ptr:   # an alias: never reuse it
                self._evict(ptr)
                return
            self._pending[ptr] = event
            self._busy.discard(ptr)

    def release(self, arrays) -> None:
        """Host-fed: the pipeline finished these buffers; rotation may
        reuse them after ``depth - 1`` further gets."""
        with self._lock:
            for a in arrays:
                self._busy.discard(a.ctypes.data)

    def _evict(self, ptr: int) -> None:
        t = self._tensors.pop(ptr)
        for slots in self._slots.values():
            bufs = slots[0]
            if any(b is t for b in bufs):
                slots[0] = [b for b in bufs if b is not t]
                slots[1] = slots[1] % self.depth
        self._pending.pop(ptr, None)
        self._busy.discard(ptr)


class _StagingMixin:
    """Staging plumbing shared by the batch pipelines. ``reuse_staging``:
    True forces the ring, False forces fresh buffers, None (the
    default) uses it once a loader that places batches on a CUDA card
    marks the pipeline device-fed. Such a pipeline's buffers are
    rewritten by later fetches: a direct call's batch is valid until the
    ring wraps."""

    reuse_staging: Optional[bool] = None
    _staging: Optional[HostStagingRing] = None
    _staging_depth = 2
    _device_fed = False

    def _init_staging(self, reuse_staging) -> None:
        self.reuse_staging = reuse_staging
        self._staging_tls = threading.local()
        self._staging_lock = threading.Lock()

    def mark_device_fed(self, depth: int = 2) -> None:
        """DataLoader hook: every batch is copied to the card and its copy
        registered before the ring wraps ``depth`` buffers."""
        self._device_fed = True
        self._staging_depth = max(self._staging_depth, depth)

    @property
    def staging_active(self) -> bool:
        if self.reuse_staging is not None:
            return bool(self.reuse_staging)
        return self._device_fed

    @property
    def staging_ring(self) -> Optional[HostStagingRing]:
        return self._staging

    def _out_buffer(self, shape, dtype) -> np.ndarray:
        if not self.staging_active:
            return np.empty(shape, dtype)
        with self._staging_lock:
            if (self._staging is None
                    or self._staging.depth < self._staging_depth):
                self._staging = HostStagingRing(self._staging_depth)
        buf = self._staging.get(shape, dtype)
        self._call_bufs().append(buf)
        return buf

    def _call_bufs(self) -> list:
        tls = self._staging_tls
        if not hasattr(tls, "bufs"):
            tls.bufs = []
        return tls.bufs

    def _finish_staging(self) -> None:
        """End of a fetch: host-fed buffers go back to rotation; device-fed
        ones stay busy until the loader registers their copies."""
        if self._staging is None:
            return
        bufs = self._call_bufs()
        if bufs and not self._device_fed:
            self._staging.release(bufs)
        bufs.clear()


# --------------------------------------------------------------------------
# Fault policy for decoding pipelines.
# --------------------------------------------------------------------------
class BadSampleBudgetExceeded(RuntimeError):
    """More samples were quarantined than the budget allows: the data is
    damaged beyond a few rotten files."""


class SampleQuarantine:
    """Thread-safe registry of samples that failed to read or decode.

    Permanent rot (undecodable bytes, missing files) is quarantined and
    skipped from then on; more than ``budget`` quarantined samples
    raises :class:`BadSampleBudgetExceeded`. A transient error that
    outlasted its retries is substituted once (:meth:`note_transient`)
    and the sample stays eligible; more than ``transient_budget``
    (``10 * budget`` by default) such events raise too."""

    def __init__(self, budget: int = 100,
                 transient_budget: Optional[int] = None):
        if budget < 0:
            raise ValueError(f"bad-sample budget must be >= 0, got {budget}")
        self.budget = int(budget)
        self.transient_budget = (10 * self.budget if transient_budget is None
                                 else int(transient_budget))
        self._paths: set = set()
        self._lock = threading.Lock()
        self.transient_events = 0

    def __contains__(self, path: str) -> bool:
        with self._lock:
            return path in self._paths

    def __len__(self) -> int:
        with self._lock:
            return len(self._paths)

    @property
    def paths(self) -> list:
        with self._lock:
            return sorted(self._paths)

    def note_transient(self, path: str, reason: str) -> None:
        with self._lock:
            self.transient_events += 1
            count = self.transient_events
        logger.warning(
            "substituting sample %s for this batch after exhausted "
            "transient-I/O retries (%s): %d transient substitution(s) so "
            "far; the sample stays eligible", path, reason, count)
        if count > self.transient_budget:
            raise BadSampleBudgetExceeded(
                f"{count} transient-substitution events (ceiling "
                f"{self.transient_budget}): the storage is persistently "
                f"failing; latest: {path} ({reason})")

    def add(self, path: str, reason: str) -> None:
        with self._lock:
            if path in self._paths:
                return
            self._paths.add(path)
            count = len(self._paths)
        logger.warning(
            "quarantined unreadable/undecodable sample %s (%s): %d bad "
            "sample(s) so far (budget %d)", path, reason, count, self.budget)
        if count > self.budget:
            raise BadSampleBudgetExceeded(
                f"{count} samples quarantined (budget {self.budget}); latest:"
                f" {path} ({reason}); the dataset needs repair")


def is_transient_io_error(e: BaseException) -> bool:
    """Whether retrying the read may help: an OS error that carries an
    errno other than ENOENT/ENOTDIR (PIL's decode errors carry none),
    or the ``data.fetch`` fault site. Decode errors, missing files and
    the ``data.decode`` site are permanent."""
    if isinstance(e, faults.InjectedFault):
        return e.site == "data.fetch"
    try:
        from PIL import UnidentifiedImageError
    except ImportError:   # no PIL: no PIL error to tell apart
        UnidentifiedImageError = ()
    if isinstance(e, UnidentifiedImageError):
        return False
    return (isinstance(e, OSError) and e.errno is not None
            and e.errno not in (errno.ENOENT, errno.ENOTDIR))


def read_with_retries(fn: Callable[[], object], *, retries: int = 2,
                      backoff_s: float = 0.05, max_backoff_s: float = 1.0,
                      what: str = ""):
    """``fn()``, retried with capped exponential backoff on transient
    errors; permanent errors and exhausted retries propagate."""
    delay = backoff_s
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception as e:
            if attempt >= retries or not is_transient_io_error(e):
                raise
            logger.warning(
                "transient read error on %s (attempt %d/%d): %s; retrying "
                "in %.2fs", what or "<sample>", attempt + 1, retries + 1, e,
                delay)
            time.sleep(delay)
            delay = min(delay * 2.0, max_backoff_s)


# --------------------------------------------------------------------------
# The native gathers.
# --------------------------------------------------------------------------
def gather_rows(src: np.ndarray, indices, num_threads: int = 0,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """``out[i] = src[indices[i]]`` by threaded memcpy, outside the
    interpreter lock. ``out``: a preallocated destination (a staging
    buffer)."""
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(indices, np.int64)
    if out is None:
        out = np.empty((len(idx),) + src.shape[1:], src.dtype)
    elif (out.shape != (len(idx),) + src.shape[1:]
          or out.dtype != src.dtype or not out.flags.c_contiguous):
        raise ValueError("gather_rows out buffer has the wrong shape/dtype")
    row_bytes = src.strides[0] if src.ndim > 1 else src.itemsize
    _check(_load().pf_gather_rows(_ptr(src), row_bytes, src.shape[0],
                                  _ptr(idx), len(idx), _ptr(out),
                                  num_threads), "gather_rows")
    return out


class ImageBatchPipeline(_StagingMixin):
    """``DataLoader`` ``fetch`` over a dataset with uint8 images ``[N, H,
    W, C]`` and int labels in ``dataset.arrays``: ``{"image": [B, crop,
    crop, C], "label": int32 [B]}``, uint8 with ``device_normalize`` (the
    default; apply :meth:`device_normalizer` in the step), host
    ``(px / 255 - mean) * stdinv`` f32 otherwise. ``train``: random crop
    (inside the source, after ``pad`` pixels of reflect padding) and,
    with ``flip``, a random horizontal flip; else a center crop."""

    def __init__(
        self,
        crop: int,
        *,
        train: bool = True,
        flip: bool = True,
        pad: int = 0,
        mean: Sequence[float] = (0.485, 0.456, 0.406),
        std: Sequence[float] = (0.229, 0.224, 0.225),
        seed: int = 0,
        num_threads: int = 0,
        image_key: str = "image",
        label_key: str = "label",
        device_normalize: bool = True,
        reuse_staging: Optional[bool] = None,
    ):
        self.crop = crop
        self.train = train
        self.flip = flip
        self.pad = pad
        self.mean = np.asarray(mean, np.float32)
        self.stdinv = 1.0 / np.asarray(std, np.float32)
        self.seed = seed
        self.num_threads = num_threads
        self.image_key = image_key
        self.label_key = label_key
        self.device_normalize = device_normalize
        self._init_staging(reuse_staging)
        self.epoch = 0
        self._padded: Optional[np.ndarray] = None

    def device_normalizer(self):
        """The batch transform that normalizes this pipeline's uint8
        batches on the card."""
        return make_device_normalizer(self.mean, self.stdinv,
                                      key=self.image_key, scale=1.0 / 255.0)

    def set_epoch(self, epoch: int) -> None:
        """Advance the augmentation stream (the loader forwards this)."""
        self.epoch = epoch

    def _source(self, dataset) -> np.ndarray:
        imgs = dataset.arrays[self.image_key]
        if self.pad:
            if self._padded is None:
                p = self.pad
                self._padded = np.pad(
                    imgs, ((0, 0), (p, p), (p, p), (0, 0)), mode="reflect")
            return self._padded
        if not imgs.flags.c_contiguous:
            imgs = np.ascontiguousarray(imgs)
            dataset.arrays[self.image_key] = imgs   # the copy, once
        return imgs

    def __call__(self, dataset, indices: np.ndarray):
        imgs = self._source(dataset)
        if imgs.dtype != np.uint8:
            raise TypeError(
                f"native image pipeline needs uint8 images, got {imgs.dtype}")
        idx = np.ascontiguousarray(indices, np.int64)
        n = len(idx)
        N, H, W, C = imgs.shape
        crop = self.crop
        if self.train:
            rng = np.random.default_rng(
                [self.seed, self.epoch, zlib.crc32(idx.tobytes()), n])
            cy = rng.integers(0, H - crop + 1, size=n, dtype=np.int32)
            cx = rng.integers(0, W - crop + 1, size=n, dtype=np.int32)
            fl = (rng.integers(0, 2, size=n, dtype=np.uint8) if self.flip
                  else np.zeros(n, np.uint8))
        else:
            cy = np.full(n, (H - crop) // 2, np.int32)
            cx = np.full(n, (W - crop) // 2, np.int32)
            fl = np.zeros(n, np.uint8)
        args = (_ptr(imgs), N, H, W, C, _ptr(idx), n, _ptr(cy), _ptr(cx),
                _ptr(fl))
        if self.device_normalize:
            out = self._out_buffer((n, crop, crop, C), np.uint8)
            _check(_load().pf_image_batch_u8(*args, _ptr(out), crop, crop,
                                             self.num_threads),
                   "image_batch_u8")
        else:
            out = self._out_buffer((n, crop, crop, C), np.float32)
            mean = np.ascontiguousarray(np.broadcast_to(self.mean, (C,)),
                                        np.float32)
            stdinv = np.ascontiguousarray(
                np.broadcast_to(self.stdinv, (C,)), np.float32)
            _check(_load().pf_image_batch(*args, _ptr(mean), _ptr(stdinv),
                                          _ptr(out), crop, crop,
                                          self.num_threads), "image_batch")
        batch = {self.image_key: out}
        labels = dataset.arrays.get(self.label_key)
        if labels is not None:
            labels = np.ascontiguousarray(labels)
            if labels.dtype == np.int32 and self.staging_active:
                batch[self.label_key] = gather_rows(
                    labels, idx, self.num_threads,
                    out=self._out_buffer((n,) + labels.shape[1:], np.int32))
            else:
                batch[self.label_key] = gather_rows(
                    labels, idx, self.num_threads).astype(np.int32)
        self._finish_staging()
        return batch


# --------------------------------------------------------------------------
# The device half.
# --------------------------------------------------------------------------
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
