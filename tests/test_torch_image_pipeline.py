"""The port's native image pipeline and the loader's hooks against the
JAX package's.

* ``load_cifar10`` on pickles written here: the port's arrays equal the
  JAX ones in both forms (raw uint8 and f32 in [0, 1]); with no pickles
  both return None.
* ``ImageBatchPipeline``, train and eval, with and without ``pad=4``,
  uint8 and host-normalized f32: for the same dataset, seed, epoch and
  indices the port's batch is bitwise the JAX batch (one native source,
  one draw order), and ``gather_rows`` is a row gather.
* ``DataLoader(fetch=...)``: the same batches as the JAX loader over an
  epoch, the epoch forwarded to the fetch (``set_epoch`` changes the
  crops); each rank's share is its strided slice, fetched as such;
  ``collate_fn`` replaces the stacking and refuses a ``fetch`` beside it.
* ``HostStagingRing``: rotation, the busy fallback, the wait on a
  registered copy's event before reuse, and eviction of an alias.
"""

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.data import DataLoader as JaxDataLoader
from pytorch_distributed_tpu.data.datasets import (
    load_cifar10 as jax_load_cifar10,
)
from pytorch_distributed_tpu.data.native_pipeline import (
    ImageBatchPipeline as JaxImageBatchPipeline,
)
from pytorch_distributed_tpu_torch.data import (
    ArrayDataset,
    DataLoader,
    HostStagingRing,
    ImageBatchPipeline,
    gather_rows,
    load_cifar10,
)
from pytorch_distributed_tpu_torch.data import loader as loader_mod
from tests.torch_image_files import write_cifar_pickles
from tests.torch_parity import assert_equal

CIFAR_MEAN, CIFAR_STD = (0.4914, 0.4822, 0.4465), (0.247, 0.243, 0.262)


@pytest.fixture(scope="module")
def cifar_root(tmp_path_factory):
    return write_cifar_pickles(str(tmp_path_factory.mktemp("cifar")),
                               per_batch=12, n_test=10, seed=3)


@pytest.mark.parametrize("raw", [True, False], ids=["uint8", "f32"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_load_cifar10_equals_jax(cifar_root, raw, train, tmp_path):
    got = load_cifar10(cifar_root, train=train, raw_uint8=raw)
    want = jax_load_cifar10(cifar_root, train=train, raw_uint8=raw)
    assert len(got) == len(want) == (60 if train else 10)
    for k in ("image", "label"):
        assert got.arrays[k].dtype == want.arrays[k].dtype
        np.testing.assert_array_equal(got.arrays[k], want.arrays[k])
    assert got.arrays["image"].shape[1:] == (32, 32, 3)
    assert load_cifar10(str(tmp_path), train=train) is None
    assert jax_load_cifar10(str(tmp_path), train=train) is None


def _dataset(seed=2, n=40, hw=(36, 34)):
    rng = np.random.default_rng(seed)
    return dict(image=rng.integers(0, 256, (n,) + hw + (3,), np.uint8),
                label=rng.integers(0, 10, n).astype(np.int32))


@pytest.mark.parametrize("device_normalize", [True, False],
                         ids=["uint8", "f32"])
@pytest.mark.parametrize("train,pad", [(True, 0), (True, 4), (False, 0)],
                         ids=["train", "train_pad4", "eval"])
def test_image_batch_pipeline_is_bitwise_jax(train, pad, device_normalize):
    arrays = _dataset()
    kw = dict(train=train, pad=pad, mean=CIFAR_MEAN, std=CIFAR_STD, seed=7,
              device_normalize=device_normalize)
    port, ref = ImageBatchPipeline(32, **kw), JaxImageBatchPipeline(32, **kw)
    for epoch in (0, 3):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for idx in (np.arange(8), np.array([39, 0, 17, 17, 5, 22])):
            got = port(ArrayDataset(**arrays), idx)
            want = ref(type("D", (), {"arrays": dict(arrays)})(), idx)
            for k in ("image", "label"):
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(
                    got[k].view(np.uint8), want[k].view(np.uint8), k)
    if train:   # the epoch moves the augmentation
        port.set_epoch(0)
        a = port(ArrayDataset(**arrays), np.arange(8))["image"].copy()
        port.set_epoch(1)
        b = port(ArrayDataset(**arrays), np.arange(8))["image"]
        assert not np.array_equal(a, b)


def test_gather_rows_is_a_row_gather():
    src = np.arange(5 * 6 * 4, dtype=np.float32).reshape(5, 6, 4)
    idx = np.array([4, 0, 0, 3])
    np.testing.assert_array_equal(gather_rows(src, idx), src[idx])
    out = np.empty((4, 6, 4), np.float32)
    assert gather_rows(src, idx, out=out) is out
    with pytest.raises(ValueError, match="wrong shape"):
        gather_rows(src, idx, out=np.empty((3, 6, 4), np.float32))
    with pytest.raises(RuntimeError, match="gather_rows failed"):
        gather_rows(src, np.array([5]))


def test_loader_fetch_batches_equal_jax_and_forward_the_epoch():
    arrays = _dataset(n=24, hw=(32, 32))
    kw = dict(train=True, pad=4, mean=CIFAR_MEAN, std=CIFAR_STD, seed=1)
    port = DataLoader(ArrayDataset(**arrays), 8, seed=5,
                      fetch=ImageBatchPipeline(32, **kw))
    ref = JaxDataLoader(type("D", (), {"arrays": dict(arrays),
                                       "__len__": lambda s: 24})(), 8,
                        seed=5, fetch=JaxImageBatchPipeline(32, **kw))
    epochs = []
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for k in ("image", "label"):
                assert_equal(g[k].numpy(), w[k], k)
        epochs.append(got[0]["image"].numpy())
    assert port.fetch.epoch == 1
    assert not np.array_equal(*epochs)


def test_rank_share_is_fetched_as_the_strided_slice(monkeypatch):
    arrays = _dataset(n=20, hw=(32, 32))
    seen = []

    def fetch(ds, idx):
        seen.append(np.asarray(idx).copy())
        return {k: v[idx] for k, v in ds.arrays.items()}

    monkeypatch.setattr(loader_mod.dist, "get_world_size", lambda: 3)
    monkeypatch.setattr(loader_mod.dist, "get_rank", lambda: 1)
    loader = DataLoader(ArrayDataset(**arrays), 8, shuffle=False,
                        fetch=fetch)
    batches = list(loader)
    assert [list(s) for s in seen] == [[1, 4], [9, 12]]
    assert_equal(batches[1]["label"].numpy(), arrays["label"][[9, 12]])


def test_collate_fn_replaces_the_stack():
    arrays = _dataset(n=6, hw=(4, 4))

    def collate(samples):
        return {"n": np.array([len(samples)]),
                "label": np.stack([s["label"] for s in samples]) + 100}

    loader = DataLoader(ArrayDataset(**arrays), 3, shuffle=False,
                        collate_fn=collate)
    got = list(loader)
    assert [int(b["n"][0]) for b in got] == [3, 3]
    assert_equal(got[0]["label"].numpy(), arrays["label"][:3] + 100)
    with pytest.raises(ValueError, match="collate_fn and fetch"):
        DataLoader(ArrayDataset(**arrays), 3, collate_fn=collate,
                   fetch=lambda d, i: None)


class _Event:
    def __init__(self):
        self.waited = False

    def synchronize(self):
        self.waited = True


def test_staging_ring_reuses_only_proven_buffers():
    ring = HostStagingRing(depth=2)
    a = ring.get((4, 3), np.uint8)
    b = ring.get((4, 3), np.uint8)
    assert a.ctypes.data != b.ctypes.data
    # both still busy (nothing registered): rotation hands out one-shots
    c = ring.get((4, 3), np.uint8)
    assert ring.one_shot == 1 and c.ctypes.data not in (a.ctypes.data,
                                                        b.ctypes.data)
    # rotation moved on to b; b's copy registered behind an event: b
    # comes back, after the wait
    tb = ring.tensor_for(b)
    assert ring.holds(tb) and tb.is_pinned() == torch.cuda.is_available()
    ev = _Event()
    ring.register_transfer(tb, tb.clone(), ev)
    again = ring.get((4, 3), np.uint8)
    assert again.ctypes.data == b.ctypes.data and ev.waited
    assert ring.reused == 1 and ring.waits == 1
    # a copy that aliases its buffer evicts it for good
    ta = ring.tensor_for(a)
    ring.register_transfer(ta, ta, None)
    assert not ring.holds(ta) and ring.tensor_for(a) is None
    # the evicted slot is refilled by a fresh buffer; a host-fed release
    # puts b back in rotation, without a wait
    ring.release([again])
    fresh = ring.get((4, 3), np.uint8)
    assert fresh.ctypes.data not in (a.ctypes.data, b.ctypes.data)
    ring.release([fresh])
    assert ring.get((4, 3), np.uint8).ctypes.data == b.ctypes.data
    assert ring.waits == 1
