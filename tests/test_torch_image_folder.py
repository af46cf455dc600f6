"""The port's image folders (``data/image_folder.py``) against the JAX
package's, on a folder written here with PIL: 3 classes of JPEGs and
PNGs, one JPEG cut in half and one empty file among them.

* ``ImageFolderDataset``: the same classes and samples.
* ``FolderImagePipeline``, train (random-resized crop and flip) and
  eval (resize and center crop), uint8 and f32: every batch bytewise the
  JAX one over two epochs, the two damaged files quarantined in both
  (their slots filled by the next readable sample), the same
  quarantined paths.
* The budget: with a budget of 1 both raise ``BadSampleBudgetExceeded``
  on the same batch.
* An injected transient read error (fault site ``data.fetch``) is
  retried the same number of times in both (counted in their sleeps),
  and a decode fault (``data.decode``) quarantines at once.
* ``DataLoader(fetch=FolderImagePipeline)`` feeds the same batches as
  the JAX loader.
"""

import time

import numpy as np
import pytest

from pytorch_distributed_tpu.data import DataLoader as JaxDataLoader
from pytorch_distributed_tpu.data.image_folder import (
    FolderImagePipeline as JaxFolderImagePipeline,
    ImageFolderDataset as JaxImageFolderDataset,
)
from pytorch_distributed_tpu.data.native_pipeline import (
    BadSampleBudgetExceeded as JaxBudgetExceeded,
)
from pytorch_distributed_tpu.runtime import faults as jax_faults
from pytorch_distributed_tpu_torch.data import (
    BadSampleBudgetExceeded,
    DataLoader,
    FolderImagePipeline,
    ImageFolderDataset,
)
from pytorch_distributed_tpu_torch.runtime import faults
from tests.torch_image_files import write_image_folder

BATCHES = (np.arange(8), np.array([10, 3, 3, 19, 0, 7]),
           np.array([17, 18, 19, 20]))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("folder"))
    damaged = write_image_folder(root, classes=3, per_class=7, seed=4,
                                 bad=[(1, 0, "truncated"), (2, 3, "empty")])
    return root, damaged


def _pair(root, **kw):
    return (ImageFolderDataset(root), FolderImagePipeline(24, **kw),
            JaxImageFolderDataset(root), JaxFolderImagePipeline(24, **kw))


def test_folder_index_is_the_jax_index(folder):
    root, _ = folder
    ds, jds = ImageFolderDataset(root), JaxImageFolderDataset(root)
    assert ds.classes == jds.classes == ["c0", "c1", "c2"]
    assert ds.samples == jds.samples and len(ds) == 21
    np.testing.assert_array_equal(ds[4]["image"], jds[4]["image"])


@pytest.mark.parametrize("device_normalize", [True, False],
                         ids=["uint8", "f32"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_folder_batches_and_quarantine_equal_jax(folder, train,
                                                 device_normalize):
    root, damaged = folder
    ds, pipe, jds, jpipe = _pair(root, train=train, resize=28, seed=3,
                                 device_normalize=device_normalize,
                                 num_threads=2)
    try:
        for epoch in (0, 1):
            pipe.set_epoch(epoch)
            jpipe.set_epoch(epoch)
            for idx in BATCHES:
                got, want = pipe(ds, idx), jpipe(jds, idx)
                for k in ("image", "label"):
                    assert got[k].dtype == want[k].dtype
                    np.testing.assert_array_equal(
                        got[k].view(np.uint8), want[k].view(np.uint8), k)
        assert pipe.quarantine.paths == jpipe.quarantine.paths == sorted(
            damaged)
    finally:
        pipe.close()
        jpipe.close()


def test_budget_exceeded_at_the_same_batch(folder):
    root, _ = folder
    raised = []
    for ds, pipe, exc in ((*_pair(root, bad_sample_budget=1,
                                  num_threads=1)[:2], BadSampleBudgetExceeded),
                          (*_pair(root, bad_sample_budget=1,
                                  num_threads=1)[2:], JaxBudgetExceeded)):
        for b, idx in enumerate((np.arange(5), np.arange(5, 15),
                                 np.arange(15, 21))):
            try:
                pipe(ds, idx)
            except exc:
                raised.append((b, len(pipe.quarantine)))
                break
    assert raised == [(2, 2), (2, 2)]


def test_transient_retries_and_decode_faults_match(folder, monkeypatch):
    root, _ = folder
    sleeps = []
    monkeypatch.setattr(time, "sleep", lambda s: sleeps.append(s))
    counts = []
    ds, pipe, jds, jpipe = _pair(root, train=False, num_threads=1,
                                 io_retries=3, retry_backoff_s=0.01)
    for arm, d, p in ((faults.injected, ds, pipe),
                      (jax_faults.injected, jds, jpipe)):
        sleeps.clear()
        with arm("data.fetch:count=2"):
            out = p(d, np.arange(4))
        counts.append((len(sleeps), list(sleeps), len(p.quarantine),
                       out["image"].tobytes()))
    assert counts[0] == counts[1]
    assert counts[0][0] == 2 and counts[0][1] == [0.01, 0.02]
    # a decode fault is permanent: quarantined, never retried
    for arm, d, p in ((faults.injected, ds, pipe),
                      (jax_faults.injected, jds, jpipe)):
        sleeps.clear()
        with arm("data.decode:count=1,match=img004"):
            p(d, np.arange(6))
        assert not sleeps
        assert [q.rsplit("/", 1)[1] for q in p.quarantine.paths] == [
            "img004.jpg"]


def test_loader_over_folders_equals_jax(folder):
    root, _ = folder
    ds, pipe, jds, jpipe = _pair(root, train=True, seed=1, num_threads=2)
    try:
        got = list(DataLoader(ds, 6, seed=2, fetch=pipe))
        want = list(JaxDataLoader(jds, 6, seed=2, fetch=jpipe))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["image"].numpy(), w["image"])
            np.testing.assert_array_equal(g["label"].numpy(), w["label"])
    finally:
        pipe.close()
        jpipe.close()
