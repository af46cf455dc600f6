"""The image recipes of the port end to end on the CPU (gloo, a world of
one): BASELINE.json's first config, and the ResNet-50 recipe's flags
that this slice lifted.

* ``recipes/resnet18_cifar10.py --device cpu --backend gloo`` with
  CIFAR pickles present: the native pipeline feeds it (pad 4, crop and
  flip; raw uint8 normalized in the step), it trains and evaluates, and
  ``--metrics-path`` / ``--trace-dir`` write the JSONL records (train
  and eval splits, the span rollups) and ``trace.json``; with
  ``--synthetic`` (or no pickles) it trains on synthetic CIFAR-shaped
  data and says so; ``--grad-compress int8`` at world 1 trains as well.
* ``recipes/resnet50_imagenet.py --data-dir`` over PIL-written
  ``train/`` and ``val/`` folders (a truncated JPEG among them) with
  ``--ema-decay``, ``--tensorboard-dir``, ``--metrics-path`` and
  ``--strategy zero1``: it trains, quarantines the damaged file,
  evaluates the EMA shadow, and its event file reads back with every
  CRC checking.
"""

import glob
import logging
import os

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu_torch.data import ImageBatchPipeline
from pytorch_distributed_tpu_torch.recipes import (
    resnet18_cifar10,
    resnet50_imagenet,
)
from pytorch_distributed_tpu_torch.runtime import distributed as dist
from pytorch_distributed_tpu_torch.train import read_metrics
from pytorch_distributed_tpu_torch.utils.tensorboard import read_records
from tests import torch_dp_workers as workers
from tests.torch_image_files import write_cifar_pickles, write_image_folder

@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads, as the spawned ranks take
    (``torch_dp_workers.RANK_THREADS``): the test workers share the
    host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(workers.RANK_THREADS)
    yield
    torch.set_num_threads(threads)


BASE18 = ["--device", "cpu", "--backend", "gloo", "--batch-size", "8",
          "--steps-per-epoch", "2", "--epochs", "1", "--log-every", "1"]


def test_resnet18_recipe_trains_on_cifar_pickles(tmp_path):
    root = write_cifar_pickles(str(tmp_path / "data"), per_batch=8,
                               n_test=10, seed=1)
    metrics, trace = str(tmp_path / "m.jsonl"), str(tmp_path / "trace")
    trainer = resnet18_cifar10.main(
        BASE18 + ["--data-dir", root, "--metrics-path", metrics,
                  "--trace-dir", trace])
    assert not dist.is_initialized()
    assert trainer.state.step == 2 and len(trainer.history) == 2
    assert isinstance(trainer.train_loader.fetch, ImageBatchPipeline)
    assert trainer.train_loader.fetch.pad == 4
    assert all(np.isfinite(r["loss"]) for r in trainer.history)
    assert set(trainer.last_eval_metrics) == {"loss", "accuracy",
                                              "top5_accuracy"}
    recs = read_metrics(metrics)
    splits = [r["split"] for r in recs]
    assert splits[:3] == ["train", "train", "eval"]
    assert {r["span"] for r in recs if r["split"] == "trace"} >= {
        "train.step", "train.data_wait", "ingest.fetch", "train.eval"}
    assert recs[1]["step"] == 2 and "step_time_ms" in recs[1]
    assert os.path.exists(os.path.join(trace, "trace.json"))


@pytest.mark.parametrize("extra", [["--synthetic"], ["--data-dir", "nowhere",
                                                      "--grad-compress",
                                                      "int8"]],
                         ids=["synthetic", "no_pickles_int8"])
def test_resnet18_recipe_falls_back_to_synthetic(extra, caplog):
    # the port's loggers do not propagate: listen on the recipe's own
    recipe_log = logging.getLogger(resnet18_cifar10.__name__)
    recipe_log.addHandler(caplog.handler)
    try:
        trainer = resnet18_cifar10.main(BASE18 + extra)
    finally:
        recipe_log.removeHandler(caplog.handler)
    assert trainer.state.step == 2
    assert trainer.train_loader.fetch is None
    assert all(np.isfinite(r["loss"]) for r in trainer.history)
    assert "using synthetic data" in caplog.text


def test_resnet50_recipe_folders_ema_tensorboard_zero1(tmp_path):
    root = str(tmp_path / "imagenet")
    bad = write_image_folder(os.path.join(root, "train"), classes=3,
                             per_class=4, seed=2, size=(48, 40),
                             bad=[(1, 1, "truncated")])
    write_image_folder(os.path.join(root, "val"), classes=3, per_class=2,
                       seed=3, size=(48, 40))
    tb, metrics = str(tmp_path / "tb"), str(tmp_path / "m.jsonl")
    trainer = resnet50_imagenet.main([
        "--device", "cpu", "--image-size", "32", "--batch-size", "4",
        "--epochs", "1", "--log-every", "1", "--data-dir", root,
        "--ema-decay", "0.9", "--tensorboard-dir", tb, "--metrics-path",
        metrics, "--strategy", "zero1", "--io-retries", "1",
        "--bad-sample-budget", "2"])
    assert trainer.state.step == 3    # 12 train images, batch 4
    assert trainer.config.eval_with_ema and trainer.state.ema_params
    assert trainer.train_loader.fetch.quarantine.paths == bad
    assert type(trainer.state.optimizer).__name__ == (
        "ZeroRedundancyOptimizer")
    assert all(np.isfinite(r["loss"]) for r in trainer.history)
    (events,) = glob.glob(os.path.join(tb, "events.out.tfevents.*"))
    assert len(read_records(events)) == 1 + 3 + 1   # version, 3 logs, eval
    evals = [r for r in read_metrics(metrics) if r["split"] == "eval"]
    assert len(evals) == 1 and evals[0]["loss"] == pytest.approx(
        trainer.last_eval_metrics["loss"])
