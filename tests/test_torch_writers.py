"""The port's metric writers against the JAX package's.

* ``MetricsWriter``: the same (step, metrics, split) stream written by
  both gives the same records through either ``read_metrics`` (all but
  ``wall_time``), strings and numpy scalars included; a torn last line
  is skipped, or raises with ``strict``; ``TeeWriter`` fans out.
* ``TensorBoardWriter`` and ``SummaryWriter``: the port's event file,
  read with the installed ``tensorboard`` package's loader, holds the
  same (tag, step, value) as the JAX writer's; every record's CRCs
  check (``read_records``), a flipped byte fails them; a non-scalar
  value raises.
* The trainer writes rank 0's logged steps and evaluations.
"""

import glob
import os

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.train.metrics import (
    MetricsWriter as JaxMetricsWriter,
    read_metrics as jax_read_metrics,
)
from pytorch_distributed_tpu.utils.tensorboard import (
    SummaryWriter as JaxSummaryWriter,
    TensorBoardWriter as JaxTensorBoardWriter,
)
from pytorch_distributed_tpu_torch.train.metrics import (
    MetricsWriter,
    MeterState,
    ScalarMeter,
    TeeWriter,
    read_metrics,
)
from pytorch_distributed_tpu_torch.utils.tensorboard import (
    SummaryWriter,
    TensorBoardWriter,
    masked_crc32c,
    read_records,
)

STREAM = [
    (1, {"loss": 2.5, "accuracy": np.float32(0.125), "epoch": 0}, "train"),
    (2, {"loss": torch.tensor(2.25), "samples_per_sec": 1e3}, "train"),
    (2, {"loss": 1.75, "top5_accuracy": 0.5, "epoch": 0}, "eval"),
    (3, {"event": "span_rollup", "span": "train.step", "count": 3,
         "mean_ms": 1.5}, "trace"),
]


def _write(writer_cls, path):
    w = writer_cls(path)
    for step, metrics, split in STREAM:
        w.write(step, metrics, split=split)
    w.close()


def test_jsonl_records_equal_jax(tmp_path):
    ours, theirs = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    _write(MetricsWriter, ours)
    _write(JaxMetricsWriter, theirs)
    for reader in (read_metrics, jax_read_metrics):
        got, want = reader(ours), reader(theirs)
        assert len(got) == len(want) == len(STREAM)
        for g, w in zip(got, want):
            assert g.pop("wall_time") > 0 and w.pop("wall_time") > 0
            assert g == w
    # a torn last line: skipped, or raised with strict
    with open(ours, "a") as f:
        f.write('{"step": 4, "lo')
    assert len(read_metrics(ours)) == len(STREAM)
    with pytest.raises(ValueError):
        read_metrics(ours, strict=True)


def test_tee_writer_and_meter(tmp_path):
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    with TeeWriter([MetricsWriter(a), MetricsWriter(b)]) as tee:
        tee.write(5, {"loss": 1.0}, split="eval")
    assert [r["split"] for r in read_metrics(a) + read_metrics(b)] == [
        "eval", "eval"]
    meter = ScalarMeter(window=4)
    for dt in (0.1, 0.2, 0.3):
        meter.update(MeterState(step_time=dt, samples_per_sec=10 / dt))
    s = meter.summary()
    assert abs(s["step_time_ms"] - 200.0) < 1e-9
    assert abs(s["step_time_p50_ms"] - 200.0) < 1e-9


def _events(logdir):
    from tensorboard.backend.event_processing.event_file_loader import (
        LegacyEventFileLoader,
    )

    (path,) = glob.glob(os.path.join(logdir, "events.out.tfevents.*"))
    out = []
    for ev in LegacyEventFileLoader(path).Load():
        for v in ev.summary.value:
            out.append((v.tag, ev.step, v.simple_value))
    return path, out


def test_event_files_read_as_the_jax_ones(tmp_path):
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    _write(TensorBoardWriter, ours)
    _write(JaxTensorBoardWriter, theirs)
    path, got = _events(ours)
    _, want = _events(theirs)
    assert got == want and len(got) == 10
    records = read_records(path)
    assert len(records) == 1 + 4   # the version event, then one a write
    # a flipped payload byte fails its CRC
    data = bytearray(open(path, "rb").read())
    data[-6] ^= 0xFF
    bad = str(tmp_path / "bad")
    open(bad, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_records(bad)
    assert masked_crc32c(b"") == 0xA282EAD8   # CRC32C("") = 0


def test_summary_writer_scalars_equal_jax(tmp_path):
    for cls, d in ((SummaryWriter, "port"), (JaxSummaryWriter, "jax")):
        w = cls(str(tmp_path / d))
        w.add_scalar("lr", 0.1, global_step=3)
        w.add_scalars("loss", {"train": 1.5, "eval": 2.0}, global_step=4)
        w.close()
    assert _events(str(tmp_path / "port"))[1] == _events(
        str(tmp_path / "jax"))[1]
    w = SummaryWriter(str(tmp_path / "raise"))
    with pytest.raises(TypeError, match="scalars only"):
        w.add_scalar("img", torch.zeros(2, 2))
    with pytest.raises(TypeError, match="scalars only"):
        w.add_scalar("name", "text")
    w.close()
