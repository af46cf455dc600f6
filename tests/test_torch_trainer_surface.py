"""The Trainer's lifecycle (``train/trainer.py``) against the JAX
package's.

* Decisions: on the same sequence of evaluation metrics (confusion
  rates that ``f1_finalize`` turns into F1), the port's ``fit`` saves
  ``best``, evaluates every ``eval_every_epochs`` and stops early where
  the JAX trainer's ``_maybe_save_best`` and ``_early_stop_triggered``,
  called in its ``fit``'s order, do.
* Goodput: ``summarize_goodput`` equals the JAX function's dict on the
  same records, and the record ``fit`` writes has buckets that sum to
  its ``wall_s``.
* The watchdog fires on a stall in the loop's data fetch and goodput's
  ``stalled`` holds the window; a stall inside the step itself is the
  step's (productive) time, as the JAX trainer retracts it.
* ``trace_dir`` + ``trace_steps`` writes a Chrome trace that parses.
* ``log_mfu`` on the CPU counts the step's FLOPs, logs that MFU is off
  (no peak for the CPU) and leaves the state equal to the bit to a run
  without it.
* The runtime pieces: ``deferred_signals`` holds a SIGTERM until its
  block ends; the tracer's ``instant``, ``name_thread``,
  ``note_compiles`` and ``set_meta`` land in the export; ``StepTimer``'s
  summary equals the JAX one's; ``peak_flops`` is None off the card and
  the H100's dense bf16 peak on it.
* The slice's losses are held in tests/test_torch_slice_losses.py.
* The recipes: the ResNet-50 recipe's ``Config`` has every field of the
  JAX recipe's ``Config``, refuses ``--fsdp``/``--tp`` above 1 and
  ``--strategy auto`` naming A10, and runs the lifecycle flags.
"""

import dataclasses
import json
import logging
import math
import os
import time

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.runtime import tracing as jtracing
from pytorch_distributed_tpu.train import losses as jlosses
from pytorch_distributed_tpu.train.trainer import (
    Trainer as JaxTrainer,
    TrainerConfig as JaxTrainerConfig,
)
from pytorch_distributed_tpu_torch import optim
from pytorch_distributed_tpu_torch.data import ArrayDataset, DataLoader
from pytorch_distributed_tpu_torch.runtime import tracing
from pytorch_distributed_tpu_torch.train import (
    Trainer,
    TrainerConfig,
    TrainState,
    build_train_step,
    read_metrics,
)
from pytorch_distributed_tpu_torch.train import losses
from pytorch_distributed_tpu_torch.train import trainer as trainer_mod
from tests.torch_dp_workers import RANK_THREADS


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads, as the spawned ranks take
    (``torch_dp_workers.RANK_THREADS``): the test workers share the
    host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(RANK_THREADS)
    yield
    torch.set_num_threads(threads)

# -- a tiny trainable setup --------------------------------------------------


def _setup(config, *, loader=None, eval_metrics=None, seed=0):
    torch.manual_seed(seed)
    model = torch.nn.Linear(4, 2)
    opt = optim.AdamW(model, lr=1e-2)

    def loss_fn(batch, generator):
        loss = (model(batch["x"]) - batch["y"]).square().mean()
        return loss, {"metrics": {"loss": loss.detach()}}

    rng = np.random.default_rng(seed)
    ds = ArrayDataset(x=rng.standard_normal((16, 4)).astype(np.float32),
                      y=rng.standard_normal((16, 2)).astype(np.float32))
    evals = iter(eval_metrics or ())

    def eval_step(state, batch):
        return {k: torch.tensor(v) for k, v in next(evals).items()}

    return Trainer(
        TrainState(model, opt), build_train_step(loss_fn),
        loader or DataLoader(ds, 4, seed=seed),
        eval_step=eval_step if eval_metrics is not None else None,
        eval_loader=[{"x": torch.zeros(1)}] if eval_metrics else None,
        config=config)


RATES = [   # one evaluation's confusion rates each
    (0.30, 0.10, 0.20, 0.40), (0.35, 0.10, 0.15, 0.40),
    (0.32, 0.12, 0.18, 0.38), (0.36, 0.04, 0.14, 0.46),
    (0.36, 0.05, 0.14, 0.45), (0.30, 0.20, 0.20, 0.30),
    (0.20, 0.20, 0.30, 0.30), (0.40, 0.02, 0.10, 0.48),
]


def _rates(r):
    return dict(zip(("tp_rate", "fp_rate", "fn_rate", "tn_rate"), r))


def _jax_decisions(n_epochs, every, patience, mode):
    """The JAX trainer's saves over the fit loop, its own methods called
    in its fit's order (evaluate -> _maybe_save_best, then
    _early_stop_triggered, then the epoch's save)."""
    t = object.__new__(JaxTrainer)
    t.config = JaxTrainerConfig(keep_best="f1", best_mode=mode,
                                early_stop_patience=patience,
                                eval_every_epochs=every, ckpt_dir="x",
                                eval_finalize=jlosses.f1_finalize)
    t._best_value, t._es_best, t._es_stale = None, None, 0
    saves = []
    t.save_checkpoint = lambda tag="latest": saves.append((t.host_step, tag))
    t._write_best_record = lambda value: None
    evals = iter(RATES)
    for epoch in range(n_epochs):
        t.host_step = epoch + 1
        if (epoch + 1) % every == 0:
            means = t.config.eval_finalize(_rates(next(evals)))
            t._maybe_save_best(means)
            if t._early_stop_triggered(means):
                t.save_checkpoint()
                break
        t.save_checkpoint()
    return saves


@pytest.mark.parametrize("every, patience, mode", [
    (1, 2, "max"), (2, 1, "max"), (1, 3, "min"), (1, 8, "max")])
def test_best_early_stop_and_eval_cadence_match_jax(tmp_path, every,
                                                    patience, mode):
    epochs = 8
    cfg = TrainerConfig(epochs=epochs, log_every=0, max_steps_per_epoch=1,
                        ckpt_dir=str(tmp_path), keep_best="f1",
                        best_mode=mode, early_stop_patience=patience,
                        eval_every_epochs=every,
                        eval_finalize=losses.f1_finalize)
    trainer = _setup(cfg, eval_metrics=[_rates(r) for r in RATES])
    saves = []
    trainer.save_checkpoint = lambda tag="latest": saves.append(
        (trainer.host_step, tag))
    trainer.fit()
    assert saves == _jax_decisions(epochs, every, patience, mode)
    assert "f1" in trainer.last_eval_metrics
    with open(tmp_path / "best_metric.json") as f:
        rec = json.load(f)
    assert rec["metric"] == "f1" and rec["mode"] == mode


def test_config_checks_match_jax():
    bad = [dict(best_mode="mean"), dict(keep_checkpoints=0,
                                        ckpt_every_steps=1),
           dict(keep_checkpoints=2), dict(early_stop_patience=2),
           dict(trace_dir="t"), dict(trace_dir="t", trace_steps=(3, 3))]
    for kw in bad:
        with pytest.raises(ValueError):
            _setup(TrainerConfig(**kw))


def test_summarize_goodput_equals_jax():
    recs = [
        {"split": "goodput", "wall_s": 10.0, "productive_s": 6.0,
         "checkpoint_s": 1.5, "stalled_s": 0.5, "other_s": 2.0},
        {"split": "train", "loss": 1.0},
        {"split": "goodput", "wall_s": 4.0, "productive_s": 3.0,
         "recovering_s": 0.25, "other_s": 0.75},
    ]
    for wall in (None, 20.0):
        assert tracing.summarize_goodput(recs, wall) == \
            jtracing.summarize_goodput(recs, wall)
    acct, jacct = tracing.GoodputAccount(lambda: 5.0), \
        jtracing.GoodputAccount(lambda: 5.0)
    for a in (acct, jacct):
        a.started_at = 0.0
        a.add("productive", 3.0)
        a.add("stalled", 1.0)
        a.retract("stalled", 0.25)
    assert acct.summary() == jacct.summary()
    assert tracing.GOODPUT_BUCKETS == jtracing.GOODPUT_BUCKETS


class _SlowLoader:
    """Batches of a list, with one sleep before batch ``stall_at``."""

    def __init__(self, batches, stall_at, stall_s):
        self.batches, self.stall_at, self.stall_s = batches, stall_at, \
            stall_s

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for i, b in enumerate(self.batches):
            if i == self.stall_at:
                time.sleep(self.stall_s)
            yield b


def _batches(n=4):
    rng = np.random.default_rng(0)
    return [{"x": torch.from_numpy(rng.standard_normal((4, 4))
                                   .astype(np.float32)),
             "y": torch.zeros(4, 2)} for _ in range(n)]


def test_watchdog_counts_a_stalled_fetch_and_goodput_sums(tmp_path):
    metrics = str(tmp_path / "m.jsonl")
    cfg = TrainerConfig(log_every=1, stall_timeout_s=0.5,
                        metrics_path=metrics)
    trainer = _setup(cfg, loader=_SlowLoader(_batches(), 2, 1.6))
    with tracing.enabled() as tracer:
        trainer.fit()
        marks = [e for e in tracer._events if e["name"] == "watchdog.stall"]
    g = trainer.last_goodput
    assert marks and g["stalled_s"] >= 0.5
    (rec,) = [r for r in read_metrics(metrics) if r["split"] == "goodput"]
    buckets = sum(v for k, v in rec.items() if k.endswith("_s")
                  and k != "wall_s")
    assert math.isclose(buckets, rec["wall_s"], rel_tol=1e-9)
    assert rec["productive_s"] > 0 and "goodput_pct" in rec


def test_a_stall_inside_the_step_is_the_steps_time():
    seen = []
    trainer = _setup(TrainerConfig(log_every=1, stall_timeout_s=0.5))
    step = trainer.train_step

    def slow_step(state, batch):
        if state.step == 1:
            time.sleep(1.6)
        return step(state, batch)

    trainer.train_step = slow_step
    trainer._note_stall = lambda idle: (seen.append(idle),
                                        Trainer._note_stall(trainer, idle))
    trainer.fit()
    assert seen   # the watchdog fired
    g = trainer.last_goodput
    assert g["stalled_s"] == 0.0 and g["productive_s"] >= 1.6


def test_trace_steps_window_writes_a_trace(tmp_path):
    cfg = TrainerConfig(log_every=0, trace_dir=str(tmp_path / "prof"),
                        trace_steps=(1, 3))
    _setup(cfg).fit()
    (name,) = os.listdir(tmp_path / "prof")
    with open(tmp_path / "prof" / name) as f:
        doc = json.load(f)
    assert doc["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in doc["traceEvents"])


def test_log_mfu_on_the_cpu_is_off_and_leaves_the_state(caplog):
    log = logging.getLogger(trainer_mod.__name__)
    log.addHandler(caplog.handler)
    caplog.set_level(logging.INFO)
    try:
        a = _setup(TrainerConfig(log_every=1, log_mfu=True))
        a.fit()
    finally:
        log.removeHandler(caplog.handler)
    b = _setup(TrainerConfig(log_every=1))
    b.fit()
    for (n, p), (_, q) in zip(a.state.model.named_parameters(),
                              b.state.model.named_parameters()):
        assert torch.equal(p, q), n
    assert "MFU off" in caplog.text
    # Linear(4, 2) on 4 rows: 2*4*4*2 forward, twice that backward (its
    # input needs no gradient: only the weight's) = 64 + 64
    assert a._step_flops == 128.0
    assert all("tflops" in r and "mfu" not in r for r in a.history)


# -- the recipes ------------------------------------------------------------


def test_resnet50_config_has_the_jax_fields():
    import recipes.resnet50_imagenet as jax_recipe
    from pytorch_distributed_tpu_torch.recipes import resnet50_imagenet

    port = {f.name for f in dataclasses.fields(resnet50_imagenet.Config)}
    want = {f.name for f in dataclasses.fields(jax_recipe.Config)}
    assert port - want == {"device", "grad_compress"}   # the port's own
    assert want <= port
    for flags in (["--fsdp", "2"], ["--tp", "2"], ["--strategy", "auto"]):
        with pytest.raises(NotImplementedError, match="A10"):
            resnet50_imagenet.main(["--device", "cpu"] + flags)


def test_resnet50_recipe_runs_the_lifecycle_flags(tmp_path):
    from pytorch_distributed_tpu_torch.recipes import resnet50_imagenet

    ck, prof = str(tmp_path / "ck"), str(tmp_path / "prof")
    metrics = str(tmp_path / "m.jsonl")
    trainer = resnet50_imagenet.main([
        "--device", "cpu", "--image-size", "32", "--batch-size", "4",
        "--steps-per-epoch", "2", "--epochs", "2", "--log-every", "1",
        "--ckpt-dir", ck, "--ckpt-every-steps", "1", "--keep-checkpoints",
        "2", "--keep-best", "loss", "--best-mode", "min",
        "--async-checkpoint", "--log-mfu", "--profile-dir", prof,
        "--metrics-path", metrics, "--backend", "gloo"])
    assert trainer.state.step == 4
    assert sorted(d for d in os.listdir(ck) if d.startswith("step-")) == [
        "step-3", "step-4"]
    assert {"best", "latest", "best_metric.json"} <= set(os.listdir(ck))
    (trace,) = os.listdir(prof)
    with open(os.path.join(prof, trace)) as f:
        assert json.load(f)["traceEvents"]
    assert all(r["tflops"] > 0 for r in trainer.history)
    (rec,) = [r for r in read_metrics(metrics) if r["split"] == "goodput"]
    assert rec["checkpoint_s"] > 0 and rec["productive_s"] > 0


# -- the runtime pieces behind the lifecycle ---------------------------------


def test_deferred_signals_deliver_after_the_block():
    import signal

    from pytorch_distributed_tpu_torch.train.elastic import (
        PreemptionHandler,
        deferred_signals,
    )

    handler = PreemptionHandler().install()
    try:
        with deferred_signals():
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(0.05)
            assert not handler.requested   # latched, not delivered
        time.sleep(0.05)
        assert handler.requested           # delivered after the block
    finally:
        handler.uninstall()


def test_tracing_sites_and_meta(tmp_path):
    tracing.set_meta(rank=0, world=1)
    with tracing.enabled(str(tmp_path)) as tracer:
        tracing.name_thread("main")
        tracing.instant("mark", step=3)
        tracing.note_compiles("step", 1)
        tracing.note_compiles("step", 1)
        tracing.note_compiles("step", 3)   # two recompiles after warm-up
        path = tracer.export()
    assert tracer.recompiles == {"step": 2}
    with open(path) as f:
        doc = json.load(f)
    names = [(e["name"], e["ph"]) for e in doc["traceEvents"]]
    assert ("mark", "i") in names and ("thread_name", "M") in names
    assert ("recompile", "i") in names
    assert doc["otherData"]["meta"] == tracing.get_meta()
    assert tracing.get_meta()["world"] == 1
    tracing.note_compiles("step", 9)   # disarmed: no-op
    tracing.instant("mark")


def test_step_timer_summary_equals_jax():
    from pytorch_distributed_tpu.utils.profiler import StepTimer as JaxTimer
    from pytorch_distributed_tpu_torch.utils.profiler import (
        StepTimer,
        annotate,
    )

    a, b = StepTimer(window=4), JaxTimer(window=4)
    for dt in (0.5, 0.1, 0.3, 0.2, 0.4):
        a.add(dt)
        b.add(dt)
    assert a.summary() == b.summary()
    assert a.percentile(0.95) == b.percentile(0.95)
    assert a.rate(8) == b.rate(8)
    with annotate("region"):   # a record_function region, no profiler on
        pass


def test_peak_flops_and_memory_off_and_on_the_card(monkeypatch):
    from pytorch_distributed_tpu_torch.runtime import device as dev

    assert dev.peak_flops() is None            # no card here
    assert dev.peak_flops("cpu") is None
    assert dev.memory_allocated() == 0 and dev.memory_stats() == {}
    assert "no CUDA device" in dev.memory_summary()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert dev.peak_flops() == 989e12
    assert dev.peak_flops("cpu") is None
