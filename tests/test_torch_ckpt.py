"""Checkpoints both packages restore (``train/checkpoint.py``,
``train/ckpt_io.py``).

* Port save -> JAX ``restore_checkpoint`` into the JAX recipe's
  ``TrainState`` (tiny GPT-2 with ``chain(clip_by_global_norm, adamw)``,
  tiny ResNet with ``sgd`` (Nesterov, warmup-cosine) and
  ``batch_stats``): every leaf equal to the bit to the port's state,
  converted independently (``interop.gpt2_params_to_jax``,
  ``resnet_params_to_jax``), and no leaf left over on either side.
* JAX save -> port restore, the same models: the port's state, written
  back, equals every JAX leaf to the bit.
* Resume against an uninterrupted run, port against port on the CPU:
  losses and parameters equal to the bit, the sampler's index streams
  integer-equal.
* A process killed at ``ckpt.write_shard`` leaves the previous
  checkpoint to restore; one killed inside the swing leaves a complete
  ``.tmp`` whose commit the restore finishes; a damaged shard is named
  by ``verify_checkpoint`` and the restore falls back to the checkpoint
  before it.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_tpu.models import resnet as jres
from pytorch_distributed_tpu.models.gpt2 import (
    GPT2Config as JaxGPT2Config,
    GPT2LMHead as JaxGPT2,
)
from pytorch_distributed_tpu.train import TrainState as JaxTrainState
from pytorch_distributed_tpu.train.checkpoint import (
    _leaf_files,
    restore_checkpoint as jax_restore_checkpoint,
    save_checkpoint as jax_save_checkpoint,
)
from pytorch_distributed_tpu_torch import optim
from pytorch_distributed_tpu_torch.data import (
    DataLoader,
    SyntheticTextDataset,
)
from pytorch_distributed_tpu_torch.interop import (
    gpt2_params_to_jax,
    resnet_params_to_jax,
)
from pytorch_distributed_tpu_torch.models import resnet
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from pytorch_distributed_tpu_torch.runtime import faults
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.train import (
    Trainer,
    TrainerConfig,
    TrainState,
    build_train_step,
    causal_lm_loss_fn,
    classification_loss_fn,
    load_sampler_cursor,
    restore_checkpoint,
    save_checkpoint,
    verify_checkpoint,
)
from pytorch_distributed_tpu_torch.train.ckpt_io import (
    checkpoint_step,
    load_checkpoint,
)
from tests.torch_parity import assert_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(tree, prefix):
    """{JAX checkpoint leaf name: array} of a nested dict."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}_{k}"
        out.update(_flat(v, name) if isinstance(v, dict) else
                   {name: np.asarray(v)})
    return out


# -- GPT-2 with clip + adamw --------------------------------------------------

def _port_gpt2(seed=0, steps=2):
    model = GPT2LMHead(GPT2Config.tiny(), device="cpu", policy=Policy.full())
    model.init_weights(torch.Generator().manual_seed(seed))
    opt = optim.clip_grad_norm(optim.AdamW(model, lr=3e-4,
                                           weight_decay=1e-4), 1.0)
    state = TrainState(model, opt, policy=Policy.full())
    step = build_train_step(causal_lm_loss_fn(model), accum_steps=2)
    ids = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, 512, (4, 16)))
    for _ in range(steps):
        state, _ = step(state, {"input_ids": ids})
    return model, state


def _gpt2_expected(model, state):
    cfg, adam = model.config, state.optimizer.optimizer
    moments = {k: {n: adam.state[p][k] for n, p in model.named_parameters()}
               for k in ("exp_avg", "exp_avg_sq")}
    return {"step": np.asarray(state.step, np.int32),
            "opt_state_1_0_count": np.asarray(state.step, np.int32),
            **_flat(gpt2_params_to_jax(model.state_dict(), cfg), "params"),
            **_flat(gpt2_params_to_jax(moments["exp_avg"], cfg),
                    "opt_state_1_0_mu"),
            **_flat(gpt2_params_to_jax(moments["exp_avg_sq"], cfg),
                    "opt_state_1_0_nu")}


def _jax_gpt2_template():
    jmodel = JaxGPT2(JaxGPT2Config.tiny())
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    return JaxTrainState.create(
        apply_fn=jmodel.apply, params=params,
        tx=optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(3e-4)))


# -- ResNet with sgd (Nesterov, schedule) and batch_stats ---------------------

def _port_resnet(seed=0, steps=2):
    gen = torch.Generator().manual_seed(seed)
    model = resnet.ResNet([1, 1], resnet.Bottleneck, 10, width=8,
                          stem="cifar", device="cpu", policy=Policy.full())
    model.init_weights(gen)
    opt = optim.SGD(model, lr=optim.WarmupCosine(0.1, 1, 4), momentum=0.9,
                    nesterov=True)
    state = TrainState(model, opt, policy=Policy.full())
    step = build_train_step(classification_loss_fn(model, weight_decay=1e-4))
    rng = np.random.default_rng(seed + 1)
    batch = {"image": torch.from_numpy(rng.normal(
        size=(4, 16, 16, 3)).astype(np.float32)),
        "label": torch.from_numpy(rng.integers(0, 10, 4))}
    for _ in range(steps):
        state, _ = step(state, batch)
    return model, state


def _resnet_expected(model, state):
    params, stats = resnet_params_to_jax(model.state_dict())
    trace = {n: state.optimizer.state[p]["momentum_buffer"]
             for n, p in model.named_parameters()}
    return {"step": np.asarray(state.step, np.int32),
            "opt_state_1_count": np.asarray(state.optimizer.count, np.int32),
            **_flat(params, "params"), **_flat(stats, "batch_stats"),
            **_flat(resnet_params_to_jax(trace)[0], "opt_state_0_trace")}


def _jax_resnet_template():
    jmodel = jres.ResNet(stage_sizes=[1, 1], block_cls=jres.Bottleneck,
                         num_classes=10, width=8, stem="cifar")
    v = jmodel.init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)),
                    train=False)
    tx = optax.sgd(optax.warmup_cosine_decay_schedule(0.0, 0.1, 1, 4),
                   momentum=0.9, nesterov=True)
    return JaxTrainState.create(apply_fn=jmodel.apply, params=v["params"],
                                tx=tx, batch_stats=v["batch_stats"])


def _fresh_resnet():
    model = resnet.ResNet([1, 1], resnet.Bottleneck, 10, width=8,
                          stem="cifar", device="cpu", policy=Policy.full())
    opt = optim.SGD(model, lr=optim.WarmupCosine(0.1, 1, 4), momentum=0.9,
                    nesterov=True)
    return model, TrainState(model, opt, policy=Policy.full())


def _fresh_gpt2():
    model = GPT2LMHead(GPT2Config.tiny(), device="cpu", policy=Policy.full())
    opt = optim.clip_grad_norm(optim.AdamW(model, lr=3e-4,
                                           weight_decay=1e-4), 1.0)
    return model, TrainState(model, opt, policy=Policy.full())


MODELS = {
    "gpt2": (_port_gpt2, _gpt2_expected, _jax_gpt2_template, _fresh_gpt2),
    "resnet": (_port_resnet, _resnet_expected, _jax_resnet_template,
               _fresh_resnet),
}


def _assert_leaves_equal(got, want):
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.shape,
                                                           w.shape)
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_port_checkpoint_restores_in_jax(kind, tmp_path):
    build, expected, template, _ = MODELS[kind]
    model, state = build()
    save_checkpoint(str(tmp_path), state)
    assert verify_checkpoint(str(tmp_path)) == []
    restored = jax_restore_checkpoint(str(tmp_path), template())
    got = {k: np.asarray(v) for k, v in _leaf_files(restored)}
    _assert_leaves_equal(got, expected(model, state))


def _randomized(jstate, seed, step):
    """The JAX state with every float leaf redrawn (variances positive)
    and every int leaf (step, counts) set to ``step``."""
    rng = np.random.default_rng(seed)

    def redraw(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return np.full(x.shape, step, x.dtype)
        return np.abs(rng.normal(size=x.shape)).astype(x.dtype) + 0.5

    return jax.tree_util.tree_map(redraw, jstate)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_jax_checkpoint_restores_in_port(kind, tmp_path):
    _, _, template, fresh = MODELS[kind]
    jstate = _randomized(template(), seed=3, step=5)
    jax_save_checkpoint(str(tmp_path / "jax"), jstate)
    model, state = fresh()
    restore_checkpoint(str(tmp_path / "jax"), state)
    assert state.step == 5
    local = state.optimizer
    local = getattr(local, "optimizer", local)
    if kind == "gpt2":
        assert {int(s["step"]) for s in local.state.values()} == {5}
    else:
        assert local.count == 5
    save_checkpoint(str(tmp_path / "port"), state)
    back = load_checkpoint(str(tmp_path / "port" / "latest")).leaves
    _assert_leaves_equal(back, {k: np.asarray(v)
                                for k, v in _leaf_files(jstate)})


# -- resume against an uninterrupted run -------------------------------------

class _Recorded(Trainer):
    """Keeps every batch it trains on, and a copy of the checkpoint
    directory as it stood after the save at ``keep_at``."""

    keep_at, keep_dir = None, None

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.seen = []
        inner = self.train_step

        def step(state, batch):
            self.seen.append(batch["input_ids"].numpy().copy())
            return inner(state, batch)

        self.train_step = step

    def save_checkpoint(self, tag="latest"):
        path = super().save_checkpoint(tag)
        if self.host_step == self.keep_at and self.keep_dir:
            if not os.path.exists(self.keep_dir):
                shutil.copytree(self.config.ckpt_dir, self.keep_dir)
        return path


def _gpt2_trainer(ckpt_dir, seed, *, every=3, cls=_Recorded):
    cfg = dataclasses.replace(GPT2Config.tiny(), dropout_rate=0.1)
    model = GPT2LMHead(cfg, device="cpu", policy=Policy.full())
    model.init_weights(torch.Generator().manual_seed(seed))
    opt = optim.clip_grad_norm(optim.AdamW(model, lr=1e-3,
                                           weight_decay=1e-4), 1.0)
    ds = SyntheticTextDataset(n=24, seq_len=16, vocab_size=512, seed=0)
    trainer = cls(
        TrainState(model, opt, policy=Policy.full()),
        build_train_step(causal_lm_loss_fn(model), accum_steps=2),
        DataLoader(ds, 4, seed=0),
        config=TrainerConfig(log_every=1, ckpt_dir=ckpt_dir,
                             ckpt_every_steps=every))
    return model, trainer


def test_resume_equals_the_uninterrupted_run(tmp_path):
    run, at3 = str(tmp_path / "run"), str(tmp_path / "at3")
    model, first = _gpt2_trainer(run, seed=0)
    first.keep_at, first.keep_dir = 3, at3
    first.fit()
    assert [r["step"] for r in first.history] == [1, 2, 3, 4, 5, 6]
    assert load_sampler_cursor(at3) == {"step": 3, "epoch": 0, "offset": 3}
    assert load_sampler_cursor(run) == {"step": 6, "epoch": 1, "offset": 0}

    model2, second = _gpt2_trainer(at3, seed=1)   # other weights
    assert second.restore_checkpoint()
    assert second.state.step == 3 and second.host_step == 3
    second.fit()
    assert [r["step"] for r in second.history] == [4, 5, 6]
    assert [r["loss"] for r in second.history] == [
        r["loss"] for r in first.history[3:]]
    for (n, p), q in zip(model.named_parameters(), model2.parameters()):
        assert torch.equal(p, q), n
    assert len(second.seen) == 3
    for a, b in zip(second.seen, first.seen[3:]):
        assert_equal(a, b, "batch")
    # a checkpoint at the epoch's end resumes at the next epoch's start
    model3, third = _gpt2_trainer(run, seed=2)
    assert third.restore_checkpoint()
    assert (third._first_epoch, third._resume_skip_batches) == (1, 0)


# -- faults ------------------------------------------------------------------

_KILLED_SAVE = """
import sys
import numpy as np, torch
from pytorch_distributed_tpu_torch import optim
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from pytorch_distributed_tpu_torch.runtime import faults
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.train import (
    TrainState, build_train_step, causal_lm_loss_fn, save_checkpoint)
ckpt_dir, spec = sys.argv[1], sys.argv[2]
model = GPT2LMHead(GPT2Config.tiny(), device="cpu", policy=Policy.full())
model.init_weights(torch.Generator().manual_seed(0))
state = TrainState(model, optim.AdamW(model, lr=1e-3), policy=Policy.full())
step = build_train_step(causal_lm_loss_fn(model))
ids = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 16)))
state, _ = step(state, {"input_ids": ids})
save_checkpoint(ckpt_dir, state)
torch.save({n: p.detach().clone() for n, p in model.named_parameters()},
           ckpt_dir + "/step1.pt")
state, _ = step(state, {"input_ids": ids})
torch.save({n: p.detach().clone() for n, p in model.named_parameters()},
           ckpt_dir + "/step2.pt")
faults.configure(spec)
save_checkpoint(ckpt_dir, state)
print("SAVED")
"""


def _restored_trainer(ckpt_dir, clip=False):
    model = GPT2LMHead(GPT2Config.tiny(), device="cpu", policy=Policy.full())
    opt = optim.AdamW(model, lr=1e-3)
    if clip:
        opt = optim.clip_grad_norm(opt, 1.0)
    trainer = Trainer(TrainState(model, opt, policy=Policy.full()), None,
                      None, config=TrainerConfig(ckpt_dir=ckpt_dir))
    return model, trainer


class _Clock:
    """``time`` for the trainer module: ``perf_counter`` runs ``skew``
    seconds ahead of the real one."""
    skew = 0.0

    def perf_counter(self):
        return time.perf_counter() + self.skew


class _SlowSave(_Recorded):
    """Each save takes SAVE_S seconds on the trainer's clock."""
    SAVE_S = 1000.0
    clock = None

    def save_checkpoint(self, tag="latest"):
        self.clock.skew += self.SAVE_S
        return super().save_checkpoint(tag)


def test_logged_step_time_leaves_the_saves_out(tmp_path, monkeypatch):
    from pytorch_distributed_tpu_torch.train import trainer as trainer_mod

    clock = _Clock()
    monkeypatch.setattr(trainer_mod, "time", clock)
    monkeypatch.setattr(_SlowSave, "clock", clock)
    # a save after every step: each logged step would take SAVE_S more
    _, trainer = _gpt2_trainer(str(tmp_path / "run"), seed=0, every=1,
                               cls=_SlowSave)
    trainer.fit()
    times = [r["step_time_s"] for r in trainer.history]
    assert clock.skew == 7 * _SlowSave.SAVE_S   # 6 steps, the epoch's end
    assert len(times) == 6 and max(times) < _SlowSave.SAVE_S, times


@pytest.mark.parametrize("site, survivor", [
    ("ckpt.write_shard:mode=kill,after=5", 1),   # mid-save: the old one
    ("ckpt.swing:mode=kill", 2),                 # in the renames: the new
], ids=["write_shard", "swing"])
def test_a_killed_save_leaves_a_restorable_checkpoint(tmp_path, site,
                                                      survivor):
    ckpt_dir = str(tmp_path)
    res = subprocess.run(
        [sys.executable, "-c", _KILLED_SAVE, ckpt_dir, site],
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == faults.KILLED_EXIT, res.stderr[-2000:]
    assert "SAVED" not in res.stdout
    assert os.path.isdir(os.path.join(ckpt_dir, "latest.tmp"))
    model, trainer = _restored_trainer(ckpt_dir)
    assert trainer.restore_checkpoint()
    assert trainer.state.step == survivor
    want = torch.load(os.path.join(ckpt_dir, f"step{survivor}.pt"))
    for n, p in model.named_parameters():
        assert torch.equal(p, want[n]), n
    assert verify_checkpoint(ckpt_dir) == []


@pytest.mark.parametrize("mode", ["bitflip", "truncate"])
def test_a_damaged_shard_is_named_and_the_one_before_restores(tmp_path,
                                                              mode):
    ckpt_dir = str(tmp_path)
    model, trainer = _gpt2_trainer(ckpt_dir, seed=0, every=None,
                                   cls=Trainer)
    trainer.config = dataclasses.replace(trainer.config,
                                         max_steps_per_epoch=1)
    trainer.fit()   # step 1, saved as latest at the epoch's end
    trainer.save_checkpoint("step-1")
    saved = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer.state, _ = trainer.train_step(trainer.state, next(iter(
        trainer.train_loader)))
    trainer.host_step += 1
    with faults.injected(f"ckpt.write_shard:mode={mode},"
                         "match=params_wte_embedding"):
        trainer.save_checkpoint()   # reports success; one shard damaged
    problems = verify_checkpoint(ckpt_dir)
    assert len(problems) == 1 and "params_wte_embedding" in problems[0], \
        problems
    assert checkpoint_step(ckpt_dir, "latest") == 2
    model2, restored = _restored_trainer(ckpt_dir, clip=True)
    assert restored.restore_checkpoint()
    assert restored.state.step == 1
    for n, p in model2.named_parameters():
        assert torch.equal(p, saved[n]), n


def test_resnet_recipe_checkpoints_and_resumes(tmp_path):
    from pytorch_distributed_tpu_torch.recipes import resnet50_imagenet

    argv = ["--device", "cpu", "--image-size", "32", "--batch-size", "4",
            "--steps-per-epoch", "2", "--log-every", "1", "--lr", "0.01",
            "--ckpt-dir", str(tmp_path)]
    first = resnet50_imagenet.main(argv + ["--epochs", "1"])
    assert first.state.step == 2 and verify_checkpoint(str(tmp_path)) == []
    second = resnet50_imagenet.main(argv + ["--epochs", "2"])
    assert [r["step"] for r in second.history] == [3, 4]
    assert checkpoint_step(str(tmp_path)) == 4
    assert load_sampler_cursor(str(tmp_path)) == {"step": 4, "epoch": 2,
                                                  "offset": 0}


@pytest.mark.parametrize("algo", ["crc32", "crc32c"])
def test_checksums_equal_the_jax_package(tmp_path, algo):
    from pytorch_distributed_tpu.utils import integrity as jax_integrity
    from pytorch_distributed_tpu_torch.utils import integrity

    path = tmp_path / "blob"
    path.write_bytes(np.random.default_rng(0).bytes((1 << 22) + 12345))
    assert integrity.PREFERRED_ALGO == jax_integrity.PREFERRED_ALGO
    assert integrity.algo_supported(algo) == jax_integrity.algo_supported(
        algo)
    assert integrity.checksum_file(str(path), algo) == \
        jax_integrity.checksum_file(str(path), algo)


def test_checkpoint_fault_sites_are_known():
    for site in ("ckpt.write_shard", "ckpt.swing", "ckpt.read_shard"):
        for mode in ("raise", "kill", "truncate", "bitflip"):
            plan = faults.parse(f"{site}:mode={mode},count=1")
            assert plan[site].mode == mode
    with pytest.raises(ValueError, match="unknown fault site"):
        faults.parse("ckpt.rank_commit:count=1")


def test_single_directory_helpers_agree_with_jax(tmp_path):
    from pytorch_distributed_tpu.train import ckpt_io as jax_ckpt_io
    from pytorch_distributed_tpu_torch.train import ckpt_io

    rng = np.random.default_rng(0)
    leaves = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.integers(0, 9, (5,)).astype(np.int32)}
    d = str(tmp_path)
    ckpt_io.save_single_checkpoint(d, leaves, 7, tag="step-7")
    jax_ckpt_io.save_single_checkpoint(
        d, {k: v + 1 for k, v in leaves.items()}, 9, tag="step-9")
    ckpt_io.save_single_checkpoint(d, leaves, 5, tag="latest")   # stale
    os.makedirs(os.path.join(d, "step-11", "rank-0"))   # a torn sharded save
    for mod in (ckpt_io, jax_ckpt_io):
        assert mod.step_tags(d) == [7, 9, 11]
        assert mod.resolve_tag(d) == "step-9"
        assert mod.checkpoint_step(d, "step-11") is None
        assert mod.checkpoint_exists(d, "step-7")
        assert not mod.checkpoint_exists(d, "step-8")
        assert mod.restore_candidates(d) == ["step-9", "step-7", "latest"]
        for tag in ("step-7", "step-9", "latest"):
            assert mod.verify_checkpoint(d, tag) == []
    got = ckpt_io.load_checkpoint(os.path.join(d, "step-9"))
    want = jax_ckpt_io.load_checkpoint(os.path.join(d, "step-7"))
    assert got.step == 9 and want.step == 7
    for k, v in leaves.items():
        np.testing.assert_array_equal(got.leaves[k], v + 1)
        np.testing.assert_array_equal(want.leaves[k], v)


def test_preemption_handler_latches_sigterm_and_restores_the_handler():
    import signal
    import threading

    from pytorch_distributed_tpu_torch.train.elastic import (
        PreemptionHandler,
    )

    before = signal.getsignal(signal.SIGTERM)
    handler = PreemptionHandler().install()
    try:
        assert not handler.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert handler.requested
    finally:
        handler.uninstall()
    assert signal.getsignal(signal.SIGTERM) is before
    # off the main thread signal.signal raises: nothing is installed
    other = PreemptionHandler()
    t = threading.Thread(target=other.install)
    t.start()
    t.join()
    assert not other._installed
    assert signal.getsignal(signal.SIGTERM) is before


def test_inverse_converters_round_trip_and_refuse():
    from pytorch_distributed_tpu_torch.interop import (
        gpt2_params_from_jax,
        model_slots,
        optimizer_layout,
        resnet_params_from_jax,
    )

    jparams = jax.device_get(_jax_gpt2_template().params)
    cfg = GPT2Config.tiny()
    sd = gpt2_params_from_jax(jparams, cfg)
    back = gpt2_params_to_jax(sd, cfg)
    _assert_leaves_equal(_flat(back, "params"), _flat(jparams, "params"))
    jres_state = _jax_resnet_template()
    params, stats = jax.device_get((jres_state.params,
                                    jres_state.batch_stats))
    p2, s2 = resnet_params_to_jax(resnet_params_from_jax(params, stats))
    _assert_leaves_equal(_flat(p2, "params"), _flat(params, "params"))
    _assert_leaves_equal(_flat(s2, "stats"), _flat(stats, "stats"))
    with pytest.raises(NotImplementedError, match="extra.weight"):
        gpt2_params_to_jax({**sd, "extra.weight": sd["wte.weight"]}, cfg)
    with pytest.raises(NotImplementedError, match="ln_f"):
        gpt2_params_to_jax({k: v for k, v in sd.items()
                            if k != "ln_f.bias"}, cfg)
    with pytest.raises(NotImplementedError, match="A5"):
        model_slots(torch.nn.Linear(2, 2))
    with pytest.raises(NotImplementedError, match="A4"):
        optimizer_layout(optim.Adam(torch.nn.Linear(2, 2)))
