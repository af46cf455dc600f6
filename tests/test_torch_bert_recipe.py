"""The port's BERT recipe (``recipes/bert_finetune.py``) with the JAX
recipe's flags, at ``--device cpu --tiny``, and fp16 checkpoints both
packages restore.

* ``--steps-per-epoch 3`` alone, with ``--fp16`` and with ``--mlm``:
  three logged steps of finite loss; fp16 logs the loss scale and the
  finite flag; ``--mlm`` a realized ``mask_frac`` within 0.05 of
  ``--mask-prob`` (0.15 over 32 x 128 positions: the binomial's
  standard deviation is 0.0056); biases and LayerNorm weights exempt
  from the 0.01 decay.
* ``--fp16 --ckpt-dir``: a second run with one more epoch restores the
  first run's checkpoint, the scaler's state included, and goes on.
* ``--lora`` trains adapters only and refuses a rank below 1.
* An fp16 state's checkpoint (a skipped step among its steps, so the
  optimizer's count lags ``step``) written by the port restores in the
  JAX package into the JAX recipe's ``TrainState`` (``optim.AdamW`` with
  the no-decay mask, a ``ScalerState``) with every leaf equal to the bit;
  one the JAX package writes restores in the port, and written back
  equals every JAX leaf to the bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models import bert as jbert
from pytorch_distributed_tpu.optim import AdamW as JaxAdamW
from pytorch_distributed_tpu.optim import DEFAULT_NO_DECAY as JAX_NO_DECAY
from pytorch_distributed_tpu.runtime.precision import (
    GradScaler as JaxGradScaler,
)
from pytorch_distributed_tpu.train import TrainState as JaxTrainState
from pytorch_distributed_tpu.train.checkpoint import (
    _leaf_files,
    restore_checkpoint as jax_restore_checkpoint,
    save_checkpoint as jax_save_checkpoint,
)
from pytorch_distributed_tpu_torch import optim
from pytorch_distributed_tpu_torch.interop import bert_params_to_jax
from pytorch_distributed_tpu_torch.models import bert
from pytorch_distributed_tpu_torch.recipes import bert_finetune as recipe
from pytorch_distributed_tpu_torch.runtime.precision import (
    GradScaler,
    Policy,
)
from pytorch_distributed_tpu_torch.train import (
    TrainState,
    build_train_step,
    restore_checkpoint,
    save_checkpoint,
    text_classification_loss_fn,
    verify_checkpoint,
)
from pytorch_distributed_tpu_torch.train.ckpt_io import (
    checkpoint_step,
    load_checkpoint,
)
from tests.torch_bert_workers import poisoned_loss

BASE = ["--tiny", "--device", "cpu", "--steps-per-epoch", "3",
        "--log-every", "1"]


@pytest.mark.parametrize("flags", [[], ["--fp16"], ["--mlm"]],
                         ids=["bf16", "fp16", "mlm"])
def test_recipe_trains_on_the_cpu(flags):
    trainer = recipe.main(BASE + flags)
    assert trainer.state.step == 3
    hist = trainer.history
    assert [r["step"] for r in hist] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in hist)
    assert all(r["samples_per_s"] > 0 for r in hist)
    if "--fp16" in flags:
        assert trainer.state.scaler_state is not None
        assert all(r["loss_scale"] == 2.0 ** 15 and r["grads_finite"] == 1.0
                   for r in hist)
    else:
        assert trainer.state.scaler_state is None
    if "--mlm" in flags:
        assert all(abs(r["mask_frac"] - 0.15) < 0.05 for r in hist)
    groups = trainer.state.optimizer.param_groups
    assert [g["weight_decay"] for g in groups] == [0.01, 0.0]
    names = {id(p): n for n, p in trainer.state.model.module
             .named_parameters()}
    exempt = {names[id(p)] for p in groups[1]["params"]}
    assert exempt and all(n.endswith(("bias", "_ln.weight"))
                          and n != "mlm_bias" for n in exempt)


def test_fp16_run_resumes_with_its_scaler_state(tmp_path):
    argv = BASE + ["--fp16", "--ckpt-dir", str(tmp_path),
                   "--steps-per-epoch", "2", "--batch-size", "8",
                   "--seq-len", "32"]
    first = recipe.main(argv)
    assert first.state.step == 2 and verify_checkpoint(str(tmp_path)) == []
    leaves = load_checkpoint(str(tmp_path / "latest")).leaves
    assert leaves["scaler_state_scale"].dtype == np.float32
    assert leaves["scaler_state_growth_tracker"] == 2
    second = recipe.main(argv + ["--epochs", "2"])
    assert [r["step"] for r in second.history] == [3, 4]
    assert int(second.state.scaler_state.growth_tracker) == 4
    assert checkpoint_step(str(tmp_path)) == 4


def test_lora_raises_naming_its_item():
    """``--lora`` is ported (tests/test_torch_lora_recipe.py holds it): a
    run trains the adapters alone, and a rank below 1 is refused."""
    trainer = recipe.main(BASE + ["--lora", "4", "--steps-per-epoch", "1",
                                  "--batch-size", "4", "--seq-len", "16"])
    assert trainer.state.step == 1
    assert all(n.endswith((".a", ".b")) for n, p in
               trainer.state.model.named_parameters() if p.requires_grad)
    with pytest.raises(ValueError, match="rank"):
        recipe.main(BASE + ["--lora", "-1"])


# -- fp16 checkpoints both packages restore -----------------------------------

CFG = dataclasses.replace(bert.BertConfig.tiny(), dropout_rate=0.0)
INIT_SCALE = 2.0 ** 12


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}_{k}"
        out.update(_flat(v, name) if isinstance(v, dict) else
                   {name: np.asarray(v)})
    return out


def _fresh():
    model = bert.BertForSequenceClassification(CFG, device="cpu",
                                               policy=Policy.fp16())
    opt = optim.AdamW(model, lr=2e-5, weight_decay=0.01,
                      no_decay=optim.DEFAULT_NO_DECAY)
    scaler = GradScaler(init_scale=INIT_SCALE, dtype=torch.float16)
    return model, scaler, TrainState(model, opt, policy=Policy.fp16(),
                                     scaler_state=scaler.init_state("cpu"))


def _port_fp16_state():
    """Three fp16 steps, the second poisoned (skipped)."""
    model, scaler, state = _fresh()
    model.init_weights(torch.Generator().manual_seed(0))
    step = build_train_step(poisoned_loss(text_classification_loss_fn(model)),
                            scaler=scaler)
    rng = np.random.default_rng(1)
    for i in range(3):
        batch = {"input_ids": torch.from_numpy(
                     rng.integers(0, CFG.vocab_size, (4, 16))),
                 "label": torch.from_numpy(rng.integers(0, 2, (4,))),
                 "poison": torch.full((4,), np.inf if i == 1 else 1.0)}
        state, _ = step(state, batch)
    return model, state


def _expected(model, state):
    opt = state.optimizer
    moments = {k: {n: opt.state[p][k] for n, p in model.named_parameters()}
               for k in ("exp_avg", "exp_avg_sq")}
    count = {int(s["step"]) for s in opt.state.values()}
    assert count == {2} and state.step == 3   # the skip left the count
    return {"step": np.asarray(state.step, np.int32),
            "opt_state_0_count": np.asarray(2, np.int32),
            "scaler_state_scale": state.scaler_state.scale.numpy(),
            "scaler_state_growth_tracker":
                state.scaler_state.growth_tracker.numpy(),
            **_flat(bert_params_to_jax(model.state_dict(), CFG), "params"),
            **_flat(bert_params_to_jax(moments["exp_avg"], CFG),
                    "opt_state_0_mu"),
            **_flat(bert_params_to_jax(moments["exp_avg_sq"], CFG),
                    "opt_state_0_nu")}


def _jax_template():
    jmodel = jbert.BertForSequenceClassification(
        dataclasses.replace(jbert.BertConfig.tiny(), dropout_rate=0.0))
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    return JaxTrainState.create(
        apply_fn=jmodel.apply, params=params,
        tx=JaxAdamW(2e-5, weight_decay=0.01, no_decay=JAX_NO_DECAY),
        scaler_state=JaxGradScaler(init_scale=INIT_SCALE,
                                   dtype=jnp.float16).init_state())


def _assert_leaves_equal(got, want):
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.dtype,
                                                           w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_port_fp16_checkpoint_restores_in_jax(tmp_path):
    model, state = _port_fp16_state()
    assert float(state.scaler_state.scale) == INIT_SCALE / 2
    save_checkpoint(str(tmp_path), state)
    assert verify_checkpoint(str(tmp_path)) == []
    restored = jax_restore_checkpoint(str(tmp_path), _jax_template())
    got = {k: np.asarray(v) for k, v in _leaf_files(restored)}
    _assert_leaves_equal(got, _expected(model, state))


def test_jax_fp16_checkpoint_restores_in_port(tmp_path):
    rng = np.random.default_rng(3)

    def redraw(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return np.full(x.shape, 5, x.dtype)
        return np.abs(rng.normal(size=x.shape)).astype(x.dtype) + 0.5

    jstate = jax.tree_util.tree_map(redraw, _jax_template())
    jax_save_checkpoint(str(tmp_path / "jax"), jstate)
    model, _, state = _fresh()
    restore_checkpoint(str(tmp_path / "jax"), state)
    assert state.step == 5
    assert int(state.scaler_state.growth_tracker) == 5
    assert float(state.scaler_state.scale) == float(jstate.scaler_state.scale)
    assert state.scaler_state.scale.dtype == torch.float32
    assert {int(s["step"]) for s in state.optimizer.state.values()} == {5}
    save_checkpoint(str(tmp_path / "port"), state)
    back = load_checkpoint(str(tmp_path / "port" / "latest")).leaves
    _assert_leaves_equal(back, {k: np.asarray(v)
                                for k, v in _leaf_files(jstate)})
