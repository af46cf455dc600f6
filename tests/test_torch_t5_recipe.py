"""The port's T5 recipe (``recipes/t5_seq2seq.py``) on the CPU:

* ``--size tiny --steps-per-epoch 3``: finite falling-or-flat losses, the
  teacher-forced eval (loss, perplexity, token accuracy) and the closing
  greedy match rates, the JAX recipe's rows (``make_task`` equal to
  the JAX one's arrays);
* a run that stops after epoch 1 with ``--ckpt-dir`` and a second run
  that restores it and trains epoch 2 log the uninterrupted two-epoch
  run's losses (f32 products, to 1e-6 of themselves);
* the checkpoint it wrote restores in the JAX package under the JAX
  recipe's ``TrainState`` (``chain(clip_by_global_norm(1.0), adamw)``):
  the step, every parameter and both AdamW moments equal to the port's
  bit for bit, in the JAX tree's layout (``t5_params_to_jax``).
"""

import dataclasses
import importlib.util
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from pytorch_distributed_tpu.models import t5 as jt5
from pytorch_distributed_tpu.train import TrainState as JaxTrainState
from pytorch_distributed_tpu.train.checkpoint import (
    _leaf_files,
    restore_checkpoint as jax_restore_checkpoint,
)
from pytorch_distributed_tpu_torch.interop import (
    t5_params_to_jax,
    unwrap_optimizer,
)
from tests.torch_parity import assert_close
from tests.torch_t5_workers import recipe_f32

ARGV = ["--size", "tiny", "--device", "cpu", "--backend", "gloo",
        "--steps-per-epoch", "3", "--log-every", "1", "--batch-size", "16",
        "--eval-rows", "16"]
RESUME_RTOL = 1e-6


def _jax_recipe():
    """The JAX recipe module (``recipes/`` is no package)."""
    path = os.path.join(os.path.dirname(__file__), "..", "recipes",
                        "t5_seq2seq.py")
    spec = importlib.util.spec_from_file_location("jax_t5_recipe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}_{k}" if prefix else str(k)
        out.update(_flat(v, key) if isinstance(v, dict) else
                   {key: np.asarray(v)})
    return out


def test_make_task_equals_the_jax_recipe():
    from pytorch_distributed_tpu_torch.recipes import t5_seq2seq

    want = _jax_recipe().make_task(40, 8, 64, "reverse", 1, 3)
    got = t5_seq2seq.make_task(40, 8, 64, "reverse", 1, 3)
    for key in ("input_ids", "labels", "label_mask"):
        np.testing.assert_array_equal(
            np.stack([got[i][key] for i in range(40)]),
            np.stack([want[i][key] for i in range(40)]), err_msg=key)


def test_recipe_trains_evaluates_and_generates():
    from pytorch_distributed_tpu_torch.recipes import t5_seq2seq

    trainer = t5_seq2seq.main(ARGV)
    losses = [r["loss"] for r in trainer.history]
    assert len(losses) == 3 and all(map(np.isfinite, losses))
    assert losses[-1] < losses[0]
    ev = trainer.last_eval_metrics
    assert sorted(ev) == ["loss", "perplexity", "token_accuracy"]
    assert ev["perplexity"] == pytest.approx(np.exp(ev["loss"]), rel=1e-5)
    rates = trainer.seq2seq
    assert rates["rows"] == 16
    assert 0.0 <= rates["exact_match"] <= rates["token_match"] <= 1.0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The uninterrupted two-epoch run; epoch 1 with a checkpoint; the
    resumed epoch 2 (f32 products)."""
    ckpt = str(tmp_path_factory.mktemp("t5ckpt"))
    with recipe_f32() as recipe:
        whole = recipe.main(ARGV + ["--epochs", "2"])
        first = recipe.main(ARGV + ["--ckpt-dir", ckpt])
        state = first.state
        saved = {"params": {n: p.detach().clone() for n, p in
                            state.model.module.named_parameters()}}
        _, opt, _ = unwrap_optimizer(state.optimizer)
        for key in ("exp_avg", "exp_avg_sq"):
            saved[key] = {n: opt.state[p][key].clone() for n, p in
                          state.model.module.named_parameters()}
        # the resumed run saves again: it takes a copy of the directory
        resume = str(tmp_path_factory.mktemp("t5resume") / "ckpt")
        shutil.copytree(ckpt, resume)
        second = recipe.main(ARGV + ["--ckpt-dir", resume, "--epochs", "2"])
    return whole, first, second, saved, ckpt


def test_restore_continues_the_trajectory(runs):
    whole, first, second, _, _ = runs
    want = [r["loss"] for r in whole.history]
    got = [r["loss"] for r in first.history + second.history]
    assert [r["step"] for r in second.history] == [4, 5, 6]
    assert_close(got, want, RESUME_RTOL, "losses")


def test_checkpoint_restores_in_jax(runs):
    from pytorch_distributed_tpu_torch.recipes import t5_seq2seq

    _, first, _, saved, ckpt = runs
    cfg = t5_seq2seq.config_for(t5_seq2seq.parse_args(ARGV))
    jcfg = dataclasses.replace(jt5.T5Config.tiny(), vocab_size=64,
                               dropout_rate=0.0)
    jmodel = jt5.T5ForConditionalGeneration(jcfg)
    params = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
        jnp.zeros((1, 9), jnp.int32)))["params"]
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                    params)
    template = JaxTrainState.create(
        apply_fn=jmodel.apply, params=params,
        tx=optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(3e-3)))
    got = {k: np.asarray(v) for k, v in _leaf_files(
        jax_restore_checkpoint(ckpt, template))}
    want = {"step": 3, "opt_state_1_0_count": 3}
    for prefix, sd in (("params", saved["params"]),
                       ("opt_state_1_0_mu", saved["exp_avg"]),
                       ("opt_state_1_0_nu", saved["exp_avg_sq"])):
        want.update(_flat(t5_params_to_jax(sd, cfg), prefix))
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
