"""The port's BERT recipe under ``--lora`` (``recipes/bert_finetune.py``)
at ``--device cpu --tiny``, and LoRA checkpoints both packages restore.

* ``--lora 4`` (bf16, ``--fp16``, ``--mlm``): finite losses; the trainable
  parameters are the adapters alone, ``lora_param_count`` of them; every
  base tensor is bitwise what the seed made; the optimizer's groups and
  state hold adapters only (all decayed: no adapter is a bias or a norm,
  as in JAX); ``quantize="int8"`` (QLoRA) trains too.
* A ``--lora`` checkpoint the port writes restores in the JAX package
  into the JAX recipe's LoRA ``TrainState`` (the adapter tree as params,
  ``optim.AdamW`` with the no-decay mask) with every leaf equal to the
  bit; one the JAX package writes restores in the port, and written back
  equals every JAX leaf to the bit.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn.utils import parametrize

from pytorch_distributed_tpu import lora as jlora
from pytorch_distributed_tpu.models import bert as jbert
from pytorch_distributed_tpu.optim import AdamW as JaxAdamW
from pytorch_distributed_tpu.optim import DEFAULT_NO_DECAY as JAX_NO_DECAY
from pytorch_distributed_tpu.train import TrainState as JaxTrainState
from pytorch_distributed_tpu.train.checkpoint import (
    _leaf_files,
    restore_checkpoint as jax_restore_checkpoint,
    save_checkpoint as jax_save_checkpoint,
)
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.lora import LoRAModel, lora_param_count
from pytorch_distributed_tpu_torch.models import bert
from pytorch_distributed_tpu_torch.recipes import bert_finetune as recipe
from pytorch_distributed_tpu_torch.runtime import distributed as dist
from pytorch_distributed_tpu_torch.train import (
    restore_checkpoint,
    save_checkpoint,
    verify_checkpoint,
)
from pytorch_distributed_tpu_torch.train.ckpt_io import load_checkpoint

BASE = ["--tiny", "--device", "cpu", "--steps-per-epoch", "3",
        "--log-every", "1", "--batch-size", "8", "--seq-len", "32",
        "--lora", "4"]


@contextlib.contextmanager
def _world_of_one():
    """A gloo world of one, as ``recipe.main`` makes for itself."""
    dist.init_process_group(device="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def _seeded_base(mlm=False):
    cfg = bert.BertConfig.tiny()
    cls = bert.BertForMaskedLM if mlm else bert.BertForSequenceClassification
    m = cls(cfg, device="cpu")
    return m.init_weights(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("flags", [[], ["--fp16"], ["--mlm"]],
                         ids=["bf16", "fp16", "mlm"])
def test_lora_recipe_trains_adapters_only(flags):
    trainer = recipe.main(BASE + flags)
    assert trainer.state.step == 3
    assert all(np.isfinite(r["loss"]) for r in trainer.history)
    lm = trainer.state.model.module
    assert isinstance(lm, LoRAModel)
    trainable = [p for p in lm.parameters() if p.requires_grad]
    assert sum(p.numel() for p in trainable) == lora_param_count(
        lm.adapters())
    opt = trainer.state.optimizer
    in_opt = {id(p) for g in opt.param_groups for p in g["params"]}
    assert in_opt == {id(p) for p in trainable}
    assert set(map(id, opt.state)) <= in_opt and len(opt.state) == len(
        trainable)
    assert [g["weight_decay"] for g in opt.param_groups] == [0.01, 0.0]
    assert not opt.param_groups[1]["params"]
    # the frozen base is the seed's, to the bit
    base = _seeded_base("--mlm" in flags)
    want = base.state_dict()
    for name in interop.logical_shapes(lm.model):
        mod_name, _, t = name.rpartition(".")
        mod = lm.model.get_submodule(mod_name)
        orig = (mod.parametrizations[t].original
                if parametrize.is_parametrized(mod, t) else getattr(mod, t))
        assert torch.equal(orig, want[name]), name


def test_qlora_trains_on_an_int8_base():
    args = recipe.parse_args(BASE)
    with _world_of_one():
        model, trainer = recipe.build_trainer(args, torch.device("cpu"),
                                              quantize="int8")
        trainer.fit()
    assert trainer.state.step == 3
    assert all(np.isfinite(r["loss"]) for r in trainer.history)
    bufs = dict(model.named_buffers())
    assert any(b.dtype == torch.int8 for b in bufs.values())


# -- LoRA checkpoints both packages restore -----------------------------------


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}_{k}"
        out.update(_flat(v, name) if isinstance(v, dict) else
                   {name: np.asarray(v)})
    return out


def _jax_template():
    jmodel = jbert.BertForSequenceClassification(
        dataclasses.replace(jbert.BertConfig.tiny(), dropout_rate=0.0))
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    adapters = jlora.lora_init(jax.random.key(1), params, rank=4)
    return JaxTrainState.create(
        apply_fn=jlora.LoRAModel(jmodel, params).apply, params=adapters,
        tx=JaxAdamW(2e-5, weight_decay=0.01, no_decay=JAX_NO_DECAY),
        scaler_state=None)


def _expected(trainer):
    lm = trainer.state.model.module
    opt = trainer.state.optimizer
    moments = {k: {n: {ab: opt.state[p][k] for ab, p in pair.items()}
                   for n, pair in lm.adapters().items()}
               for k in ("exp_avg", "exp_avg_sq")}
    base = lm.model
    return {"step": np.asarray(trainer.state.step, np.int32),
            "opt_state_0_count": np.asarray(trainer.state.step, np.int32),
            **_flat(interop.lora_params_to_jax(lm.adapters(), base),
                    "params"),
            **_flat(interop.lora_params_to_jax(moments["exp_avg"], base),
                    "opt_state_0_mu"),
            **_flat(interop.lora_params_to_jax(moments["exp_avg_sq"], base),
                    "opt_state_0_nu")}


def _assert_leaves_equal(got, want):
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.dtype,
                                                           w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_port_lora_checkpoint_restores_in_jax(tmp_path):
    trainer = recipe.main(BASE + ["--ckpt-dir", str(tmp_path),
                                  "--steps-per-epoch", "2"])
    assert verify_checkpoint(str(tmp_path)) == []
    leaves = load_checkpoint(str(tmp_path / "latest")).leaves
    assert all("_kernel_a" in k or "_kernel_b" in k for k in leaves
               if k.startswith(("params_", "opt_state_0_mu")))
    restored = jax_restore_checkpoint(str(tmp_path), _jax_template())
    got = {k: np.asarray(v) for k, v in _leaf_files(restored)}
    _assert_leaves_equal(got, _expected(trainer))


def test_jax_lora_checkpoint_restores_in_port(tmp_path):
    rng = np.random.default_rng(3)

    def redraw(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return np.full(x.shape, 5, x.dtype)
        return rng.normal(size=x.shape).astype(x.dtype)

    jstate = jax.tree_util.tree_map(redraw, _jax_template())
    jax_save_checkpoint(str(tmp_path / "jax"), jstate)
    args = recipe.parse_args(BASE)
    with _world_of_one():
        model, trainer = recipe.build_trainer(args, torch.device("cpu"))
        restore_checkpoint(str(tmp_path / "jax"), trainer.state)
        assert trainer.state.step == 5
        want = {k: np.asarray(v) for k, v in _leaf_files(jstate)}
        got = _flat(interop.lora_params_to_jax(model.adapters(),
                                               model.model), "params")
        for k, v in got.items():
            np.testing.assert_array_equal(v, want[k], k)
        save_checkpoint(str(tmp_path / "port"), trainer.state)
    back = load_checkpoint(str(tmp_path / "port" / "latest")).leaves
    _assert_leaves_equal(back, want)
