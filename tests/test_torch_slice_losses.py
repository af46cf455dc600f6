"""The losses of the trainer-lifecycle slice against the JAX package,
each in f32: ``mixup_cutmix``'s mixing given the JAX draws (MixUp and
CutMix) within 1e-6, the port's own draws seeded and in range, the loss
``mixup_classification_loss_fn`` on the port's draws within 1e-6,
``distillation_loss_fn`` on two Llama-tiny within 1e-5,
``text_classification_eval_step`` with binary metrics within 1e-6 and
``f1_finalize`` equal.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.train import losses as jlosses
from pytorch_distributed_tpu_torch.train import losses
from tests.torch_dp_workers import RANK_THREADS
from tests.torch_parity import assert_close


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads, as the spawned ranks take
    (``torch_dp_workers.RANK_THREADS``): the test workers share the
    host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(RANK_THREADS)
    yield
    torch.set_num_threads(threads)

RATES = [   # confusion rates (tp, fp, fn, tn)
    (0.30, 0.10, 0.20, 0.40), (0.35, 0.10, 0.15, 0.40),
    (0.20, 0.20, 0.30, 0.30), (0.40, 0.02, 0.10, 0.48),
]


def _rates(r):
    return dict(zip(("tp_rate", "fp_rate", "fn_rate", "tn_rate"), r))



def _jax_draws(rng, b, mixup_alpha, cutmix_alpha, switch_prob=0.5):
    """The draws the JAX ``mixup_cutmix`` makes from ``rng``."""
    k_pair, k_lam, k_switch, k_box = jax.random.split(rng, 4)
    use = (jax.random.uniform(k_switch) < switch_prob
           if mixup_alpha > 0 and cutmix_alpha > 0
           else jnp.asarray(cutmix_alpha > 0))
    alpha = jnp.where(use, cutmix_alpha or 1.0,
                      mixup_alpha or 1.0).astype(jnp.float32)
    return {"perm": torch.from_numpy(np.asarray(
                jax.random.permutation(k_pair, b))).long(),
            "use_cutmix": torch.tensor(bool(use)),
            "lam": torch.tensor(float(jax.random.beta(k_lam, alpha, alpha))),
            "cy": torch.tensor(float(jax.random.uniform(k_box))),
            "cx": torch.tensor(float(jax.random.uniform(
                jax.random.fold_in(k_box, 1))))}


@pytest.mark.parametrize("mixup, cutmix, seed", [
    (0.2, 0.0, 0), (0.0, 1.0, 1), (0.4, 1.0, 2), (0.4, 1.0, 5)])
def test_mixup_cutmix_mixing_equals_jax_given_the_draws(mixup, cutmix,
                                                         seed):
    imgs = np.random.default_rng(seed).random((6, 12, 10, 3),
                                              dtype=np.float32)
    rng = jax.random.key(seed)
    want = jlosses.mixup_cutmix(rng, jnp.asarray(imgs), mixup_alpha=mixup,
                                cutmix_alpha=cutmix)
    draws = _jax_draws(rng, 6, mixup, cutmix)
    got = losses.mixup_cutmix_apply(torch.from_numpy(imgs), draws)
    assert_close(got[0], want[0], 1e-6, "mixed")
    assert torch.equal(got[1], torch.from_numpy(np.asarray(want[1])).long())
    assert_close(got[2], want[2], 1e-6, "lam")


def test_port_draws_are_seeded_and_in_range():
    g = torch.Generator().manual_seed(3)
    d = losses.mixup_cutmix_draw(g, 8, mixup_alpha=0.4, cutmix_alpha=1.0)
    g2 = torch.Generator().manual_seed(3)
    d2 = losses.mixup_cutmix_draw(g2, 8, mixup_alpha=0.4, cutmix_alpha=1.0)
    assert all(torch.equal(d[k], d2[k]) for k in d)
    assert sorted(d["perm"].tolist()) == list(range(8))
    assert 0.0 <= float(d["lam"]) <= 1.0
    with pytest.raises(ValueError, match="mixup_alpha"):
        losses.mixup_cutmix_draw(g, 8, mixup_alpha=0.0)


class _JaxLinear(nn.Module):
    @nn.compact
    def __call__(self, x, train=False):
        return nn.Dense(5)(x.reshape(x.shape[0], -1))


class _PortLinear(torch.nn.Module):
    def __init__(self, kernel, bias):
        super().__init__()
        self.dense = torch.nn.Linear(kernel.shape[0], kernel.shape[1])
        with torch.no_grad():
            self.dense.weight.copy_(torch.from_numpy(kernel.T.copy()))
            self.dense.bias.copy_(torch.from_numpy(bias))

    def forward(self, x, train=False):
        return self.dense(x.reshape(x.shape[0], -1))


def test_mixup_classification_loss_equals_jax(monkeypatch):
    imgs = np.random.default_rng(0).random((6, 4, 4, 3), dtype=np.float32)
    labels = np.array([0, 1, 2, 3, 4, 0], np.int32)
    jmodel = _JaxLinear()
    params = jmodel.init(jax.random.key(0), jnp.asarray(imgs))["params"]
    port = _PortLinear(np.asarray(params["Dense_0"]["kernel"]),
                       np.asarray(params["Dense_0"]["bias"]))
    kw = dict(mixup_alpha=0.4, cutmix_alpha=1.0, label_smoothing=0.1,
              weight_decay=1e-3)
    g = torch.Generator().manual_seed(7)
    draws = losses.mixup_cutmix_draw(torch.Generator().manual_seed(7), 6,
                                     mixup_alpha=0.4, cutmix_alpha=1.0)
    loss, aux = losses.mixup_classification_loss_fn(port, **kw)(
        {"image": torch.from_numpy(imgs),
         "label": torch.from_numpy(labels).long()}, g)
    mixed, perm, lam = losses.mixup_cutmix_apply(torch.from_numpy(imgs),
                                                 draws)
    monkeypatch.setattr(jlosses, "mixup_cutmix", lambda *a, **k: (
        jnp.asarray(mixed.numpy()), jnp.asarray(perm.numpy()),
        jnp.asarray(float(lam))))
    want, jaux = jlosses.mixup_classification_loss_fn(jmodel, **kw)(
        params, None, {"image": jnp.asarray(imgs),
                       "label": jnp.asarray(labels)}, jax.random.key(1))
    assert_close(loss, want, 1e-6, "loss")
    assert_close(aux["metrics"]["lam"], jaux["metrics"]["lam"], 1e-6, "lam")
    assert_close(aux["metrics"]["accuracy"], jaux["metrics"]["accuracy"],
                 1e-6, "accuracy")


def test_distillation_loss_equals_jax():
    from pytorch_distributed_tpu.models.llama import (
        LlamaConfig as JaxLlamaConfig,
        LlamaForCausalLM as JaxLlama,
    )
    from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
    from pytorch_distributed_tpu.runtime.precision import use_policy
    from pytorch_distributed_tpu_torch.interop import llama_params_from_jax
    from pytorch_distributed_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
    )
    from pytorch_distributed_tpu_torch.runtime.precision import Policy

    jmodel = JaxLlama(JaxLlamaConfig.tiny())
    ids = np.random.default_rng(0).integers(0, 512, (2, 12)).astype(np.int32)
    with use_policy(JaxPolicy(compute_dtype=jnp.float32)):
        ps = [jax.device_get(jmodel.init(jax.random.key(s),
                                         jnp.zeros((1, 8), jnp.int32))
                             ["params"]) for s in (0, 1)]
        want, jaux = jlosses.distillation_loss_fn(
            jmodel, jmodel, ps[1], temperature=2.0, alpha=0.3)(
            ps[0], None, {"input_ids": jnp.asarray(ids)}, jax.random.key(2))
    cfg = LlamaConfig.tiny()
    models = []
    for p in ps:
        m = LlamaForCausalLM(cfg, device="cpu", policy=Policy.full())
        m.load_state_dict(llama_params_from_jax(p, cfg))
        models.append(m)
    loss, aux = losses.distillation_loss_fn(
        models[0], models[1], temperature=2.0, alpha=0.3)(
        {"input_ids": torch.from_numpy(ids).long()}, None)
    assert_close(loss, want, 1e-5, "loss")
    for k in ("ce", "kl"):
        assert_close(aux["metrics"][k], jaux["metrics"][k], 1e-5, k)


def test_text_classification_eval_and_f1_equal_jax():
    from pytorch_distributed_tpu.models import bert as jbert
    from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
    from pytorch_distributed_tpu.runtime.precision import use_policy
    from pytorch_distributed_tpu_torch.interop import bert_params_from_jax
    from pytorch_distributed_tpu_torch.models import bert as tbert
    from pytorch_distributed_tpu_torch.runtime.precision import Policy

    jcfg = dataclasses.replace(jbert.BertConfig.tiny(), dropout_rate=0.0)
    tcfg = dataclasses.replace(tbert.BertConfig.tiny(), dropout_rate=0.0)
    jmodel = jbert.BertForSequenceClassification(jcfg, num_labels=2)
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, 1024, (16, 12)).astype(np.int32),
             "label": rng.integers(0, 2, (16,)).astype(np.int32),
             "attention_mask": np.arange(12)[None] < rng.integers(
                 4, 13, (16,))[:, None]}
    with use_policy(JaxPolicy(compute_dtype=jnp.float32)):
        params = jax.device_get(jmodel.init(jax.random.key(0), jnp.zeros(
            (1, 8), jnp.int32))["params"])
        want = jlosses.text_classification_eval_step(
            jmodel, binary_metrics=True)(
            type("S", (), {"params": params})(),
            {k: jnp.asarray(v) for k, v in batch.items()})
    model = tbert.BertForSequenceClassification(tcfg, 2, device="cpu",
                                                policy=Policy.full())
    model.load_state_dict(bert_params_from_jax(params, tcfg))
    got = losses.text_classification_eval_step(model, binary_metrics=True)(
        None, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        assert_close(got[k], want[k], 1e-6, k)
    means = {k: float(v) for k, v in got.items()}
    assert losses.f1_finalize(means) == jlosses.f1_finalize(means)
    for rates in RATES + [(0.0, 0.0, 0.5, 0.5)]:
        assert losses.f1_finalize(_rates(rates)) == jlosses.f1_finalize(
            _rates(rates))
