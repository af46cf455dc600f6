"""The PyTorch port's training slice held against the JAX package: the
causal-LM loss and its gradients, three optimizer steps of the train
step, the optimizer pieces, the data layer, and the port's own
determinism.

Models are the tiny GPT-2 on weights carried from a JAX init, computing
in f32 on both sides, with dropout 0 wherever the two frameworks are
compared (their random streams differ; the port's dropout is held
port-vs-port). Float tolerances are relative to the largest reference
magnitude: 1e-5 for losses and 1e-4 for gradients (sums over every
token in another order). Parameters after Adam steps are compared to an
absolute 1e-5: each step moves a parameter by about lr = 1e-3, so this
is 1% of a step. One slice is left out of that comparison: the key
projection's bias, whose gradient is zero in exact arithmetic (it adds
the same q.b to every logit of a row, and softmax ignores that), so both
frameworks' values are rounding noise near 1e-10, which Adam's
normalization turns into steps anywhere in [-lr, lr].
Integer outputs (batch order, packing) are compared for equality.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_tpu import optim as jax_optim
from pytorch_distributed_tpu.data import (
    DataLoader as JaxDataLoader,
    SyntheticTextDataset as JaxSyntheticTextDataset,
)
from pytorch_distributed_tpu.data.packing import (
    pack_documents as jax_pack_documents,
    packed_loss_mask as jax_packed_loss_mask,
)
from pytorch_distributed_tpu.models.gpt2 import (
    GPT2Config as JaxGPT2Config,
    GPT2LMHead as JaxGPT2,
)
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu.train import (
    TrainState as JaxTrainState,
    build_train_step as jax_build_train_step,
    causal_lm_loss_fn as jax_causal_lm_loss_fn,
)
from pytorch_distributed_tpu_torch import optim
from pytorch_distributed_tpu_torch.data import (
    DataLoader,
    SyntheticTextDataset,
    pack_documents,
    packed_loss_mask,
)
from pytorch_distributed_tpu_torch.interop import gpt2_params_from_jax
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from pytorch_distributed_tpu_torch.recipes import gpt2 as gpt2_recipe
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.runtime.prng import generator_for
from pytorch_distributed_tpu_torch.train import (
    Trainer,
    TrainerConfig,
    TrainingDiverged,
    TrainState,
    build_train_step,
    causal_lm_loss_fn,
)

F32 = JaxPolicy(compute_dtype=jnp.float32)
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
LR = 1e-3
PARAM_ATOL = 1e-2 * LR


@pytest.fixture(scope="module")
def jax_pair():
    """The JAX tiny GPT-2 (dropout 0) and its f32 params."""
    jmodel = JaxGPT2(dataclasses.replace(JaxGPT2Config.tiny(),
                                         dropout_rate=0.0))
    with use_policy(F32):
        params = jmodel.init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32)
        )["params"]
    return jmodel, jax.device_get(params)


def _port_model(params, dropout_rate=0.0):
    cfg = dataclasses.replace(GPT2Config.tiny(), dropout_rate=dropout_rate)
    model = GPT2LMHead(cfg, device="cpu", policy=Policy.full())
    model.load_state_dict(gpt2_params_from_jax(params, cfg))
    return model


def _batch(seed, B=4, S=24, packed=False):
    rng = np.random.default_rng(seed)
    if not packed:
        return {"input_ids": rng.integers(0, 512, (B, S)).astype(np.int32)}
    docs = [rng.integers(1, 512, size=int(n))
            for n in rng.integers(2, 14, size=4 * B)]
    out = jax_pack_documents(docs, S)
    return {k: v[:B] for k, v in out.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    tol = rtol * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_loss_and_grads_match_jax_value_and_grad(jax_pair, packed):
    jmodel, params = jax_pair
    batch = _batch(1, packed=packed)
    loss_fn = jax_causal_lm_loss_fn(jmodel)
    with use_policy(F32):
        (want, _), grads = jax.value_and_grad(
            lambda p: loss_fn(p, None, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                              jax.random.key(0)),
            has_aux=True,
        )(params)
    want_grads = gpt2_params_from_jax(jax.device_get(grads),
                                      GPT2Config.tiny())
    model = _port_model(params)
    loss, aux = causal_lm_loss_fn(model)(_torch(batch), None)
    loss.backward()
    _close(loss.item(), float(want), LOSS_RTOL, "loss")
    assert float(aux["metrics"]["loss"]) == loss.item()
    for name, p in model.named_parameters():
        _close(p.grad.numpy(), want_grads[name].numpy(), GRAD_RTOL, name)


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_three_steps_match_jax_train_step(jax_pair, accum_steps):
    """clip_by_global_norm(1.0) then adamw(lr) (optax's default decay
    1e-4), three steps on three batches, parameters compared after
    each step."""
    jmodel, params = jax_pair
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR))
    jstate = JaxTrainState.create(apply_fn=jmodel.apply, params=params,
                                  tx=tx)
    jstep = jax.jit(jax_build_train_step(
        jax_causal_lm_loss_fn(jmodel), accum_steps=accum_steps
    ))
    model = _port_model(params)
    opt = optim.clip_grad_norm(optim.AdamW(model, lr=LR, weight_decay=1e-4),
                               1.0)
    state = TrainState(model, opt, policy=Policy.full())
    step = build_train_step(causal_lm_loss_fn(model), accum_steps=accum_steps)
    for i in range(3):
        batch = _batch(10 + i, packed=i == 2)
        with use_policy(F32):
            jstate, jmetrics = jstep(
                jstate, {k: jnp.asarray(v) for k, v in batch.items()}
            )
        state, metrics = step(state, _torch(batch))
        _close(float(metrics["loss"]), float(jmetrics["loss"]), LOSS_RTOL,
               f"loss at step {i}")
        want = gpt2_params_from_jax(jax.device_get(jstate.params),
                                    GPT2Config.tiny())
        for name, p in model.named_parameters():
            got, ref = p.detach().numpy(), want[name].numpy()
            if name.endswith("attn_qkv.bias"):  # drop the key bias (above)
                D = got.shape[0] // 3
                got, ref = np.delete(got, np.s_[D:2 * D]), np.delete(
                    ref, np.s_[D:2 * D])
            np.testing.assert_allclose(got, ref, rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{name} after step {i}")
    assert state.step == 3 == int(jstate.step)


def test_optimizers_and_schedule_match_optax():
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 3 for s in shapes]
             for _ in range(4)]
    sched = optim.WarmupCosine(1e-2, 2, 6, eta_min=1e-4)
    jsched = jax_optim.WarmupCosine(1e-2, 2, 6, eta_min=1e-4)
    for t in range(9):
        assert abs(sched(t) - float(jsched(t))) <= 1e-9 + 1e-6 * sched(t)
    cases = [
        (lambda ps: optim.clip_grad_norm(
            optim.AdamW(ps, lr=sched, weight_decay=0.01), 1.0),
         optax.chain(optax.clip_by_global_norm(1.0),
                     jax_optim.AdamW(jsched, weight_decay=0.01))),
        (lambda ps: optim.Adam(ps, lr=1e-2, weight_decay=0.1),
         jax_optim.Adam(1e-2, weight_decay=0.1)),
    ]
    for make, tx in cases:
        params = [torch.tensor(a, requires_grad=True) for a in init]
        opt = make(params)
        jparams = [jnp.asarray(a) for a in init]
        jstate = tx.init(jparams)
        for g in grads:
            for p, gi in zip(params, g):
                p.grad = torch.tensor(gi)
            opt.step()
            upd, jstate = tx.update([jnp.asarray(gi) for gi in g], jstate,
                                    jparams)
            jparams = optax.apply_updates(jparams, upd)
            for p, jp in zip(params, jparams):
                _close(p.detach().numpy(), jp, 1e-6, type(opt).__name__)


def test_clip_matches_optax_above_and_below_the_norm():
    rng = np.random.default_rng(2)
    g = [rng.normal(size=(4, 4)).astype(np.float32) for _ in range(3)]
    for max_norm in (0.5, 100.0):
        params = [torch.zeros(4, 4, requires_grad=True) for _ in g]
        for p, gi in zip(params, g):
            p.grad = torch.tensor(gi)
        clipped = optim.clip_grad_norm(torch.optim.SGD(params, lr=1.0),
                                       max_norm)
        norm = clipped.clip_()
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(x) for x in g], None
        )
        assert abs(norm.item() - float(optax.global_norm(g))) < 1e-5
        for p, w in zip(params, want):
            _close(p.grad.numpy(), w, 1e-6, f"clip {max_norm}")


def test_no_decay_mask_exempts_biases_and_norms():
    model = GPT2LMHead(GPT2Config.tiny(), device="cpu")
    mask = optim.no_decay_mask()(model)
    assert not mask["blocks.0.ln1.weight"] and not mask["ln_f.weight"]
    assert not mask["blocks.1.mlp_up.bias"]
    assert mask["blocks.0.attn_qkv.weight"] and mask["wte.weight"]
    opt = optim.AdamW(model, no_decay=optim.DEFAULT_NO_DECAY)
    assert [g["weight_decay"] for g in opt.param_groups] == [0.01, 0.0]


def test_packing_and_loader_order_are_integer_equal_to_jax():
    rng = np.random.default_rng(4)
    docs = [rng.integers(1, 100, size=int(n))
            for n in rng.integers(1, 50, size=30)]
    got, want = pack_documents(docs, 32), jax_pack_documents(docs, 32)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(
        packed_loss_mask(torch.from_numpy(got["segment_ids"])).numpy(),
        jax_packed_loss_mask(want["segment_ids"]),
    )
    kw = dict(n=37, seq_len=8, vocab_size=100, seed=3)
    loader = DataLoader(SyntheticTextDataset(**kw), 4, seed=5)
    jloader = JaxDataLoader(JaxSyntheticTextDataset(**kw), 4, seed=5)
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        got = [b["input_ids"].numpy() for b in loader]
        want = [np.asarray(b["input_ids"]) for b in jloader]
        assert len(got) == len(want) == 37 // 4
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_dropout_is_reproducible_port_vs_port(jax_pair):
    """Dropout masks come from generator_for(step, tag) alone: two models
    stepped from the same weights on the same batch give identical masks,
    losses and parameters; another tag gives other masks."""
    _, params = jax_pair
    ids = torch.from_numpy(_batch(3)["input_ids"])

    def fwd(tag):
        model = _port_model(params, dropout_rate=0.1)
        return model(ids, train=True, generator=generator_for(0, tag, "cpu"))

    with torch.no_grad():
        a, b, c = fwd(1), fwd(1), fwd(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    runs = []
    for _ in range(2):
        model = _port_model(params, dropout_rate=0.1)
        opt = optim.AdamW(model, lr=LR)
        step = build_train_step(causal_lm_loss_fn(model), accum_steps=2)
        state, losses = TrainState(model, opt), []
        for _ in range(2):
            state, metrics = step(state, {"input_ids": ids})
            losses.append(float(metrics["loss"]))
        runs.append((losses, [p.detach().clone() for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(p, q) for p, q in zip(runs[0][1], runs[1][1]))


def test_fit_logs_and_halts_on_divergence():
    ds = SyntheticTextDataset(n=12, seq_len=8, vocab_size=512, seed=0)
    model = GPT2LMHead(GPT2Config.tiny(), device="cpu", policy=Policy.full())
    model.init_weights(torch.Generator().manual_seed(0))
    trainer = Trainer(
        TrainState(model, optim.AdamW(model, lr=LR)),
        build_train_step(causal_lm_loss_fn(model)), DataLoader(ds, 4),
        config=TrainerConfig(epochs=2, log_every=1, max_steps_per_epoch=2),
    )
    trainer.fit()
    assert [r["step"] for r in trainer.history] == [1, 2, 3, 4]
    assert [r["epoch"] for r in trainer.history] == [0, 0, 1, 1]
    assert all(np.isfinite(r["loss"]) for r in trainer.history)

    def nan_step(state, batch):
        return state, {"loss": torch.tensor(float("nan"))}

    trainer = Trainer(TrainState(model, None), nan_step, DataLoader(ds, 4),
                      config=TrainerConfig(log_every=1))
    with pytest.raises(TrainingDiverged, match="3 consecutive"):
        trainer.fit()


def test_recipe_trains_on_cpu_and_refuses_the_unported():
    base = ["--size", "tiny", "--device", "cpu", "--batch-size", "4",
            "--seq-len", "16", "--steps-per-epoch", "2", "--log-every", "1"]
    trainer = gpt2_recipe.main(base + ["--accum-steps", "2"])
    assert trainer.state.step == 2 and len(trainer.history) == 2
    assert all(np.isfinite(r["loss"]) for r in trainer.history)
    for extra, item in ((["--strategy", "auto"], "A10"), (["--pp", "2"],
                        "A10")):
        with pytest.raises(NotImplementedError, match=item):
            gpt2_recipe.main(base + extra)
    # --sample is ported (tests/test_torch_generation.py holds it)
    sampled = gpt2_recipe.main(base + ["--sample", "4"]).sample
    assert tuple(sampled.shape) == (2, 12)
