"""Rank processes for tests/test_torch_grad_scaler.py (spawned by
``torch_dp_workers.spawn``; this module imports no JAX)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tests.torch_dp_workers import _join, _run

SCALER_STEPS = 4
POISONED_STEP, POISONED_RANK = 1, 1   # step 1: an inf on rank 1 only


def poisoned_loss(loss_fn):
    """``loss_fn`` times the batch's ``poison`` entries (1.0, or inf to
    make every gradient of that rank non-finite)."""

    def fn(batch, generator):
        loss, aux = loss_fn(batch, generator)
        return loss * batch["poison"].max(), aux

    return fn


def scaler_skip(rank, world, port, out):
    """A tiny BERT classifier (fp16 products, f32 weights) in DDP with an
    fp16 ``GradScaler``; at ``POISONED_STEP`` only rank ``POISONED_RANK``
    feeds an inf. Per step: the scaler state, the finite flag, the
    optimizer's count and every parameter, as numpy."""
    from pytorch_distributed_tpu_torch import optim
    from pytorch_distributed_tpu_torch.models import bert
    from pytorch_distributed_tpu_torch.parallel import DataParallel
    from pytorch_distributed_tpu_torch.runtime.precision import (
        GradScaler,
        Policy,
    )
    from pytorch_distributed_tpu_torch.train import (
        TrainState,
        build_train_step,
        text_classification_loss_fn,
    )

    def body():
        _join(rank, world, port)
        cfg = dataclasses.replace(bert.BertConfig.tiny(), dropout_rate=0.0)
        model = bert.BertForSequenceClassification(cfg, device="cpu",
                                                   policy=Policy.fp16())
        model.init_weights(torch.Generator().manual_seed(0))
        net = DataParallel("cpu").wrap(model)
        opt = optim.AdamW(model, lr=1e-3, weight_decay=0.01,
                          no_decay=optim.DEFAULT_NO_DECAY)
        scaler = GradScaler(init_scale=2.0 ** 10, growth_interval=2,
                            dtype=torch.float16)
        state = TrainState(net, opt, policy=Policy.fp16(),
                           scaler_state=scaler.init_state("cpu"))
        step = build_train_step(
            poisoned_loss(text_classification_loss_fn(net)), scaler=scaler)
        rng = np.random.default_rng(100 + rank)
        records = []
        for i in range(SCALER_STEPS):
            poison = (float("inf") if (i, rank) == (POISONED_STEP,
                                                    POISONED_RANK) else 1.0)
            batch = {
                "input_ids": torch.from_numpy(
                    rng.integers(0, cfg.vocab_size, (2, 16)).astype(
                        np.int64)),
                "label": torch.from_numpy(rng.integers(0, 2, (2,))),
                "poison": torch.full((2,), poison),
            }
            state, metrics = step(state, batch)
            counts = {int(s["step"]) for s in opt.state.values()}
            records.append(dict(
                step=state.step,
                scale=float(state.scaler_state.scale),
                tracker=int(state.scaler_state.growth_tracker),
                finite=float(metrics["grads_finite"]),
                count=sorted(counts),
                params={n: p.detach().numpy().copy()
                        for n, p in model.named_parameters()},
            ))
        return records

    _run(rank, out, body)
