"""T5 seq2seq on a synthetic transduction task: the port of
``recipes/t5_seq2seq.py``.

T5 (``--size tiny`` or ``small``, the table cut to ``--vocab`` tokens)
learns to reverse (``--task reverse``) or copy token rows: random ids
>= 2, the label row the transformed input with EOS appended, every label
position real. Training is teacher-forced (``seq2seq_lm_loss_fn``), the
evaluation after every epoch the teacher-forced loss, perplexity and
token accuracy (``seq2seq_eval_step``), and the run ends with a greedy
``generate_encdec`` over ``--eval-rows`` held-out rows (at most a batch)
scored by exact match and token match, the JAX recipe's log line. The
state is ``Policy.train()`` (f32 weights and AdamW state, bf16
products: the cross-attention runs the flash kernels on the card),
``clip_by_global_norm(1.0)`` then ``adamw(--lr)`` with optax's default
decay of 1e-4, as the JAX recipe chains them; ``--dropout`` (0 by
default: the task has nothing to regularize) sets the config's rate.

    python -m pytorch_distributed_tpu_torch.recipes.t5_seq2seq \\
        --size tiny --steps-per-epoch 3 --device cpu          # smoke
    python -m pytorch_distributed_tpu_torch.recipes.t5_seq2seq \\
        --size tiny --epochs 50 --steps-per-epoch 30          # one card
    torchrun --nproc-per-node 2 -m \\
        pytorch_distributed_tpu_torch.recipes.t5_seq2seq --tp 2

The mesh is ``MeshSpec(dp=--dp, tp=--tp)`` under
``DataParallel(extra_rules=t5_partition_rules())``: Megatron tensor
parallelism over ``tp`` (q/k/v and ``wi`` by heads and hidden, ``o`` and
``wo`` row-parallel, ``shared`` on hidden, the bias tables on heads), the
batch split over ``dp``. Above world 1 on a model-parallel mesh the model
is built on the meta device and each rank draws its own box of the
seeded weights; the closing generation runs on the sharded model.
``--ckpt-dir`` checkpoints after every epoch in the format both packages
read and resumes. ``--device cpu`` runs on the CPU (gloo).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

import numpy as np
import torch

from pytorch_distributed_tpu_torch.data import ArrayDataset, DataLoader
from pytorch_distributed_tpu_torch.models.t5 import (
    T5Config,
    T5ForConditionalGeneration,
    generate_encdec,
    t5_partition_rules,
)
from pytorch_distributed_tpu_torch.optim import AdamW, clip_grad_norm
from pytorch_distributed_tpu_torch.parallel import DataParallel
from pytorch_distributed_tpu_torch.runtime import distributed as dist
from pytorch_distributed_tpu_torch.runtime.mesh import MeshSpec
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.runtime.prng import seed_all
from pytorch_distributed_tpu_torch.train import (
    Trainer,
    TrainerConfig,
    TrainState,
    build_train_step,
    fit_elastic,
    seq2seq_eval_step,
    seq2seq_lm_loss_fn,
)
from pytorch_distributed_tpu_torch.utils.logging import get_logger

SIZES = {"tiny": T5Config.tiny, "small": T5Config.small}
# optax.adamw's default, which the JAX recipe's adamw(lr) decays by
ADAMW_WEIGHT_DECAY = 1e-4

logger = get_logger(__name__)


def make_task(n, seq_len, vocab, task, eos_id, seed) -> ArrayDataset:
    """``input_ids`` ``[n, S]`` of random tokens (ids >= 2), ``labels``
    the transformed input and EOS ``[n, S + 1]``, every label real (the
    JAX recipe's rows, numpy-drawn from the same seed)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(2, vocab, size=(n, seq_len)).astype(np.int32)
    out = src[:, ::-1] if task == "reverse" else src
    labels = np.concatenate([out, np.full((n, 1), eos_id, np.int32)],
                            axis=1)
    return ArrayDataset(input_ids=src, labels=labels,
                        label_mask=np.ones_like(labels, dtype=bool))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    p.add_argument("--device", default=None,
                   help="the CUDA card unless given (e.g. 'cpu')")
    p.add_argument("--size", choices=SIZES, default="tiny")
    p.add_argument("--task", choices=("reverse", "copy"), default="reverse")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=32, help="global batch")
    p.add_argument("--seq-len", type=int, default=8)
    p.add_argument("--vocab", type=int, default=64,
                   help="task vocab (the model's table follows)")
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--dp", type=int, default=-1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--eval-rows", type=int, default=64)
    p.add_argument("--dropout", type=float, default=0.0)
    return p.parse_args(argv)


def main(argv=None) -> Trainer:
    """Train, evaluate, then score the greedy generation; returns the
    ``Trainer`` (``trainer.seq2seq`` holds the exact- and token-match
    rates)."""
    args = parse_args(argv)
    seed_all(args.seed)
    device = dist.rank_device(args.device)
    own_group = not dist.is_initialized()
    if own_group:
        dist.init_process_group(args.backend, device=device)
    try:
        return _train(args, device)
    finally:
        if own_group:
            dist.destroy_process_group()


def config_for(args) -> T5Config:
    return dataclasses.replace(SIZES[args.size](), dropout_rate=args.dropout,
                               vocab_size=args.vocab)


def build_model(cfg: T5Config, strategy: DataParallel, device, seed: int,
                policy: Policy):
    """``(model, net)``: the model with weights from ``seed`` and the
    module the step runs (DDP's wrapper, or on a model-parallel mesh the
    sharded model itself, built on the meta device so that each rank
    draws its own box)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if strategy.model_parallel:
        model = T5ForConditionalGeneration(cfg, device="meta", policy=policy)
        strategy.wrap(model)
        model.to_empty(device=device)
        model.init_weights(gen)
        return model, model
    model = T5ForConditionalGeneration(cfg, device=device, policy=policy)
    model.init_weights(gen)
    return model, strategy.wrap(model)


def transduction_eval(model, eval_ds, rows: int, device):
    """Greedy ``generate_encdec`` over the first ``rows`` eval rows
    against their labels: ``(exact-match rate, token-match rate)``."""
    batch = [eval_ds[i] for i in range(rows)]
    enc = torch.from_numpy(np.stack([b["input_ids"] for b in batch]))
    want = np.stack([b["labels"] for b in batch])
    out = generate_encdec(model, enc, max_new_tokens=want.shape[1],
                          eos_id=-1, device=device).cpu().numpy()
    return float((out == want).all(axis=1).mean()), float(
        (out == want).mean())


def _train(args, device) -> Trainer:
    cfg = config_for(args)
    policy = Policy.train()
    strategy = DataParallel(device, mesh_spec=MeshSpec(dp=args.dp,
                                                       tp=args.tp),
                            extra_rules=t5_partition_rules())
    model, net = build_model(cfg, strategy, device, args.seed, policy)
    optimizer = clip_grad_norm(
        AdamW(model, lr=args.lr, weight_decay=ADAMW_WEIGHT_DECAY), 1.0)
    n = (args.steps_per_epoch or 50) * args.batch_size
    ds = make_task(n, args.seq_len, cfg.vocab_size, args.task,
                   cfg.eos_token_id, args.seed)
    eval_ds = make_task(max(args.batch_size, args.eval_rows), args.seq_len,
                        cfg.vocab_size, args.task, cfg.eos_token_id,
                        args.seed + 1)
    trainer = Trainer(
        TrainState(net, optimizer, policy=policy),
        build_train_step(seq2seq_lm_loss_fn(net)),
        DataLoader(ds, args.batch_size, seed=args.seed,
                   sharding=strategy.batch_sharding()),
        eval_step=seq2seq_eval_step(net),
        eval_loader=DataLoader(eval_ds, args.batch_size, shuffle=False,
                               sharding=strategy.batch_sharding()),
        config=TrainerConfig(
            epochs=args.epochs, log_every=args.log_every,
            max_steps_per_epoch=args.steps_per_epoch,
            ckpt_dir=args.ckpt_dir, samples_axis="input_ids"),
    )
    if dist.get_rank() == 0:
        logger.info("t5 %s (%s): world %d (dp %d tp %d) on %s, batch %d x "
                    "%d, vocab %d", args.size, args.task,
                    dist.get_world_size(), strategy.spec.dp, args.tp, device,
                    args.batch_size, args.seq_len, cfg.vocab_size)
    trainer.restore_checkpoint()
    fit_elastic(trainer)
    if dist.get_rank() == 0:
        logger.info("done: step=%d eval=%s", trainer.state.step,
                    trainer.last_eval_metrics)
    rows = min(args.eval_rows, args.batch_size)
    exact, tok = transduction_eval(model, eval_ds, rows, device)
    trainer.seq2seq = dict(exact_match=exact, token_match=tok, rows=rows)
    if dist.get_rank() == 0:
        logger.info("%s exact-match %.3f  token-match %.3f over %d rows",
                    args.task, exact, tok, rows)
    return trainer


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
