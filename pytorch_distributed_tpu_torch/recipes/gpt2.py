"""GPT-2 causal-LM training: the single-device and data-parallel paths
of ``recipes/gpt2_zero1.py``.

Synthetic token rows, ``Policy.train()`` (f32 weights and AdamW state,
bf16 products), gradient clipping at 1.0 then ``adamw(lr)`` with optax's
default weight decay of 1e-4, as the JAX recipe chains them, microbatch
accumulation with ``--accum-steps``. Attention runs through the flash
kernels on the card.

    python -m pytorch_distributed_tpu_torch.recipes.gpt2 --size medium \\
        --batch-size 8 --accum-steps 1 --seq-len 1024 --steps-per-epoch 20

``--strategy dp`` trains one process per card under ``torchrun`` (or
alone, as a world of one) through ``parallel.DataParallel``: DDP, each
rank taking its share of every global batch. ``--device cpu`` runs the
plain PyTorch path on the CPU (at ``--size tiny``; gloo for ``dp``). The
JAX recipe's ZeRO-1 and auto strategies, pipeline stages and text
corpora are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import logging

import torch

from pytorch_distributed_tpu_torch.data import DataLoader, SyntheticTextDataset
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from pytorch_distributed_tpu_torch.optim import AdamW, clip_grad_norm
from pytorch_distributed_tpu_torch.parallel import DataParallel
from pytorch_distributed_tpu_torch.runtime import distributed as dist
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.runtime.prng import seed_all
from pytorch_distributed_tpu_torch.train import (
    Trainer,
    TrainerConfig,
    TrainState,
    build_train_step,
    causal_lm_loss_fn,
)
from pytorch_distributed_tpu_torch.utils.logging import get_logger

SIZES = {
    "tiny": GPT2Config.tiny,
    "small": GPT2Config.small,
    "medium": GPT2Config.medium,  # the reference's size
}
# optax.adamw's default, which the JAX recipe's adamw(lr) decays by
ADAMW_WEIGHT_DECAY = 1e-4

logger = get_logger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", choices=SIZES, default="medium")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=32, help="global batch")
    p.add_argument("--accum-steps", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="the CUDA card unless given (e.g. 'cpu')")
    p.add_argument("--strategy", choices=("single", "zero1", "dp", "auto"),
                   default="single")
    p.add_argument("--pp", type=int, default=1, help="pipeline stages")
    p.add_argument("--text-file", default=None)
    return p.parse_args(argv)


def main(argv=None) -> Trainer:
    args = parse_args(argv)
    if args.strategy == "zero1":
        raise NotImplementedError(
            "--strategy zero1: ZeRO-1 is not ported (ROADMAP A6)"
        )
    if args.strategy == "auto":
        raise NotImplementedError(
            "--strategy auto: the cost-model planner is not ported "
            "(ROADMAP A10)"
        )
    if args.pp > 1:
        raise NotImplementedError(
            "--pp: pipeline parallelism is not ported (ROADMAP A10)"
        )
    if args.text_file:
        raise NotImplementedError(
            "--text-file: the tokenizer and text datasets are not ported "
            "(ROADMAP A2)"
        )
    seed_all(args.seed)
    device = dist.rank_device(args.device)
    own_group = args.strategy == "dp" and not dist.is_initialized()
    if own_group:
        dist.init_process_group(device=device)
    try:
        return _train(args, device)
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(args, device) -> Trainer:
    cfg = SIZES[args.size]()
    seq_len = min(args.seq_len, cfg.n_positions)
    policy = Policy.train()
    model = GPT2LMHead(cfg, device=device, policy=policy)
    model.init_weights(torch.Generator(device=device).manual_seed(args.seed))
    optimizer = clip_grad_norm(
        AdamW(model, lr=args.lr, weight_decay=ADAMW_WEIGHT_DECAY), 1.0
    )
    if args.strategy == "dp":
        model = DataParallel(device).wrap(model)
    n = (args.steps_per_epoch or 100) * args.batch_size
    ds = SyntheticTextDataset(
        n=n, seq_len=seq_len, vocab_size=cfg.vocab_size, seed=args.seed
    )
    trainer = Trainer(
        TrainState(model, optimizer, policy=policy),
        build_train_step(causal_lm_loss_fn(model),
                         accum_steps=args.accum_steps),
        DataLoader(ds, args.batch_size, seed=args.seed, sharding=device),
        config=TrainerConfig(
            epochs=args.epochs, log_every=args.log_every,
            max_steps_per_epoch=args.steps_per_epoch,
        ),
    )
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("GPT-2 %s: %d params on %s, batch %d x seq %d, accum %d, "
                "%s over %d rank(s)", args.size, n_params, device,
                args.batch_size, seq_len, args.accum_steps, args.strategy,
                dist.get_world_size())
    trainer.fit()
    logger.info("done: step=%d", trainer.state.step)
    return trainer


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
