"""ResNet-18 / CIFAR-10, data-parallel: the port of
``recipes/resnet18_cifar10.py`` (BASELINE.json's first config,
"ResNet-18 / CIFAR-10, single-process gloo backend").

The CIFAR-10 pickles under ``--data-dir`` (``cifar-10-batches-py``) go
through the native augmenting pipeline (``ImageBatchPipeline``: reflect
pad 4, random 32x32 crop and flip for training, center crop for
evaluation) as raw uint8, normalized on the device in the step (or on
the host with ``--no-device-normalize``). Without the pickles, or with
``--synthetic``, it trains on ``SyntheticImageDataset`` (50,000 +
10,000 CIFAR-shaped images) and says so. ``ResNet18(stem="cifar")``
under ``Policy.train()``, SGD with Nesterov momentum on a cosine decay
from ``--lr`` over the run (``optax.cosine_decay_schedule``), L2 on the
kernels, ``DataParallel`` (DDP; ``--grad-compress bf16|fp16|int8`` its
compressed sync), one evaluation after every epoch, ``fit_elastic``.

    python -m pytorch_distributed_tpu_torch.recipes.resnet18_cifar10 \\
        --data-dir /data --epochs 1 --batch-size 128     # one card
    torchrun --nproc-per-node 4 -m \\
        pytorch_distributed_tpu_torch.recipes.resnet18_cifar10 \\
        --grad-compress int8                             # four cards
    python -m pytorch_distributed_tpu_torch.recipes.resnet18_cifar10 \\
        --device cpu --backend gloo --synthetic --steps-per-epoch 5

``--batch-size`` is the global batch. Alone (no torchrun environment)
the recipe is a world of one. ``--backend`` takes the place of the JAX
recipe's ``ici|gloo``: ``nccl`` on the cards, ``gloo`` (the default on
the CPU) anywhere. ``--dp`` is the data-parallel width (every rank).
``--ckpt-dir`` checkpoints after every epoch and resumes;
``--metrics-path`` writes the JSONL scalars (rank 0); ``--trace-dir``
the span trace.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from pytorch_distributed_tpu_torch.data import (
    ArrayDataset,
    DataLoader,
    ImageBatchPipeline,
    SyntheticImageDataset,
    device_normalizer_for,
    load_cifar10,
)
from pytorch_distributed_tpu_torch.models.resnet import ResNet18
from pytorch_distributed_tpu_torch.optim import SGD, WarmupCosine
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
)
from pytorch_distributed_tpu_torch.train.losses import (
    classification_eval_step,
    classification_loss_fn,
)
from pytorch_distributed_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

CIFAR_MEAN, CIFAR_STD = (0.4914, 0.4822, 0.4465), (0.247, 0.243, 0.262)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="nccl on cards, gloo anywhere (default: by device)")
    p.add_argument("--grad-compress", default=None,
                   choices=("bf16", "fp16", "int8"),
                   help="compress the multi-process gradient sync")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=128,
                   help="global batch")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--dp", type=int, default=-1,
                   help="data-parallel width (-1: every rank)")
    p.add_argument("--data-dir", default="/tmp/data")
    p.add_argument("--synthetic", action="store_true",
                   help="skip the CIFAR pickles")
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="truncate epochs (smoke testing)")
    p.add_argument("--no-device-normalize", dest="device_normalize",
                   action="store_false",
                   help="ship host-normalized f32 instead of uint8")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--metrics-path", default=None,
                   help="JSONL scalar metrics log (rank 0)")
    p.add_argument("--trace-dir", default=None,
                   help="span trace output dir (trace.json)")
    p.add_argument("--device", default=None,
                   help="this rank's card unless given (e.g. 'cpu')")
    return p.parse_args(argv)


def main(argv=None) -> Trainer:
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


def _truncate(ds, n: int):
    if isinstance(ds, ArrayDataset):
        return ArrayDataset(**{k: v[:n] for k, v in ds.arrays.items()})
    return SyntheticImageDataset(n=min(n, len(ds)), seed=ds.seed,
                                 dtype=ds.dtype)


def _datasets(args):
    """(train, eval, train fetch, eval fetch, train normalizer, eval
    normalizer): the pickles through the native pipeline, or synthetic
    CIFAR-shaped data on the plain gather."""
    train_ds = eval_ds = None
    if not args.synthetic:
        train_ds = load_cifar10(args.data_dir, train=True, raw_uint8=True)
        eval_ds = load_cifar10(args.data_dir, train=False, raw_uint8=True)
    train_fetch = eval_fetch = None
    train_norm = eval_norm = None
    if train_ds is not None and eval_ds is not None:
        train_fetch = ImageBatchPipeline(
            32, train=True, pad=4, mean=CIFAR_MEAN, std=CIFAR_STD,
            seed=args.seed, device_normalize=args.device_normalize)
        eval_fetch = ImageBatchPipeline(
            32, train=False, mean=CIFAR_MEAN, std=CIFAR_STD,
            device_normalize=args.device_normalize)
        if args.device_normalize:
            train_norm = train_fetch.device_normalizer()
            eval_norm = eval_fetch.device_normalizer()
    else:
        if dist.get_rank() == 0:
            logger.info("CIFAR-10 files not found under %r (or --synthetic):"
                        " using synthetic data", args.data_dir)
        dtype = np.uint8 if args.device_normalize else np.float32
        train_ds = SyntheticImageDataset(n=50_000, seed=args.seed,
                                         dtype=dtype)
        eval_ds = SyntheticImageDataset(n=10_000, seed=args.seed + 1,
                                        dtype=dtype)
        if args.device_normalize:
            train_norm = device_normalizer_for(CIFAR_MEAN, CIFAR_STD)
            eval_norm = device_normalizer_for(CIFAR_MEAN, CIFAR_STD)
    if args.steps_per_epoch:
        train_ds = _truncate(train_ds, args.steps_per_epoch * args.batch_size)
        eval_ds = _truncate(eval_ds, min(len(eval_ds), args.batch_size * 2))
    return train_ds, eval_ds, train_fetch, eval_fetch, train_norm, eval_norm


def _train(args, device: torch.device) -> Trainer:
    world = dist.get_world_size()
    MeshSpec(dp=args.dp).resolve(world)
    if dist.get_rank() == 0:
        logger.info("resnet18/cifar10: world=%d backend=%s batch=%d "
                    "device=%s grad_compress=%s", world, dist.get_backend(),
                    args.batch_size, device, args.grad_compress)
    (train_ds, eval_ds, train_fetch, eval_fetch, train_norm,
     eval_norm) = _datasets(args)

    policy = Policy.train()
    model = ResNet18(num_classes=10, stem="cifar", device=device,
                     policy=policy)
    model.init_weights(torch.Generator(device=device).manual_seed(args.seed))
    steps_per_epoch = len(train_ds) // args.batch_size
    # optax.cosine_decay_schedule(lr, epochs * steps): no warmup
    schedule = WarmupCosine(args.lr, 0, max(args.epochs * steps_per_epoch, 1))
    optimizer = SGD(model, lr=schedule, momentum=args.momentum,
                    nesterov=True)

    strategy = DataParallel(device)
    ddp = strategy.wrap(model, grad_compress=args.grad_compress)
    train_loader = DataLoader(train_ds, args.batch_size, seed=args.seed,
                              sharding=strategy.batch_sharding(),
                              fetch=train_fetch)
    eval_loader = DataLoader(eval_ds, args.batch_size, shuffle=False,
                             drop_last=False,
                             sharding=strategy.batch_sharding(),
                             fetch=eval_fetch)
    trainer = Trainer(
        TrainState(ddp, optimizer, policy=policy),
        build_train_step(
            classification_loss_fn(ddp, weight_decay=args.weight_decay),
            batch_transform=train_norm,
            grad_compression=args.grad_compress),
        train_loader,
        eval_step=classification_eval_step(model, batch_transform=eval_norm),
        eval_loader=eval_loader,
        config=TrainerConfig(epochs=args.epochs, log_every=args.log_every,
                             ckpt_dir=args.ckpt_dir,
                             metrics_path=args.metrics_path,
                             trace=args.trace_dir),
    )
    trainer.restore_checkpoint()
    fit_elastic(trainer)   # fit() evaluates after the last epoch
    if dist.get_rank() == 0:
        logger.info("done: step=%d %s", trainer.state.step,
                    trainer.last_eval_metrics)
    return trainer


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
