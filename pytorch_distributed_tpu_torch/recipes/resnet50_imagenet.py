"""ResNet-50 / ImageNet, data-parallel: the port of
``recipes/resnet50_imagenet.py``.

One process per card, ``DataParallel`` (DDP, BatchNorm statistics over
the global batch; ``--strategy zero1`` adds ``ZeroRedundancyOptimizer``
over SGD) over NCCL on the cards or gloo on the CPU. The data is a
synthetic ImageNet-shaped stream (224x224x3, 1000 classes) of raw uint8
pixels from the loader's prefetch thread, normalized and randomly
flipped on the card inside the train step; or, with ``--data-dir``
holding ``train/`` and ``val/`` image folders (``root/<class>/<img>``),
JPEGs decoded by ``FolderImagePipeline`` (random-resized crop and flip,
or resize and center crop) with ``--io-retries`` retries of a transient
read and one quarantine of undecodable files over both folders, at
most ``--bad-sample-budget`` of them. ``Policy.train()`` (f32 weights,
bf16 products), SGD with Nesterov momentum on a warmup-cosine schedule
from 0, label smoothing, L2 decay on the kernels, and one evaluation
pass on the running statistics after every epoch (on the EMA shadow
with ``--ema-decay``).

    torchrun --nproc-per-node 4 -m \\
        pytorch_distributed_tpu_torch.recipes.resnet50_imagenet \\
        --batch-size 512 --steps-per-epoch 20
    python -m pytorch_distributed_tpu_torch.recipes.resnet50_imagenet \\
        --batch-size 128 --steps-per-epoch 20          # one card, alone
    python -m pytorch_distributed_tpu_torch.recipes.resnet50_imagenet \\
        --device cpu --image-size 32 --batch-size 8 --steps-per-epoch 2

``--batch-size`` is the global batch; every rank takes its share. Alone
(no torchrun environment) the recipe is a world of one. ``--ckpt-dir``
checkpoints after every epoch (with the sampler cursor), in the format
both packages read, restores the newest intact checkpoint first, and on
SIGTERM checkpoints and exits ``EX_TEMPFAIL`` (75).
``--metrics-path`` and ``--tensorboard-dir`` write the scalars (rank
0), ``--trace-dir`` the span trace, ``--grad-compress`` compresses the
gradient sync. ``--strategy auto`` is not ported and raises (ROADMAP
A10); the checkpoint-lifecycle flags (ROADMAP A5) are not parsed.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from pytorch_distributed_tpu_torch.data import (
    DataLoader,
    FolderImagePipeline,
    ImageFolderDataset,
    SampleQuarantine,
    SyntheticImageDataset,
    device_normalizer_for,
    host_flip_transform,
)
from pytorch_distributed_tpu_torch.models.resnet import ResNet50
from pytorch_distributed_tpu_torch.optim import SGD, WarmupCosine
from pytorch_distributed_tpu_torch.parallel import DataParallel, ZeRO1
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

# torchvision's unit-domain ImageNet statistics
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=90)
    p.add_argument("--batch-size", type=int, default=1024,
                   help="global batch, split over the ranks")
    p.add_argument("--lr", type=float, default=0.4,
                   help="peak lr (linear scaling: 0.1 * batch / 256)")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4,
                   help="L2 on conv and linear kernels")
    p.add_argument("--label-smoothing", type=float, default=0.1)
    p.add_argument("--warmup-epochs", type=int, default=5)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--train-samples", type=int, default=1_281_167)
    p.add_argument("--eval-samples", type=int, default=50_000)
    p.add_argument("--no-flip-augment", dest="flip_augment",
                   action="store_false")
    p.add_argument("--stem", choices=("imagenet", "s2d"), default="imagenet")
    p.add_argument("--no-device-normalize", dest="device_normalize",
                   action="store_false",
                   help="ship f32 batches normalized on the host")
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="truncate epochs (sizes the synthetic sets)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--device", default=None,
                   help="this rank's card unless given (e.g. 'cpu')")
    p.add_argument("--dp", type=int, default=-1,
                   help="data-parallel width (-1: every rank)")
    p.add_argument("--strategy", choices=("dp", "zero1", "auto"),
                   default="dp")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="nccl on cards, gloo anywhere (default: by device)")
    p.add_argument("--data-dir", default=None,
                   help="image folders train/ and val/ (else synthetic)")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic data even where --data-dir has folders")
    p.add_argument("--io-retries", type=int, default=2,
                   help="transient read retries a sample (--data-dir)")
    p.add_argument("--bad-sample-budget", type=int, default=100,
                   help="undecodable samples quarantined before a hard "
                   "error (--data-dir)")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="EMA of the parameters (0: off); evaluations use it")
    p.add_argument("--grad-compress", default=None,
                   choices=("bf16", "fp16", "int8"),
                   help="compress the multi-process gradient sync")
    p.add_argument("--metrics-path", default=None,
                   help="JSONL scalar metrics log (rank 0)")
    p.add_argument("--tensorboard-dir", default=None,
                   help="TensorBoard event files (rank 0)")
    p.add_argument("--trace-dir", default=None,
                   help="span trace output dir (trace.json)")
    p.add_argument("--ckpt-dir", default=None)
    return p.parse_args(argv)


def main(argv=None) -> Trainer:
    args = parse_args(argv)
    if args.strategy == "auto":
        raise NotImplementedError("--strategy auto: the cost-model planner "
                                  "is not ported (ROADMAP A10)")
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


def _folders(args):
    """``data_dir`` when it holds ``train/`` image folders (and the run is
    not ``--synthetic``), else None."""
    if args.synthetic or args.data_dir is None:
        return None
    if os.path.isdir(os.path.join(args.data_dir, "train")):
        return args.data_dir
    if dist.get_rank() == 0:
        logger.info("no train/ folder under %r: synthetic data",
                    args.data_dir)
    return None


def _train(args, device: torch.device) -> Trainer:
    world = dist.get_world_size()
    MeshSpec(dp=args.dp).resolve(world)
    if dist.get_rank() == 0:
        logger.info("resnet50/imagenet: world=%d backend=%s batch=%d "
                    "image=%d device=%s strategy=%s", world,
                    dist.get_backend(), args.batch_size, args.image_size,
                    device, args.strategy)
    shape = (args.image_size, args.image_size, 3)
    root = _folders(args)
    train_fetch = eval_fetch = None
    if root is not None:
        train_ds = ImageFolderDataset(os.path.join(root, "train"))
        eval_ds = ImageFolderDataset(os.path.join(root, "val"))
        # one quarantine and one budget over train and val: one disk
        quarantine = SampleQuarantine(args.bad_sample_budget)
        train_fetch = FolderImagePipeline(
            args.image_size, train=True, seed=args.seed,
            device_normalize=args.device_normalize,
            io_retries=args.io_retries, quarantine=quarantine)
        eval_fetch = FolderImagePipeline(
            args.image_size, train=False,
            device_normalize=args.device_normalize,
            io_retries=args.io_retries, quarantine=quarantine)
        n_train = len(train_ds)
        if dist.get_rank() == 0:
            logger.info("image folders: %d train / %d eval images, %d "
                        "classes", n_train, len(eval_ds),
                        len(train_ds.classes))
    else:
        n_train, n_eval = args.train_samples, args.eval_samples
        if args.steps_per_epoch:
            n_train = args.steps_per_epoch * args.batch_size
            n_eval = min(n_eval, args.batch_size * 2)
        dtype = np.uint8 if args.device_normalize else np.float32
        train_ds = SyntheticImageDataset(n=n_train, image_shape=shape,
                                         num_classes=1000, seed=args.seed,
                                         dtype=dtype)
        eval_ds = SyntheticImageDataset(n=n_eval, image_shape=shape,
                                        num_classes=1000, seed=args.seed + 1,
                                        dtype=dtype)

    policy = Policy.train()
    model = ResNet50(num_classes=1000, stem=args.stem, device=device,
                     policy=policy)
    model.init_weights(torch.Generator(device=device).manual_seed(args.seed))

    steps_per_epoch = max(n_train // args.batch_size, 1)
    total_steps = max(args.epochs * steps_per_epoch, 1)
    # short runs: keep at least one cosine step after the warmup
    warmup_steps = min(args.warmup_epochs * steps_per_epoch, total_steps - 1)
    schedule = WarmupCosine(args.lr, warmup_steps, total_steps)
    if args.strategy == "zero1":
        strategy = ZeRO1(device)
        optimizer = strategy.optimizer(model, SGD, lr=schedule,
                                       momentum=args.momentum, nesterov=True)
    else:
        strategy = DataParallel(device)
        optimizer = SGD(model, lr=schedule, momentum=args.momentum,
                        nesterov=True)
    ddp = strategy.wrap(model, grad_compress=args.grad_compress)
    train_loader = DataLoader(
        train_ds, args.batch_size, seed=args.seed,
        sharding=strategy.batch_sharding(), fetch=train_fetch,
        # folders flip at decode; the uint8 stream flips on the card
        transform=(host_flip_transform(args.seed)
                   if args.flip_augment and train_fetch is None
                   and not args.device_normalize else None),
    )
    eval_loader = DataLoader(eval_ds, args.batch_size, shuffle=False,
                             drop_last=False,
                             sharding=strategy.batch_sharding(),
                             fetch=eval_fetch)
    train_normalizer = eval_normalizer = None
    if args.device_normalize:
        if train_fetch is not None:
            train_normalizer = train_fetch.device_normalizer()
            eval_normalizer = eval_fetch.device_normalizer()
        else:
            train_normalizer = device_normalizer_for(MEAN, STD,
                                                     flip=args.flip_augment)
            eval_normalizer = device_normalizer_for(MEAN, STD)
    ema = args.ema_decay > 0
    trainer = Trainer(
        TrainState(ddp, optimizer, policy=policy, ema=ema),
        build_train_step(
            classification_loss_fn(ddp, weight_decay=args.weight_decay,
                                   label_smoothing=args.label_smoothing),
            batch_transform=train_normalizer,
            grad_compression=args.grad_compress,
            ema_decay=args.ema_decay if ema else None,
        ),
        train_loader,
        eval_step=classification_eval_step(model,
                                           batch_transform=eval_normalizer),
        eval_loader=eval_loader,
        config=TrainerConfig(epochs=args.epochs, log_every=args.log_every,
                             max_steps_per_epoch=args.steps_per_epoch,
                             ckpt_dir=args.ckpt_dir,
                             metrics_path=args.metrics_path,
                             tensorboard_dir=args.tensorboard_dir,
                             eval_with_ema=ema, trace=args.trace_dir),
    )
    trainer.restore_checkpoint()
    try:
        fit_elastic(trainer)
    finally:
        for fetch in (train_fetch, eval_fetch):
            if fetch is not None:
                fetch.close()
    if dist.get_rank() == 0:
        logger.info("done: step=%d %s", trainer.state.step,
                    trainer.last_eval_metrics)
    return trainer


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
