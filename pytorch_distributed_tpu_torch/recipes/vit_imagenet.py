"""ViT / ImageNet, data-parallel: the port of ``recipes/vit_imagenet.py``.

The ResNet-50 recipe's scaffold (one process per card, ``DataParallel``:
DDP over NCCL on the cards or gloo on the CPU, the batch split over the
ranks) with the transformer classifier and the AdamW + warmup-cosine
schedule the ViT papers use. The data is a synthetic ImageNet-shaped
stream of raw uint8 pixels, normalized and randomly flipped on the card
inside the train step (``--no-device-normalize``: f32 from the host,
flipped there); or, with ``--data-dir`` holding ``train/`` and ``val/``
image folders, JPEGs decoded by ``FolderImagePipeline`` with
``--io-retries`` retries and one quarantine over both folders, at most
``--bad-sample-budget`` undecodable files. ``Policy.train()`` (f32
weights, bf16 products: the attention runs through the flash kernels on
the card), label smoothing, dropout from the step's generator, and one
evaluation pass after every epoch.

    torchrun --nproc-per-node 4 -m \\
        pytorch_distributed_tpu_torch.recipes.vit_imagenet \\
        --batch-size 512 --steps-per-epoch 20
    python -m pytorch_distributed_tpu_torch.recipes.vit_imagenet \\
        --batch-size 128 --steps-per-epoch 20          # one card, alone
    python -m pytorch_distributed_tpu_torch.recipes.vit_imagenet \\
        --device cpu --variant tiny --synthetic --steps-per-epoch 3 \\
        --batch-size 16                                  # smoke

``--batch-size`` is the global batch. ``--ckpt-dir`` checkpoints after
every epoch in the format both packages read and resumes; the other
flags are the fields of :class:`Config` (``utils/config.py``'s
``RecipeConfig`` and the JAX recipe's own). ``--fsdp`` and ``--tp``
above 1 raise (the JAX recipe's mesh is ``dp`` alone).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

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
from pytorch_distributed_tpu_torch.models.vit import ViT, ViTConfig
from pytorch_distributed_tpu_torch.optim import AdamW, WarmupCosine
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
from pytorch_distributed_tpu_torch.utils.config import RecipeConfig, parse_cli
from pytorch_distributed_tpu_torch.utils.logging import get_logger
from pytorch_distributed_tpu_torch.utils.profiler import maybe_trace

logger = get_logger(__name__)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
VARIANTS = {"base": ViTConfig.base, "tiny": ViTConfig.tiny}


@dataclasses.dataclass
class Config(RecipeConfig):
    """The JAX recipe's ``Config``, with the port's ``device``."""

    epochs: int = 90  # doc: training epochs
    batch_size: int = 1024  # doc: global batch (split over dp)
    lr: float = 3e-3  # doc: peak AdamW LR
    weight_decay: float = 0.3  # doc: decoupled AdamW weight decay
    label_smoothing: float = 0.1  # doc: softmax label smoothing
    warmup_epochs: int = 10  # doc: linear LR warmup epochs
    variant: str = "base"  # doc: ViT variant: base | tiny (smoke)
    image_size: int = 0  # doc: square input resolution (0: the variant's default)
    dropout: float = 0.1  # doc: dropout rate
    train_samples: int = 1_281_167  # doc: synthetic train-set size
    eval_samples: int = 50_000  # doc: synthetic eval-set size
    flip_augment: bool = True  # doc: random horizontal flip augmentation
    device_normalize: bool = True  # doc: ship uint8 batches, normalize on the card (--no-device-normalize: f32 from the host)
    tensorboard_dir: str = ""  # doc: TensorBoard event-file dir (rank 0)
    io_retries: int = 2  # doc: transient read retries per sample (real-data path)
    bad_sample_budget: int = 100  # doc: max quarantined (undecodable) samples before hard error
    device: Optional[str] = None  # doc: this rank's card unless given (e.g. 'cpu')


def parse_args(argv=None) -> Config:
    cfg = parse_cli(Config, argv, description=__doc__.splitlines()[0])
    if cfg.variant not in VARIANTS:
        raise SystemExit(f"--variant must be base or tiny, got "
                         f"{cfg.variant!r}")
    if cfg.fsdp > 1 or cfg.tp > 1:
        raise NotImplementedError(
            "--fsdp/--tp above 1: the ViT recipe's mesh is dp alone, as the "
            "JAX recipe's (ROADMAP A10.1)")
    return cfg


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


def _train(args: Config, device: torch.device) -> Trainer:
    MeshSpec(dp=args.dp).resolve(dist.get_world_size())
    base = VARIANTS[args.variant]()
    vcfg = dataclasses.replace(
        base, dropout_rate=args.dropout,
        **({"image_size": args.image_size} if args.image_size else {}))
    shape = (vcfg.image_size, vcfg.image_size, 3)
    if dist.get_rank() == 0:
        logger.info("vit/%s: world=%d backend=%s batch=%d image=%d "
                    "u8_ingest=%s device=%s", args.variant,
                    dist.get_world_size(), dist.get_backend(),
                    args.batch_size, vcfg.image_size, args.device_normalize,
                    device)
    root = (None if args.synthetic or args.data_dir is None
            or not os.path.isdir(os.path.join(args.data_dir, "train"))
            else args.data_dir)
    train_fetch = eval_fetch = None
    train_normalizer = eval_normalizer = None
    if root is not None:
        train_ds = ImageFolderDataset(os.path.join(root, "train"))
        eval_ds = ImageFolderDataset(os.path.join(root, "val"))
        # one quarantine and one budget over train and val: one disk
        quarantine = SampleQuarantine(args.bad_sample_budget)
        train_fetch = FolderImagePipeline(
            vcfg.image_size, train=True, seed=args.seed, mean=IMAGENET_MEAN,
            std=IMAGENET_STD, device_normalize=args.device_normalize,
            io_retries=args.io_retries, quarantine=quarantine)
        eval_fetch = FolderImagePipeline(
            vcfg.image_size, train=False, mean=IMAGENET_MEAN,
            std=IMAGENET_STD, device_normalize=args.device_normalize,
            io_retries=args.io_retries, quarantine=quarantine)
        if args.device_normalize:
            # the folder pipeline flips and crops at decode
            train_normalizer = train_fetch.device_normalizer()
            eval_normalizer = eval_fetch.device_normalizer()
        n_train = len(train_ds)
        if len(train_ds.classes) != vcfg.num_classes:
            vcfg = dataclasses.replace(vcfg,
                                       num_classes=len(train_ds.classes))
    else:
        n_train, n_eval = args.train_samples, args.eval_samples
        if args.steps_per_epoch:
            n_train = args.steps_per_epoch * args.batch_size
            n_eval = min(n_eval, args.batch_size * 2)
        dtype = np.uint8 if args.device_normalize else np.float32
        train_ds = SyntheticImageDataset(
            n=n_train, image_shape=shape, num_classes=vcfg.num_classes,
            seed=args.seed, dtype=dtype)
        eval_ds = SyntheticImageDataset(
            n=n_eval, image_shape=shape, num_classes=vcfg.num_classes,
            seed=args.seed + 1, dtype=dtype)
        if args.device_normalize:
            # normalize and flip inside the train step, on the card
            train_normalizer = device_normalizer_for(
                IMAGENET_MEAN, IMAGENET_STD, flip=args.flip_augment)
            eval_normalizer = device_normalizer_for(IMAGENET_MEAN,
                                                    IMAGENET_STD)

    policy = Policy.train()
    model = ViT(vcfg, device=device, policy=policy)
    model.init_weights(torch.Generator(device=device).manual_seed(args.seed))
    steps_per_epoch = max(n_train // args.batch_size, 1)
    total_steps = max(args.epochs * steps_per_epoch, 1)
    warmup_steps = min(args.warmup_epochs * steps_per_epoch, total_steps - 1)
    optimizer = AdamW(model, lr=WarmupCosine(args.lr, warmup_steps,
                                             total_steps),
                      weight_decay=args.weight_decay)
    strategy = DataParallel(device)
    ddp = strategy.wrap(model)
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
    trainer = Trainer(
        TrainState(ddp, optimizer, policy=policy),
        build_train_step(
            classification_loss_fn(ddp, label_smoothing=args.label_smoothing,
                                   dropout_rng=True),
            batch_transform=train_normalizer),
        train_loader,
        eval_step=classification_eval_step(model,
                                           batch_transform=eval_normalizer),
        eval_loader=eval_loader,
        config=TrainerConfig(epochs=args.epochs, log_every=args.log_every,
                             max_steps_per_epoch=args.steps_per_epoch,
                             ckpt_dir=args.ckpt_dir,
                             ckpt_every_steps=args.ckpt_every_steps,
                             keep_checkpoints=args.keep_checkpoints,
                             keep_best=args.keep_best,
                             best_mode=args.best_mode,
                             async_checkpoint=args.async_checkpoint,
                             metrics_path=args.metrics_path,
                             tensorboard_dir=args.tensorboard_dir or None,
                             trace=args.trace_dir),
    )
    trainer.restore_checkpoint()
    try:
        with maybe_trace(args.profile_dir, device=device):
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
