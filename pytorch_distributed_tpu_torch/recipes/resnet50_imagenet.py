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
0), ``--trace-dir`` the span trace, ``--profile-dir`` a
``torch.profiler`` trace of the whole fit, ``--grad-compress``
compresses the gradient sync, ``--log-mfu`` logs TFLOP/s and MFU.
The flags are the fields of :class:`Config` (``utils/config.py``'s
``RecipeConfig`` and the JAX recipe's own): ``--ckpt-every-steps``,
``--keep-checkpoints``, ``--keep-best``/``--best-mode`` and
``--async-checkpoint`` drive the Trainer's checkpoint lifecycle.
``--strategy auto``, ``--fsdp`` and ``--tp`` above 1 are not ported and
raise (ROADMAP A10).
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
from pytorch_distributed_tpu_torch.utils.config import RecipeConfig, parse_cli
from pytorch_distributed_tpu_torch.utils.logging import get_logger
from pytorch_distributed_tpu_torch.utils.profiler import maybe_trace

logger = get_logger(__name__)

# torchvision's unit-domain ImageNet statistics
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


@dataclasses.dataclass
class Config(RecipeConfig):
    """The JAX recipe's ``Config``: every field of its ``RecipeConfig`` and
    its own, with the port's ``device`` and ``grad_compress`` beside
    them."""

    epochs: int = 90  # doc: standard ImageNet schedule
    batch_size: int = 1024  # doc: global batch (split over dp)
    lr: float = 0.4  # doc: peak LR (linear-scaling rule: 0.1 * batch/256)
    momentum: float = 0.9  # doc: SGD momentum
    weight_decay: float = 1e-4  # doc: L2 on conv/linear kernels
    label_smoothing: float = 0.1  # doc: softmax label smoothing
    warmup_epochs: int = 5  # doc: linear LR warmup epochs
    image_size: int = 224  # doc: square input resolution
    train_samples: int = 1_281_167  # doc: synthetic train-set size
    eval_samples: int = 50_000  # doc: synthetic eval-set size
    flip_augment: bool = True  # doc: random horizontal flip augmentation
    stem: str = "imagenet"  # doc: stem variant: imagenet | s2d
    log_mfu: bool = False  # doc: append achieved TFLOP/s + MFU to step logs
    device_normalize: bool = True  # doc: ship uint8 batches, normalize on the card (--no-device-normalize: f32 from the host)
    ema_decay: float = 0.0  # doc: EMA of the parameters (0 disables); evals use the shadow
    tensorboard_dir: str = ""  # doc: TensorBoard event-file dir (rank 0)
    io_retries: int = 2  # doc: transient read retries per sample (--data-dir)
    bad_sample_budget: int = 100  # doc: max quarantined (undecodable) samples before a hard error
    strategy: str = "dp"  # doc: parallel strategy: dp | zero1 (auto: ROADMAP A10)
    plan_path: str = "plan.json"  # doc: --strategy auto's report (not ported)
    costmodel: str = "costmodel.json"  # doc: --strategy auto's cost model (not ported)
    device: Optional[str] = None  # doc: this rank's card unless given (e.g. 'cpu')
    grad_compress: Optional[str] = None  # doc: bf16|fp16|int8: compress the multi-process gradient sync


def parse_args(argv=None) -> Config:
    cfg = parse_cli(Config, argv, description=__doc__.splitlines()[0])
    if cfg.strategy not in ("dp", "zero1", "auto"):
        raise SystemExit(f"--strategy must be dp, zero1 or auto, got "
                         f"{cfg.strategy!r}")
    if cfg.stem not in ("imagenet", "s2d"):
        raise SystemExit(f"--stem must be imagenet or s2d, got {cfg.stem!r}")
    if cfg.backend not in (None, "nccl", "gloo"):
        raise SystemExit(f"--backend must be nccl or gloo, got "
                         f"{cfg.backend!r}")
    if cfg.grad_compress not in (None, "bf16", "fp16", "int8"):
        raise SystemExit(f"--grad-compress must be bf16, fp16 or int8, got "
                         f"{cfg.grad_compress!r}")
    return cfg


def _refuse_unported(cfg: Config) -> None:
    if cfg.strategy == "auto":
        raise NotImplementedError("--strategy auto: the cost-model planner "
                                  "is not ported (ROADMAP A10)")
    if cfg.fsdp > 1 or cfg.tp > 1:
        raise NotImplementedError(
            "--fsdp/--tp above 1: the ResNet recipe is data-parallel in the "
            "port; sharded and tensor-parallel meshes are ROADMAP A10")


def main(argv=None) -> Trainer:
    args = parse_args(argv)
    _refuse_unported(args)
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
                             ckpt_every_steps=args.ckpt_every_steps,
                             keep_checkpoints=args.keep_checkpoints,
                             keep_best=args.keep_best,
                             best_mode=args.best_mode,
                             async_checkpoint=args.async_checkpoint,
                             metrics_path=args.metrics_path,
                             tensorboard_dir=args.tensorboard_dir or None,
                             eval_with_ema=ema, log_mfu=args.log_mfu,
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
