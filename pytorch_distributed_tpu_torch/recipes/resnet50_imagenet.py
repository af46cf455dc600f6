"""ResNet-50 / ImageNet, data-parallel: the port of
``recipes/resnet50_imagenet.py``.

One process per card, ``DataParallel`` (DDP, BatchNorm statistics over
the global batch) over NCCL on the cards or gloo on the CPU. The data is
a synthetic ImageNet-shaped stream (224x224x3, 1000 classes): raw uint8
pixels from the loader's prefetch thread, normalized and randomly
flipped on the card inside the train step. ``Policy.train()`` (f32
weights, bf16 products), SGD with Nesterov momentum on a warmup-cosine
schedule from 0, label smoothing, L2 decay on the kernels, and one
evaluation pass on the running statistics after every epoch.

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
SIGTERM checkpoints and exits ``EX_TEMPFAIL`` (75). ``--strategy
zero1|auto``, a real ``--data-dir``, ``--ema-decay`` and
``--tensorboard-dir`` are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from pytorch_distributed_tpu_torch.data import (
    DataLoader,
    SyntheticImageDataset,
    device_normalizer_for,
    host_flip_transform,
)
from pytorch_distributed_tpu_torch.models.resnet import ResNet50
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
    p.add_argument("--data-dir", default=None)
    p.add_argument("--ema-decay", type=float, default=0.0)
    p.add_argument("--tensorboard-dir", default=None)
    p.add_argument("--ckpt-dir", default=None)
    return p.parse_args(argv)


def _refuse_unported(args) -> None:
    refusals = (
        (args.strategy == "zero1", "--strategy zero1: ZeRO-1 for the "
         "ResNet recipe is not ported (ROADMAP A6)"),
        (args.strategy == "auto", "--strategy auto: the cost-model "
         "planner is not ported (ROADMAP A10)"),
        (args.data_dir is not None, "--data-dir: real ImageNet folders "
         "(data/image_folder.py and the native pipeline) are not ported "
         "(ROADMAP A2)"),
        (args.ema_decay > 0, "--ema-decay: ModelEMA is not ported "
         "(ROADMAP A5)"),
        (args.tensorboard_dir is not None, "--tensorboard-dir: the "
         "trainer's metric writers are not ported (ROADMAP A5)"),
    )
    for refused, why in refusals:
        if refused:
            raise NotImplementedError(why)


def main(argv=None) -> Trainer:
    args = parse_args(argv)
    _refuse_unported(args)
    seed_all(args.seed)
    device = dist.rank_device(args.device)
    own_group = not dist.is_initialized()
    if own_group:
        dist.init_process_group(device=device)
    try:
        return _train(args, device)
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(args, device: torch.device) -> Trainer:
    world = dist.get_world_size()
    MeshSpec(dp=args.dp).resolve(world)
    if dist.get_rank() == 0:
        logger.info("resnet50/imagenet: world=%d backend=%s batch=%d "
                    "image=%d device=%s", world, dist.get_backend(),
                    args.batch_size, args.image_size, device)
    shape = (args.image_size, args.image_size, 3)
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
    optimizer = SGD(model, lr=schedule, momentum=args.momentum,
                    nesterov=True)

    strategy = DataParallel(device)
    ddp = strategy.wrap(model)
    train_loader = DataLoader(
        train_ds, args.batch_size, seed=args.seed,
        sharding=strategy.batch_sharding(),
        transform=(host_flip_transform(args.seed)
                   if args.flip_augment and not args.device_normalize
                   else None),
    )
    eval_loader = DataLoader(eval_ds, args.batch_size, shuffle=False,
                             drop_last=False,
                             sharding=strategy.batch_sharding())
    train_normalizer = eval_normalizer = None
    if args.device_normalize:
        train_normalizer = device_normalizer_for(MEAN, STD,
                                                 flip=args.flip_augment)
        eval_normalizer = device_normalizer_for(MEAN, STD)
    trainer = Trainer(
        TrainState(ddp, optimizer, policy=policy),
        build_train_step(
            classification_loss_fn(ddp, weight_decay=args.weight_decay,
                                   label_smoothing=args.label_smoothing),
            batch_transform=train_normalizer,
        ),
        train_loader,
        eval_step=classification_eval_step(model,
                                           batch_transform=eval_normalizer),
        eval_loader=eval_loader,
        config=TrainerConfig(epochs=args.epochs, log_every=args.log_every,
                             max_steps_per_epoch=args.steps_per_epoch,
                             ckpt_dir=args.ckpt_dir),
    )
    trainer.restore_checkpoint()
    fit_elastic(trainer)
    if dist.get_rank() == 0:
        logger.info("done: step=%d %s", trainer.state.step,
                    trainer.last_eval_metrics)
    return trainer


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
