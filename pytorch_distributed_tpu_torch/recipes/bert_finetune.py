"""BERT-base fine-tune, DDP + mixed precision: the port of
``recipes/bert_finetune.py``.

Sequence classification (``--num-labels``) on synthetic token rows
(``SyntheticTextDataset`` with labels, as the JAX recipe), or with
``--mlm`` the masked-LM objective (dynamic 80/10/10 masking on the
device, ``--mask-prob``). ``autocast`` selects the products' dtype: bf16,
whose ``GradScaler`` is an exact no-op, or with ``--fp16`` fp16 with real
dynamic loss scaling (``runtime.precision.GradScaler``: a skipped step
leaves the weights, the moments and the optimizer's count as they were).
AdamW with weight decay 0.01 and the HF no-decay groups (biases and
LayerNorm weights, ``optim.DEFAULT_NO_DECAY``), ``parallel.DataParallel``
(DDP). Attention runs through the flash kernels on the card, in bf16 or
fp16. ``main`` returns the ``Trainer``.

    python -m pytorch_distributed_tpu_torch.recipes.bert_finetune \\
        --steps-per-epoch 20 --fp16                  # one card
    torchrun --nproc-per-node 4 -m \\
        pytorch_distributed_tpu_torch.recipes.bert_finetune --batch-size 128

It runs one process per card under ``torchrun``, or alone as a world of
one. ``--ckpt-dir`` checkpoints after every epoch in the format both
packages read (the fp16 scaler's state included), restores the newest
intact checkpoint first, and on SIGTERM checkpoints and exits
``EX_TEMPFAIL`` (75). ``--device cpu`` runs the plain PyTorch path on the
CPU (with ``--tiny``; gloo).

``--lora RANK`` freezes the base and trains rank-RANK adapters on the
attention and MLP kernels (``lora.LoRAModel``, adapters from seed + 1 as
in the JAX recipe): the optimizer, DDP (without the BERT TP rules, as
the JAX recipe's plain ``DataParallel()``) and the checkpoints hold the
adapters only. It composes with ``--fp16`` and ``--mlm``.
``--backend`` is ``nccl`` or ``gloo`` (the device's own unless given).
"""

from __future__ import annotations

import argparse
import logging

import torch

from pytorch_distributed_tpu_torch.data import DataLoader, SyntheticTextDataset
from pytorch_distributed_tpu_torch.models.bert import (
    BertConfig,
    BertForMaskedLM,
    BertForSequenceClassification,
)
from pytorch_distributed_tpu_torch.lora import LoRAModel, lora_param_count
from pytorch_distributed_tpu_torch.ops.quant import (
    QuantizedModel,
    quantize_tree_int4,
    quantize_tree_int8,
)
from pytorch_distributed_tpu_torch.optim import DEFAULT_NO_DECAY, AdamW
from pytorch_distributed_tpu_torch.parallel import DataParallel
from pytorch_distributed_tpu_torch.runtime import distributed as dist
from pytorch_distributed_tpu_torch.runtime.mesh import MeshSpec
from pytorch_distributed_tpu_torch.runtime.precision import (
    GradScaler,
    autocast,
    current_policy,
)
from pytorch_distributed_tpu_torch.runtime.prng import seed_all
from pytorch_distributed_tpu_torch.train import (
    Trainer,
    TrainerConfig,
    TrainState,
    build_train_step,
    fit_elastic,
    masked_lm_loss_fn,
    text_classification_loss_fn,
)
from pytorch_distributed_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=32, help="global batch")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--num-labels", type=int, default=2)
    p.add_argument("--dp", type=int, default=-1)
    p.add_argument("--tiny", action="store_true", help="tiny config (smoke)")
    p.add_argument("--mlm", action="store_true",
                   help="masked-LM objective instead of the classification "
                        "fine-tune (dynamic 80/10/10 masking on the device)")
    p.add_argument("--mask-prob", type=float, default=0.15)
    p.add_argument("--fp16", action="store_true",
                   help="fp16 + real dynamic loss scaling instead of bf16")
    p.add_argument("--lora", type=int, default=0, metavar="RANK",
                   help="LoRA fine-tune at this rank: base weights frozen, "
                        "only rank-R adapters (attention + MLP) train")
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="the CUDA card unless given (e.g. 'cpu')")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="process-group backend (the device's own unless "
                        "given)")
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


def build_trainer(args, device, *, dataset=None, scaler=None,
                  init_seed=None, quantize=None):
    """``(model, trainer)`` as the recipe builds them from ``args``
    (``parse_args``'s): the model under ``autocast`` with seeded weights
    (``init_seed``, else ``--seed``), with ``--lora`` its adapters, in
    ``DataParallel``, its loss, AdamW with the no-decay groups, the step
    with the scaler, the loader over ``dataset`` (the synthetic rows
    unless given) and the trainer. ``scaler`` replaces the recipe's
    ``GradScaler``; ``quantize="int8"`` or ``"int4"`` (with ``--lora``)
    quantizes the frozen base first (QLoRA). ``model`` is the
    ``LoRAModel`` under ``--lora``."""
    MeshSpec(dp=args.dp).resolve(dist.get_world_size())
    cfg = BertConfig.tiny() if args.tiny else BertConfig.base()
    seq_len = min(args.seq_len, cfg.max_position_embeddings)
    if dataset is None:
        n = (args.steps_per_epoch or 100) * args.batch_size
        dataset = SyntheticTextDataset(
            n=n, seq_len=seq_len, vocab_size=cfg.vocab_size,
            num_classes=args.num_labels, seed=args.seed)
    amp_dtype = torch.float16 if args.fp16 else torch.bfloat16
    if scaler is None:
        scaler = GradScaler(dtype=amp_dtype)
    with autocast(dtype=amp_dtype):
        policy = current_policy()
        if args.mlm:
            model = BertForMaskedLM(cfg, device=device)
        else:
            model = BertForSequenceClassification(
                cfg, num_labels=args.num_labels, device=device)
    seed = args.seed if init_seed is None else init_seed
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    if quantize is not None and not args.lora:
        raise ValueError("quantize= is the frozen base of a --lora run")
    if args.lora:
        # the base is frozen; the trainable tree (the optimizer state,
        # the gradients, the checkpoints) is the adapter tree
        n_frozen = sum(p.numel() for p in model.parameters())
        base = model
        if quantize is not None:
            qtree = (quantize_tree_int8(model) if quantize == "int8"
                     else quantize_tree_int4(model))
            base = QuantizedModel(model, qtree)
        model = LoRAModel(base, rank=args.lora, generator=torch.Generator(
            device=device).manual_seed(seed + 1))
        logger.info("lora rank=%d: %d trainable / %d frozen params",
                    args.lora, lora_param_count(model.adapters()), n_frozen)
    strategy = DataParallel(device)
    net = strategy.wrap(model)
    if args.mlm:
        loss_fn = masked_lm_loss_fn(
            net, mask_token_id=min(103, cfg.vocab_size - 1),
            vocab_size=cfg.vocab_size, mask_prob=args.mask_prob)
    else:
        loss_fn = text_classification_loss_fn(net)
    # HF fine-tuning convention: biases and LayerNorm exempt from decay
    optimizer = AdamW(model, lr=args.lr, weight_decay=0.01,
                      no_decay=DEFAULT_NO_DECAY)
    trainer = Trainer(
        TrainState(net, optimizer, policy=policy,
                   scaler_state=scaler.init_state(device)),
        build_train_step(loss_fn, scaler=scaler),
        DataLoader(dataset, args.batch_size, seed=args.seed,
                   sharding=strategy.batch_sharding()),
        config=TrainerConfig(
            epochs=args.epochs, log_every=args.log_every,
            max_steps_per_epoch=args.steps_per_epoch,
            ckpt_dir=args.ckpt_dir, samples_axis="input_ids",
        ),
    )
    return model, trainer


def _train(args, device) -> Trainer:
    model, trainer = build_trainer(args, device)
    scaled = trainer.state.scaler_state is not None
    logger.info("BERT %s (%s): %d trainable params on %s, batch %d x seq "
                "%d, %s over %d rank(s)", "tiny" if args.tiny else "base",
                "mlm" if args.mlm else f"{args.num_labels} labels",
                sum(p.numel() for p in model.parameters()
                    if p.requires_grad), device,
                args.batch_size, args.seq_len,
                "fp16 + loss scaling" if scaled else "bf16",
                dist.get_world_size())
    trainer.restore_checkpoint()
    fit_elastic(trainer)
    logger.info("done: step=%d", trainer.state.step)
    return trainer


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
