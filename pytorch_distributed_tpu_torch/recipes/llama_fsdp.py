"""Llama-3 causal-LM training, FSDP full-shard: the port of
``recipes/llama_fsdp.py``'s ``fsdp``, ``dp`` and ``zero1`` strategies.

Synthetic token rows (``SyntheticTextDataset``, as the JAX recipe),
``Policy.train()`` (f32 weights and optimizer state, bf16 products),
gradient clipping at 1.0 by the global norm then ``adamw(lr)`` with
optax's default weight decay of 1e-4, as the JAX recipe chains them, or
with ``--optimizer adafactor`` Adafactor alone (``optim.Adafactor``:
``optax.adafactor(lr)``, no global clip; its factored second moment
keeps a few MB of state where AdamW keeps two f32 copies of the
weights), microbatch accumulation with ``--accum-steps``. Attention runs through
the flash kernels on the card. ``main`` returns the ``Trainer``.

    python -m pytorch_distributed_tpu_torch.recipes.llama_fsdp --size 8b \\
        --batch-size 8 --seq-len 2048 --remat --vocab-chunk 8192 \\
        --steps-per-epoch 20 --fsdp 4 --ckpt-dir /tmp/llama   # torchrun x4
    ... --size 8b --fsdp 2 --tp 2 --remat --vocab-chunk 8192     # torchrun x4
    ... --size 8b --fsdp 4 --sp 4 --sp-mode ulysses --seq-len 8192 \
        --remat --vocab-chunk 8192                              # x16

``--strategy fsdp`` (the default, as in the JAX recipe) shards the
parameters, gradients and AdamW state over the ``fsdp`` axis of
``MeshSpec(dp=--dp, fsdp=--fsdp)`` (``parallel.FSDP``: FSDP2's
``fully_shard`` on each block, then the root) and replicates them over
``dp``; the model is built on the meta device and each rank draws its
own rows of the seeded weights, so the whole model never exists on one
rank. ``dp`` is DDP and ``zero1`` DDP with the optimizer state sharded
(``parallel.ZeRO1``). Every strategy runs one process per card under
``torchrun``, or alone as a world of one. ``--remat`` (``--remat-policy
full | dots | dots_no_batch``) recomputes each block in the backward,
``--vocab-chunk C`` takes the chunked-vocab loss (``ops/lm_loss.py``).
``--ckpt-dir`` checkpoints after every epoch in the format both packages
read (each FSDP rank writes its own rows), restores the newest intact
checkpoint first, and on SIGTERM checkpoints and exits ``EX_TEMPFAIL``
(75). ``--device cpu`` runs the plain PyTorch path on the CPU (at
``--size tiny``; gloo). ``--tp N`` shards the blocks Megatron-style over
a ``tp`` mesh axis (``llama_partition_rules``) under FSDP over ``fsdp``;
``--tp`` also runs under ``--strategy dp`` (the TP shards replicated
over ``dp``) and ``zero1`` (their moments split over ``dp``,
``parallel.ZeroShards``), at ``--fsdp 1``.
``--sp N`` splits each row's sequence over an ``sp`` axis (the state
replicated over it: the 8B AdamW state, ~128 GB whole, fits a card only
sharded over ``fsdp`` beside it), attention
running as ``--sp-mode ring`` (the default, as in the JAX recipe) or
``ulysses`` while ``fit`` runs (``parallel.sequence_parallel``); it
needs ``--strategy fsdp`` (``dp`` and ``zero1`` raise naming ROADMAP
A10.1, as does ``--optimizer adafactor`` with ``--tp``); ``--strategy
auto`` raises naming A10.6 and ``--optimizer adafactor`` with
``--strategy zero1`` (its leaves split over the ranks) A4.
``--backend`` is ``nccl`` or ``gloo`` (the device's own unless given).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging

import torch

from pytorch_distributed_tpu_torch.data import DataLoader, SyntheticTextDataset
from pytorch_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    llama_partition_rules,
)
from pytorch_distributed_tpu_torch.optim import Adafactor, AdamW, clip_grad_norm
from pytorch_distributed_tpu_torch.parallel import FSDP, DataParallel, ZeRO1
from pytorch_distributed_tpu_torch.runtime import distributed as dist
from pytorch_distributed_tpu_torch.runtime.mesh import MeshSpec
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.runtime.prng import seed_all
from pytorch_distributed_tpu_torch.train import (
    Trainer,
    TrainerConfig,
    TrainState,
    build_train_step,
    causal_lm_loss_fn,
    fit_elastic,
)
from pytorch_distributed_tpu_torch.utils.logging import get_logger

SIZES = {"tiny": LlamaConfig.tiny, "8b": LlamaConfig.llama3_8b}
# optax.adamw's default, which the JAX recipe's adamw(lr) decays by
ADAMW_WEIGHT_DECAY = 1e-4

logger = get_logger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", choices=SIZES, default="tiny")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=8, help="global batch")
    p.add_argument("--accum-steps", type=int, default=1)
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--dp", type=int, default=-1)
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1, help="sequence-parallel ways")
    p.add_argument("--sp-mode", choices=("ring", "ulysses"), default="ring",
                   help="sequence-parallel attention under --sp")
    p.add_argument("--remat", action="store_true",
                   help="recompute block activations in the backward")
    p.add_argument("--remat-policy", choices=("full", "dots",
                   "dots_no_batch"), default="full",
                   help="what remat saves (implies --remat when not full)")
    p.add_argument("--vocab-chunk", type=int, default=None,
                   help="chunked-vocab loss: never form [B, S, V] logits")
    p.add_argument("--optimizer", choices=("adamw", "adafactor"),
                   default="adamw")
    p.add_argument("--strategy", choices=("fsdp", "dp", "zero1", "auto"),
                   default="fsdp")
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=5)
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="process-group backend (the device's own unless "
                        "given)")
    p.add_argument("--device", default=None,
                   help="the CUDA card unless given (e.g. 'cpu')")
    return p.parse_args(argv)


def _refuse_unported(args) -> None:
    if args.sp > 1 and args.strategy in ("dp", "zero1"):
        raise NotImplementedError(
            f"--sp with --strategy {args.strategy}: sequence parallelism "
            "runs under --strategy fsdp in the port (ROADMAP A10.1)")
    if args.tp > 1 and args.optimizer == "adafactor":
        raise NotImplementedError(
            "--optimizer adafactor with --tp: its factored statistics "
            "take whole rows of each leaf (ROADMAP A10.1)")
    if args.strategy == "auto":
        raise NotImplementedError(
            "--strategy auto: the cost-model planner is not ported "
            "(ROADMAP A10.6)")
    if args.optimizer == "adafactor" and args.strategy == "zero1":
        raise NotImplementedError(
            "--optimizer adafactor --strategy zero1: ZeRO-1 would split "
            "Adafactor's JAX leaves over the ranks (ROADMAP A4)")


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


def build_model(cfg: LlamaConfig, strategy, device, seed: int,
                policy: Policy):
    """``(model, net)``: the model with weights from ``seed`` and the
    module the step runs (the DDP wrapper, or under FSDP or a model axis
    the sharded model itself). Then the model is made on the meta
    device, sharded, and each rank fills its own rows."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if isinstance(strategy, FSDP) or strategy.model_parallel:
        model = LlamaForCausalLM(cfg, device="meta", policy=policy)
        strategy.wrap(model)
        model.to_empty(device=device)
        model.init_weights(gen)
        return model, model
    model = LlamaForCausalLM(cfg, device=device, policy=policy)
    model.init_weights(gen)
    return model, strategy.wrap(model)


def build_optimizer(name: str, model, strategy, lr: float):
    """The JAX recipe's optimizer: ``clip_by_global_norm(1.0)`` then
    ``adamw(lr)`` (decay 1e-4), or ``Adafactor(lr)`` alone (it clips its
    own updates by their block RMS)."""
    if name == "adafactor":
        if isinstance(strategy, FSDP):
            return strategy.optimizer(model, Adafactor, lr=lr)
        return Adafactor(model, lr=lr)
    if isinstance(strategy, (ZeRO1, FSDP)):
        optimizer = strategy.optimizer(model, AdamW, lr=lr,
                                       weight_decay=ADAMW_WEIGHT_DECAY)
    else:
        optimizer = AdamW(model, lr=lr, weight_decay=ADAMW_WEIGHT_DECAY)
    return clip_grad_norm(optimizer, 1.0)


def _train(args, device) -> Trainer:
    cfg = SIZES[args.size]()
    if args.remat or args.remat_policy != "full":
        cfg = dataclasses.replace(cfg, remat=True,
                                  remat_policy=args.remat_policy)
    seq_len = min(args.seq_len, cfg.max_seq_len)
    policy = Policy.train()
    if args.strategy == "fsdp":
        strategy = FSDP(device, MeshSpec(dp=args.dp, fsdp=args.fsdp,
                                         sp=args.sp, tp=args.tp),
                        extra_rules=llama_partition_rules())
    else:
        spec = MeshSpec(dp=args.dp, fsdp=args.fsdp, tp=args.tp)
        spec.resolve(dist.get_world_size())
        if args.fsdp != 1:
            raise SystemExit(f"--fsdp {args.fsdp} needs --strategy fsdp")
        strategy = (ZeRO1 if args.strategy == "zero1" else DataParallel)(
            device, **(dict(mesh_spec=spec,
                            extra_rules=llama_partition_rules())
                       if args.tp > 1 else {}))
    model, net = build_model(cfg, strategy, device, args.seed, policy)
    optimizer = build_optimizer(args.optimizer, model, strategy, args.lr)
    n = (args.steps_per_epoch or 50) * args.batch_size
    ds = SyntheticTextDataset(n=n, seq_len=seq_len, vocab_size=cfg.vocab_size,
                              seed=args.seed)
    trainer = Trainer(
        TrainState(net, optimizer, policy=policy),
        build_train_step(
            causal_lm_loss_fn(net, vocab_chunk_size=args.vocab_chunk),
            accum_steps=args.accum_steps),
        DataLoader(ds, args.batch_size, seed=args.seed,
                   sharding=strategy.batch_sharding()),
        config=TrainerConfig(
            epochs=args.epochs, log_every=args.log_every,
            max_steps_per_epoch=args.steps_per_epoch,
            ckpt_dir=args.ckpt_dir,
        ),
    )
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("Llama %s: %d params on %s, batch %d x seq %d, accum %d, "
                "%s over %d rank(s) (tp %d, sp %d %s), %s, remat %s, vocab "
                "chunk %s", args.size, n_params, device, args.batch_size,
                seq_len, args.accum_steps, args.strategy,
                dist.get_world_size(), args.tp, args.sp, args.sp_mode,
                args.optimizer, cfg.remat_policy if cfg.remat else "off",
                args.vocab_chunk)
    trainer.restore_checkpoint()
    sp_ctx = contextlib.nullcontext()
    if args.sp > 1:
        from pytorch_distributed_tpu_torch.parallel import sequence_parallel

        sp_ctx = sequence_parallel("sp", args.sp_mode)
    with sp_ctx:   # ring/ulysses attention while the steps run
        fit_elastic(trainer)
    logger.info("done: step=%d", trainer.state.step)
    return trainer


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
