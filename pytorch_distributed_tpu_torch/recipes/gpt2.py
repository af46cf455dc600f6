"""GPT-2 causal-LM training: the port of ``recipes/gpt2_zero1.py``'s
ZeRO-1, data-parallel and single-device paths.

Synthetic token rows, or a local text corpus (``--text-file``: a byte
BPE tokenizer trained on it, the model's vocabulary shrunk to the
tokenizer's; ``--pack`` packs its paragraphs into rows with
segment-masked attention), ``Policy.train()`` (f32 weights and AdamW
state, bf16 products), gradient clipping at 1.0 by the global norm then
``adamw(lr)`` with optax's default weight decay of 1e-4, as the JAX
recipe chains them, microbatch accumulation with ``--accum-steps``, a
held-out eval set (seed + 1) after every epoch. Attention runs through
the flash kernels on the card. ``main`` returns the ``Trainer``, with
the corpus's tokenizer (or None) as ``trainer.tokenizer``.

    python -m pytorch_distributed_tpu_torch.recipes.gpt2 --size medium \\
        --batch-size 8 --accum-steps 2 --seq-len 1024 --steps-per-epoch 20 \\
        --remat --vocab-chunk 8192 --ckpt-dir /tmp/gpt2

``--strategy zero1`` (the default, as in the JAX recipe) is DDP with the
optimizer state sharded over the ranks (``parallel.ZeRO1``:
``ZeroRedundancyOptimizer`` over the port's AdamW, clipped by the global
norm around it); ``dp`` is plain DDP; both run one process per card
under ``torchrun``, or alone as a world of one. ``single`` is one
process without a group. ``--remat`` (``--remat-policy full | dots |
dots_no_batch``) recomputes each block in the backward, ``--vocab-chunk
C`` takes the chunked-vocab loss (``ops/lm_loss.py``) in training and
eval. ``--ckpt-dir`` checkpoints after every epoch in the format both
packages read, restores the newest intact checkpoint first, and on
SIGTERM checkpoints and exits ``EX_TEMPFAIL`` (75). ``--device cpu``
runs the plain PyTorch path on the CPU (at ``--size tiny``; gloo).
``--sample N`` ends the run by sampling N tokens after the first 8
tokens of 2 eval rows (temperature 0.8, top-k 40, the run's seed; KV-cache
decode through ``generation.generate``), logged as ids or, with
``--text-file``, as text, and kept as ``trainer.sample``.
``--backend`` is ``nccl`` or ``gloo`` (the device's own unless given),
``--dp`` the data-parallel width the world must hold (-1: every rank),
as in the JAX recipe.

``--tp M`` shards every block over M ranks as the JAX recipe's
``gpt2_partition_rules`` do (the fused qkv and the MLP's up projection
column-parallel, ``attn_out`` and the down projection row-parallel, the
token embedding on hidden; ``models/gpt2.py``), under ``--strategy
zero1`` (the moments of each TP shard split over ``dp``:
``parallel.ZeroShards``) or ``dp``, on the JAX recipe's ``dp x tp x pp``
mesh: under ``torchrun`` the world is ``dp x tp x pp``, each rank draws
its own box of the seeded weights, the ``tp`` ranks of a data share
read the same rows, and the eval and ``--sample`` run on the sharded
model.

``--pp N`` pipelines the layers over N stages, one rank each, as the
JAX recipe's GPipe form (``parallel.pipeline_lm.PipelineParallel`` with
``pipelined_causal_lm_loss_fn``): each rank allocates its stage's
layers only, the batch splits over ``--dp`` and ticks through the
stages in ``max(accum_steps, 2 * N)`` microbatches (``--accum-steps``
then counts as 1), the blocks run with dropout off, the gradients are
averaged over the data ranks and clipped by the norm over every stage,
and the eval runs through the pipelined forward; ``--sample`` gathers
the stages' layers into a whole model on every rank first. With
``--tp`` each stage's layers are TP-sharded as above. Under ``torchrun``
the world is ``dp x tp x pp``; ``--pp`` with ``--vocab-chunk`` or
``--pack`` raises, as in the JAX recipe. ``--strategy auto`` raises
(ROADMAP A10.6: the planner), and so does ``--strategy single`` with
``--tp`` above 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

import numpy as np
import torch

from pytorch_distributed_tpu_torch.data import (
    ArrayDataset,
    DataLoader,
    SyntheticTextDataset,
    TokenizedTextDataset,
    Tokenizer,
    pack_documents,
)
from pytorch_distributed_tpu_torch.generation import generate
from pytorch_distributed_tpu_torch.models.gpt2 import (
    GPT2Config,
    GPT2LMHead,
    gpt2_partition_rules,
)
from pytorch_distributed_tpu_torch.optim import AdamW, clip_grad_norm
from pytorch_distributed_tpu_torch.parallel import DataParallel, ZeRO1
from pytorch_distributed_tpu_torch.parallel.pipeline_lm import (
    PipelineParallel,
    gather_stages,
    pipelined_causal_lm_eval_step,
    pipelined_causal_lm_loss_fn,
)
from pytorch_distributed_tpu_torch.runtime import distributed as dist
from pytorch_distributed_tpu_torch.runtime.mesh import MeshSpec
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.runtime.prng import seed_all
from pytorch_distributed_tpu_torch.train import (
    Trainer,
    TrainerConfig,
    TrainState,
    build_train_step,
    causal_lm_eval_step,
    causal_lm_loss_fn,
    fit_elastic,
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
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="process-group backend (the device's own unless "
                        "given)")
    p.add_argument("--dp", type=int, default=-1,
                   help="data-parallel width (-1: every rank)")
    p.add_argument("--strategy", choices=("zero1", "dp", "single", "auto"),
                   default="zero1")
    p.add_argument("--pp", type=int, default=1, help="pipeline stages")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ways")
    p.add_argument("--remat", action="store_true",
                   help="recompute block activations in the backward")
    p.add_argument("--remat-policy", choices=("full", "dots",
                   "dots_no_batch"), default="full",
                   help="what remat saves (implies --remat when not full)")
    p.add_argument("--pack", action="store_true",
                   help="pack paragraph documents into rows with "
                        "segment-masked attention (needs --text-file)")
    p.add_argument("--vocab-chunk", type=int, default=None,
                   help="chunked-vocab loss: never form [B, S, V] logits")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--sample", type=int, default=0, metavar="N",
                   help="sample N tokens after 8-token prompts of 2 eval "
                        "rows at the end")
    p.add_argument("--text-file", default=None,
                   help="train on this local text corpus (byte BPE)")
    return p.parse_args(argv)


def main(argv=None) -> Trainer:
    args = parse_args(argv)
    if args.strategy == "auto":
        raise NotImplementedError(
            "--strategy auto: the cost-model planner is not ported "
            "(ROADMAP A10.6)"
        )
    if args.pp > 1 and args.vocab_chunk is not None:
        raise SystemExit(
            "--vocab-chunk is not supported with --pp > 1: the pipelined "
            "loss builds its own head projection; drop one of the flags")
    if args.pp > 1 and args.pack:
        raise SystemExit(
            "--pack is not combinable with --pp (the pipelined loss "
            "refuses packed batches)")
    if args.tp > 1 and args.strategy == "single":
        raise SystemExit("--tp needs a process group: --strategy zero1 or "
                         "dp")
    if args.pack and not args.text_file:
        raise SystemExit("--pack needs --text-file (documents to pack)")
    seed_all(args.seed)
    device = dist.rank_device(args.device)
    own_group = args.strategy != "single" and not dist.is_initialized()
    if own_group:
        dist.init_process_group(args.backend, device=device)
    try:
        return _train(args, device)
    finally:
        if own_group:
            dist.destroy_process_group()


def _datasets(args, cfg, seq_len):
    """(config, train set, eval set, tokenizer): the synthetic stream (no
    tokenizer), or the corpus's windows or packed paragraphs, whose BPE
    tokenizer also sets the vocab."""
    if not args.text_file:
        n = (args.steps_per_epoch or 100) * args.batch_size
        ds = SyntheticTextDataset(n=n, seq_len=seq_len,
                                  vocab_size=cfg.vocab_size, seed=args.seed)
        eval_ds = SyntheticTextDataset(
            n=max(args.batch_size, 64), seq_len=seq_len,
            vocab_size=cfg.vocab_size, seed=args.seed + 1)   # held out
        return cfg, ds, eval_ds, None
    with open(args.text_file, encoding="utf-8") as f:
        corpus = f.read()
    tokenizer = Tokenizer.train(corpus, vocab_size=min(cfg.vocab_size, 8192))
    cfg = dataclasses.replace(cfg, vocab_size=tokenizer.vocab_size)
    if args.pack:
        docs = [tokenizer.encode(p) for p in corpus.split("\n\n")
                if p.strip()]
        packed = pack_documents(docs, seq_len)
        if args.steps_per_epoch:
            keep = args.steps_per_epoch * args.batch_size
            packed = {k: v[:keep] for k, v in packed.items()}
        rows = packed["input_ids"].shape[0]
        if rows < args.batch_size:
            raise SystemExit(
                f"corpus packs into only {rows} row(s) of {seq_len}, fewer "
                f"than --batch-size {args.batch_size}: the drop-last loader "
                "would train zero steps")
        ds = ArrayDataset(**packed)
        logger.info("packed corpus: %d documents into %d rows of %d "
                    "(vocab %d)", len(docs), rows, seq_len,
                    tokenizer.vocab_size)
    else:
        ds = TokenizedTextDataset(
            corpus, tokenizer, seq_len, stride=seq_len // 2,
            max_windows=(args.steps_per_epoch * args.batch_size
                         if args.steps_per_epoch else None))
        logger.info("text corpus: %d tokens, vocab %d, %d windows",
                    ds.num_tokens, tokenizer.vocab_size, len(ds))
    # the JAX recipe's choice: eval on the training distribution
    return cfg, ds, ds, tokenizer


def _train(args, device) -> Trainer:
    cfg = SIZES[args.size]()
    if args.remat or args.remat_policy != "full":
        cfg = dataclasses.replace(cfg, remat=True,
                                  remat_policy=args.remat_policy)
    seq_len = min(args.seq_len, cfg.n_positions)
    # the JAX recipe's mesh: dp x tp x pp
    mesh_spec = MeshSpec(dp=args.dp, tp=args.tp, pp=args.pp)
    mesh_spec.resolve(dist.get_world_size() if dist.is_initialized() else 1)
    cfg, ds, eval_ds, tokenizer = _datasets(args, cfg, seq_len)
    policy = Policy.train()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.pp > 1:
        return _train_pipelined(args, device, cfg, mesh_spec, policy, gen,
                                ds, eval_ds, tokenizer, seq_len)
    model, net, optimizer = _build(args, device, cfg, mesh_spec, policy,
                                   gen)
    optimizer = clip_grad_norm(optimizer, 1.0)
    trainer = Trainer(
        TrainState(net, optimizer, policy=policy),
        build_train_step(
            causal_lm_loss_fn(net, vocab_chunk_size=args.vocab_chunk),
            accum_steps=args.accum_steps),
        DataLoader(ds, args.batch_size, seed=args.seed, sharding=device),
        eval_step=causal_lm_eval_step(model,
                                      vocab_chunk_size=args.vocab_chunk),
        eval_loader=DataLoader(eval_ds, args.batch_size, shuffle=False,
                               sharding=device),
        config=TrainerConfig(
            epochs=args.epochs, log_every=args.log_every,
            max_steps_per_epoch=args.steps_per_epoch,
            ckpt_dir=args.ckpt_dir,
        ),
    )
    trainer.tokenizer = tokenizer   # the corpus's BPE, or None
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("GPT-2 %s: %d params on %s, batch %d x seq %d, accum %d, "
                "%s over %d rank(s) (tp %d), remat %s, vocab chunk %s",
                args.size, n_params, device, args.batch_size, seq_len,
                args.accum_steps, args.strategy, dist.get_world_size(),
                args.tp, cfg.remat_policy if cfg.remat else "off",
                args.vocab_chunk)
    return _fit_and_sample(trainer, model, eval_ds, args, device, tokenizer)


def _build(args, device, cfg, mesh_spec, policy, gen):
    """``(model, net, optimizer)``: the seeded model, the module the
    step runs (DDP's wrapper, or the TP-sharded model itself) and the
    optimizer of ``--strategy``."""
    kw = dict(lr=args.lr, weight_decay=ADAMW_WEIGHT_DECAY)
    if args.tp > 1:
        # each rank allocates and draws its own box of the weights
        strategy = (ZeRO1 if args.strategy == "zero1" else DataParallel)(
            device, mesh_spec=mesh_spec, extra_rules=gpt2_partition_rules())
        model = strategy.wrap(GPT2LMHead(cfg, device="meta", policy=policy))
        model.to_empty(device=device)
        model.init_weights(gen)
        optimizer = (strategy.optimizer(model, AdamW, **kw)
                     if args.strategy == "zero1" else AdamW(model, **kw))
        return model, model, optimizer
    model = GPT2LMHead(cfg, device=device, policy=policy)
    model.init_weights(gen)
    if args.strategy == "zero1":
        strategy = ZeRO1(device)
        optimizer = strategy.optimizer(model, AdamW, **kw)
        return model, strategy.wrap(model), optimizer
    optimizer = AdamW(model, **kw)
    if args.strategy == "dp":
        return model, DataParallel(device).wrap(model), optimizer
    return model, model, optimizer


def _fit_and_sample(trainer, model, eval_ds, args, device, tokenizer):
    """Restore, fit, then ``--sample`` on ``model`` (a pipeline stage's
    layers gathered into a whole model first)."""
    trainer.restore_checkpoint()
    fit_elastic(trainer)
    logger.info("done: step=%d eval=%s", trainer.state.step,
                trainer.last_eval_metrics)
    trainer.sample = None
    if args.sample:
        trainer.sample = _sample(gather_stages(model), eval_ds, args, device,
                                 tokenizer)
    return trainer


def _train_pipelined(args, device, cfg, mesh_spec, policy, gen, ds, eval_ds,
                     tokenizer, seq_len) -> Trainer:
    """``--pp N``: the JAX recipe's GPipe form (module docstring)."""
    strategy = PipelineParallel(device, mesh_spec=mesh_spec,
                                extra_rules=gpt2_partition_rules())
    model = strategy.wrap(GPT2LMHead(cfg, device="meta", policy=policy))
    model.init_weights(gen)
    micro = max(args.accum_steps, 2 * args.pp)
    optimizer = clip_grad_norm(
        AdamW(model, lr=args.lr, weight_decay=ADAMW_WEIGHT_DECAY), 1.0)
    trainer = Trainer(
        TrainState(model, optimizer, policy=policy),
        # the microbatches tick through the pipeline: accum_steps is 1
        build_train_step(pipelined_causal_lm_loss_fn(
            model, num_microbatches=micro)),
        DataLoader(ds, args.batch_size, seed=args.seed,
                   sharding=strategy.batch_sharding()),
        eval_step=pipelined_causal_lm_eval_step(model,
                                                num_microbatches=micro),
        eval_loader=DataLoader(eval_ds, args.batch_size, shuffle=False,
                               sharding=strategy.batch_sharding()),
        config=TrainerConfig(
            epochs=args.epochs, log_every=args.log_every,
            max_steps_per_epoch=args.steps_per_epoch,
            ckpt_dir=args.ckpt_dir,
        ),
    )
    trainer.tokenizer = tokenizer
    layout = model.pipeline_stage
    logger.info("GPT-2 %s: stage %d of %d (layers %d-%d, %d params) on %s, "
                "batch %d x seq %d in %d microbatches, dp %d", args.size,
                layout.stage, layout.num_stages, layout.start,
                layout.stop - 1, sum(p.numel() for p in model.parameters()),
                device, args.batch_size, seq_len, micro, strategy.spec.dp)
    return _fit_and_sample(trainer, model, eval_ds, args, device, tokenizer)


def _sample(model, eval_ds, args, device, tokenizer) -> torch.Tensor:
    """The JAX recipe's closing sample: the first 8 tokens of 2 eval rows,
    ``args.sample`` new tokens at temperature 0.8 and top-k 40 from a
    generator seeded with the run's seed. Returns ``[2, 8 + N]`` ids."""
    prompt = torch.as_tensor(np.stack(
        [np.asarray(eval_ds[i]["input_ids"]) for i in range(2)])[:, :8])
    out = generate(
        model, prompt.to(device), max_new_tokens=args.sample,
        temperature=0.8, top_k=40,
        generator=torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    if tokenizer is not None:
        logger.info("sample: %r", tokenizer.decode(out[0].cpu().numpy()))
    else:
        logger.info("sampled continuation ids: %s", out[0].tolist())
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
