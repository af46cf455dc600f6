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
``--strategy auto`` and ``--pp`` (ROADMAP A10) raise.
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
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from pytorch_distributed_tpu_torch.optim import AdamW, clip_grad_norm
from pytorch_distributed_tpu_torch.parallel import DataParallel, ZeRO1
from pytorch_distributed_tpu_torch.runtime import distributed as dist
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
    p.add_argument("--strategy", choices=("zero1", "dp", "single", "auto"),
                   default="zero1")
    p.add_argument("--pp", type=int, default=1, help="pipeline stages")
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
            "(ROADMAP A10)"
        )
    if args.pp > 1:
        raise NotImplementedError(
            "--pp: pipeline parallelism is not ported (ROADMAP A10)"
        )
    if args.pack and not args.text_file:
        raise SystemExit("--pack needs --text-file (documents to pack)")
    seed_all(args.seed)
    device = dist.rank_device(args.device)
    own_group = args.strategy != "single" and not dist.is_initialized()
    if own_group:
        dist.init_process_group(device=device)
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
    cfg, ds, eval_ds, tokenizer = _datasets(args, cfg, seq_len)
    policy = Policy.train()
    model = GPT2LMHead(cfg, device=device, policy=policy)
    model.init_weights(torch.Generator(device=device).manual_seed(args.seed))
    net = model
    if args.strategy == "zero1":
        strategy = ZeRO1(device)
        optimizer = strategy.optimizer(model, AdamW, lr=args.lr,
                                       weight_decay=ADAMW_WEIGHT_DECAY)
        net = strategy.wrap(model)
    else:
        optimizer = AdamW(model, lr=args.lr, weight_decay=ADAMW_WEIGHT_DECAY)
        if args.strategy == "dp":
            net = DataParallel(device).wrap(model)
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
                "%s over %d rank(s), remat %s, vocab chunk %s", args.size,
                n_params, device, args.batch_size, seq_len, args.accum_steps,
                args.strategy, dist.get_world_size(),
                cfg.remat_policy if cfg.remat else "off", args.vocab_chunk)
    trainer.restore_checkpoint()
    fit_elastic(trainer)
    logger.info("done: step=%d eval=%s", trainer.state.step,
                trainer.last_eval_metrics)
    trainer.sample = None
    if args.sample:
        trainer.sample = _sample(model, eval_ds, args, device, tokenizer)
    return trainer


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
