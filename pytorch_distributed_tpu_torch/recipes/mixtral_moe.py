"""Mixtral, the sparse mixture-of-experts LM, on a successor task: the
port of ``recipes/mixtral_moe.py``.

A Mixtral (``--size tiny``, the JAX recipe's, or ``8x7b`` at its
published widths, ``--layers`` cutting the depth) learns the
deterministic chain ``next = (5 * tok + 7) mod vocab``: every next token
is exactly predictable from the current one, so the closing greedy
continuation is a real measurement (exact match), not a smoke print.
The router's Switch load-balance loss rides the task loss
(``causal_lm_loss_fn(moe_aux_weight=--aux-weight)``); ``--capacity-factor``
is the training dispatch's per-expert queue (0: drop-free). The state is
``Policy.train()`` (f32 weights and AdamW state, bf16 products),
``clip_by_global_norm(1.0)`` then ``adamw(--lr)`` with optax's default
decay of 1e-4, as the JAX recipe chains them.

    python -m pytorch_distributed_tpu_torch.recipes.mixtral_moe \\
        --device cpu --epochs 2 --steps-per-epoch 5          # smoke
    torchrun --nproc-per-node 4 -m \\
        pytorch_distributed_tpu_torch.recipes.mixtral_moe --ep 4  # EP mesh
    torchrun --nproc-per-node 4 -m ... --dp 2 --ep 2

The mesh is ``MeshSpec(dp=--dp, ep=--ep, tp=--tp)`` under
``DataParallel(extra_rules=mixtral_partition_rules())``: the experts of
every layer split over ``ep`` (their hidden dim over ``tp``, attention
Megatron-style over ``tp``), the rest replicated, the batch split over
``dp`` with the routing's queues over the whole batch, the gradients
reduced over ``dp`` only. Above world 1 on a model-parallel mesh the
model is built on the meta device and each rank draws its own box of the
seeded weights. The closing evaluation serves drop-free
(``capacity_factor=None`` on the same weights): the bounded-capacity
dispatch could drop a row's tokens depending on which rows share the
batch; under ``--tp`` it decodes on the sharded model, each rank's
cache holding its own kv heads. ``--eval-rows 0`` skips it. ``--ckpt-dir`` checkpoints after every
epoch in the format both packages read and resumes; ``--remat`` and
``--vocab-chunk`` are the Llama recipe's. ``--device cpu`` runs on the
CPU (gloo).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

import numpy as np
import torch

from pytorch_distributed_tpu_torch.data import ArrayDataset, DataLoader
from pytorch_distributed_tpu_torch.generation import generate
from pytorch_distributed_tpu_torch.models.mixtral import (
    MixtralConfig,
    MixtralForCausalLM,
    mixtral_partition_rules,
)
from pytorch_distributed_tpu_torch.ops.moe import MoEMLP
from pytorch_distributed_tpu_torch.optim import AdamW, clip_grad_norm
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
    causal_lm_loss_fn,
    fit_elastic,
)
from pytorch_distributed_tpu_torch.utils.logging import get_logger

SIZES = {"tiny": MixtralConfig.tiny, "8x7b": MixtralConfig.mixtral_8x7b}
# optax.adamw's default, which the JAX recipe's adamw(lr) decays by
ADAMW_WEIGHT_DECAY = 1e-4
# the chain's step: coprime with the default vocab of 64 (a full wander)
A_MULT, B_ADD = 5, 7

logger = get_logger(__name__)


def successor_chain(tok, steps, a, b, vocab):
    out = [tok]
    for _ in range(steps):
        out.append((out[-1] * a + b) % vocab)
    return np.stack(out, axis=-1)


def make_task(n, seq_len, vocab, a, b, seed) -> ArrayDataset:
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab, size=(n,)).astype(np.int64)
    ids = successor_chain(start, seq_len - 1, a, b, vocab)
    return ArrayDataset(input_ids=ids.astype(np.int32))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", choices=SIZES, default="tiny")
    p.add_argument("--layers", type=int, default=None,
                   help="cut the size's depth to this many layers")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    p.add_argument("--device", default=None,
                   help="the CUDA card unless given (e.g. 'cpu')")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=32, help="global batch")
    p.add_argument("--seq-len", type=int, default=16)
    p.add_argument("--vocab", type=int, default=64,
                   help="successor-task vocab (the model's table follows)")
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--aux-weight", type=float, default=0.01)
    p.add_argument("--capacity-factor", type=float, default=1.25,
                   help="Switch bounded-capacity training dispatch; 0 for "
                        "the drop-free (serving, parity) mode")
    p.add_argument("--dp", type=int, default=-1)
    p.add_argument("--ep", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--remat", action="store_true",
                   help="recompute block activations in the backward")
    p.add_argument("--vocab-chunk", type=int, default=None,
                   help="chunked-vocab loss: never form [B, S, V] logits")
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--eval-rows", type=int, default=32)
    return p.parse_args(argv)


def main(argv=None) -> Trainer:
    """Train, then score the greedy continuation; returns the ``Trainer``
    (``trainer.successor`` holds the exact- and token-match rates)."""
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


def config_for(args) -> MixtralConfig:
    cfg = SIZES[args.size]()
    return dataclasses.replace(
        cfg, vocab_size=args.vocab,
        num_layers=args.layers or cfg.num_layers,
        max_seq_len=max(args.seq_len * 2, 32),
        capacity_factor=args.capacity_factor or None, remat=args.remat)


def build_model(cfg: MixtralConfig, strategy: DataParallel, device,
                seed: int, policy: Policy):
    """``(model, net)``: the model with weights from ``seed`` and the
    module the step runs (DDP's wrapper, or on a model-parallel mesh the
    sharded model itself, built on the meta device so that each rank
    draws its own box)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if strategy.model_parallel:
        model = MixtralForCausalLM(cfg, device="meta", policy=policy)
        strategy.wrap(model)
        model.to_empty(device=device)
        model.init_weights(gen)
        return model, model
    model = MixtralForCausalLM(cfg, device=device, policy=policy)
    model.init_weights(gen)
    return model, strategy.wrap(model)


@torch.no_grad()
def successor_eval(model, cfg: MixtralConfig, rows: int, seq_len: int,
                   seed: int, device):
    """Greedy continuations of fresh 2-token starts, drop-free, scored
    against the true chain: ``(exact-match rate, token-match rate)``."""
    moes = [m for m in model.modules() if isinstance(m, MoEMLP)]
    saved = [m.capacity_factor for m in moes]
    rng = np.random.default_rng(seed + 1)
    start = rng.integers(0, cfg.vocab_size, size=(rows,)).astype(np.int64)
    prompt_len, new = 2, seq_len - 2
    chain = successor_chain(start, prompt_len + new - 1, A_MULT, B_ADD,
                            cfg.vocab_size)
    prompt = torch.from_numpy(chain[:, :prompt_len])
    try:
        for m in moes:
            m.capacity_factor = None
        out = generate(model, prompt, max_new_tokens=new, temperature=0.0,
                       device=device).cpu().numpy()
    finally:
        for m, cf in zip(moes, saved):
            m.capacity_factor = cf
    want = chain[:, :prompt_len + new]
    exact = float((out == want).all(axis=1).mean())
    tok = float((out[:, prompt_len:] == want[:, prompt_len:]).mean())
    return exact, tok


def _train(args, device) -> Trainer:
    cfg = config_for(args)
    policy = Policy.train()
    strategy = DataParallel(
        device, mesh_spec=MeshSpec(dp=args.dp, ep=args.ep, tp=args.tp),
        extra_rules=mixtral_partition_rules())
    model, net = build_model(cfg, strategy, device, args.seed, policy)
    optimizer = clip_grad_norm(
        AdamW(model, lr=args.lr, weight_decay=ADAMW_WEIGHT_DECAY), 1.0)
    n = (args.steps_per_epoch or 50) * args.batch_size
    ds = make_task(n, args.seq_len, cfg.vocab_size, A_MULT, B_ADD, args.seed)
    trainer = Trainer(
        TrainState(net, optimizer, policy=policy),
        build_train_step(causal_lm_loss_fn(
            net, moe_aux_weight=args.aux_weight,
            vocab_chunk_size=args.vocab_chunk)),
        DataLoader(ds, args.batch_size, seed=args.seed,
                   sharding=strategy.batch_sharding()),
        config=TrainerConfig(
            epochs=args.epochs, log_every=args.log_every,
            max_steps_per_epoch=args.steps_per_epoch,
            ckpt_dir=args.ckpt_dir, samples_axis="input_ids"),
    )
    if dist.get_rank() == 0:
        logger.info("mixtral %s: %d layers, %d experts top-%d, capacity %s, "
                    "world %d (dp %d ep %d tp %d) on %s, batch %d x %d",
                    args.size, cfg.num_layers, cfg.num_experts, cfg.top_k,
                    cfg.capacity_factor, dist.get_world_size(),
                    strategy.spec.dp, args.ep, args.tp, device,
                    args.batch_size, args.seq_len)
    trainer.restore_checkpoint()
    fit_elastic(trainer)
    trainer.successor = None
    if args.eval_rows:
        exact, tok = successor_eval(model, cfg, args.eval_rows, args.seq_len,
                                    args.seed, device)
        trainer.successor = dict(exact_match=exact, token_match=tok)
        if dist.get_rank() == 0:
            logger.info("successor exact-match %.3f  token-match %.3f over "
                        "%d rows", exact, tok, args.eval_rows)
    return trainer


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
