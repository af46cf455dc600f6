"""Rank processes for tests/test_torch_mixtral.py (spawned by
``torch_dp_workers.spawn``; this module imports no JAX): tiny Mixtral
trajectories under ``DataParallel`` on meshes with an ``ep`` axis.
"""

from __future__ import annotations

import numpy as np
import torch

from tests.torch_dp_workers import _join, _run

AUX_WEIGHT, LR = 0.01, 1e-4


def _model_and_rules(cfg):
    """The model class and partition rules of ``cfg``: Mixtral's, or
    GPT-2's with ``moe_experts``."""
    from pytorch_distributed_tpu_torch.models.gpt2 import (
        GPT2Config,
        GPT2LMHead,
        gpt2_partition_rules,
    )
    from pytorch_distributed_tpu_torch.models.mixtral import (
        MixtralForCausalLM,
        mixtral_partition_rules,
    )

    if isinstance(cfg, GPT2Config):
        return GPT2LMHead, gpt2_partition_rules()
    return MixtralForCausalLM, mixtral_partition_rules()


def run_case(spec, cfg, state_dict, batches, device="cpu"):
    """Three clip + AdamW steps of a Mixtral (or a GPT-2 with experts) of
    ``cfg`` (f32) with the whole weights ``state_dict`` under
    ``DataParallel`` on ``MeshSpec(**spec)``; ``{"losses", "aux",
    "params"}`` (the params gathered whole, on every rank)."""
    from pytorch_distributed_tpu_torch.optim import AdamW, clip_grad_norm
    from pytorch_distributed_tpu_torch.parallel import DataParallel
    from pytorch_distributed_tpu_torch.runtime.mesh import MeshSpec
    from pytorch_distributed_tpu_torch.runtime.precision import Policy
    from pytorch_distributed_tpu_torch.train import (
        TrainState,
        build_train_step,
        causal_lm_loss_fn,
    )
    from tests.torch_tp_workers import load_full

    policy = Policy.full()
    model_cls, rules = _model_and_rules(cfg)
    strategy = DataParallel(device, mesh_spec=MeshSpec(**spec),
                            extra_rules=rules)
    if strategy.model_parallel:
        model = model_cls(cfg, device="meta", policy=policy)
        net = strategy.wrap(model)
        model.to_empty(device=device)
        load_full(model, {k: torch.from_numpy(v)
                          for k, v in state_dict.items()})
    else:
        model = model_cls(cfg, device=device, policy=policy)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state_dict.items()})
        net = strategy.wrap(model)
    opt = clip_grad_norm(AdamW(model, lr=LR, weight_decay=1e-4), 1.0)
    state = TrainState(net, opt, policy=policy)
    step = build_train_step(causal_lm_loss_fn(net,
                                              moe_aux_weight=AUX_WEIGHT))
    losses, aux = [], []
    for batch in batches:
        state, metrics = step(state, strategy.shard_batch(batch))
        for key, out in (("loss", losses), ("moe_aux_loss", aux)):
            v = metrics[key].detach().clone().reshape(1)
            torch.distributed.all_reduce(v)
            out.append(float(v) / torch.distributed.get_world_size())
    params = {}
    for name, p in model.named_parameters():
        full = p.full_tensor() if hasattr(p, "full_tensor") else p
        params[name] = full.detach().numpy().copy()
    return {"losses": losses, "aux": aux, "params": params,
            # the tensors this rank holds a part of
            "cut": sorted(n for n, p in model.named_parameters()
                          if hasattr(p, "to_local")
                          and tuple(p.to_local().shape) != tuple(p.shape))}


def mixtral_world(rank, world, port, cases, out):
    """Every case of ``cases`` (``{name: (spec, cfg, state_dict,
    batches)}``) in turn on this gloo world; rank 0's results (the
    losses are the world's mean, the params whole on every rank)."""

    def body():
        _join(rank, world, port)
        res = {name: run_case(*case) for name, case in cases.items()}
        return res if rank == 0 else {}

    _run(rank, out, body)


def batches(vocab: int, n: int = 3, rows: int = 4, seq: int = 16,
            seed: int = 0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (rows, seq)).astype(
        np.int64)} for _ in range(n)]


def mixtral_ckpt(rank, world, port, spec, cfg, state_dict, batch, ckpt_dir,
                 out):
    """One clip + AdamW step on ``MeshSpec(**spec)`` and a checkpoint in
    ``ckpt_dir`` (each rank writing its boxes of the expert tensors);
    rank 0 returns every parameter and AdamW moment whole."""

    def body():
        _join(rank, world, port)
        from pytorch_distributed_tpu_torch.models.mixtral import (
            MixtralForCausalLM,
            mixtral_partition_rules,
        )
        from pytorch_distributed_tpu_torch.optim import AdamW
        from pytorch_distributed_tpu_torch.parallel import DataParallel
        from pytorch_distributed_tpu_torch.runtime.mesh import MeshSpec
        from pytorch_distributed_tpu_torch.runtime.precision import Policy
        from pytorch_distributed_tpu_torch.train import (
            TrainState,
            build_train_step,
            causal_lm_loss_fn,
            save_checkpoint,
        )
        from tests.torch_tp_workers import load_full

        strategy = DataParallel("cpu", mesh_spec=MeshSpec(**spec),
                                extra_rules=mixtral_partition_rules())
        model = MixtralForCausalLM(cfg, device="meta", policy=Policy.full())
        strategy.wrap(model)
        model.to_empty(device="cpu")
        load_full(model, {k: torch.from_numpy(v)
                          for k, v in state_dict.items()})
        opt = AdamW(model, lr=LR, weight_decay=1e-4)
        state = TrainState(model, opt, policy=Policy.full())
        step = build_train_step(causal_lm_loss_fn(
            model, moe_aux_weight=AUX_WEIGHT))
        state, _ = step(state, strategy.shard_batch(batch))
        save_checkpoint(ckpt_dir, state)
        whole = {}
        for name, p in model.named_parameters():
            whole[name] = p.full_tensor().detach().numpy().copy()
            for key, v in opt.state[p].items():
                if torch.is_tensor(v) and v.dim():
                    whole[f"{name}.{key}"] = v.full_tensor().numpy().copy()
        return whole if rank == 0 else {}

    _run(rank, out, body)
