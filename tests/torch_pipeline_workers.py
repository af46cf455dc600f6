"""Rank processes for the port's pipeline tests
(``tests/test_torch_pipeline*.py``; spawned by ``torch_dp_workers.spawn``,
this module imports no JAX). Each world runs a list of cases in turn:
``world(rank, world, port, cases, out)`` with ``cases`` a list of
``(name, function name, args)``; every rank returns ``{name: result}``.

The cases take whole GPT-2 state_dicts (numpy, the port's names) and
return tensors under the whole model's names (a stage's ``blocks.{i}``
renamed to its layers' global indices), so the tests compare them with
the JAX package's leaves through ``interop``.
"""

from __future__ import annotations

import time
import zlib

import numpy as np
import torch

from tests.torch_dp_workers import RANK_THREADS, _run


def world(rank, world_size, port, cases, out):
    """Every case of ``cases`` in turn on this gloo world. The ranks meet
    at a file store named after the spawning process and ``port`` (a
    port a concurrent test might take between its choice and rank 0's
    bind is no rendezvous of theirs)."""
    import os
    import tempfile

    from pytorch_distributed_tpu_torch.runtime import distributed as dist

    def body():
        torch.set_num_threads(RANK_THREADS)
        path = os.path.join(tempfile.gettempdir(),
                            f"ptd_pipeline_{os.getppid()}_{port}")
        dist.init_process_group("gloo", init_method=f"file://{path}",
                                world_size=world_size, rank=rank,
                                device="cpu", timeout_s=300.0)
        return {name: globals()[fn](*args) for name, fn, args in cases}

    _run(rank, out, body)


def gpt2_cfg(**kw):
    from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config

    base = dict(vocab_size=128, n_positions=32, hidden_size=32,
                num_layers=4, num_heads=2, dropout_rate=0.0)
    base.update(kw)
    return GPT2Config(**base)


def make_batches(steps, batch, seq, vocab, seed):
    """The JAX pipeline tests' synthetic stream (``pipeline_workers``)."""
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (batch, seq)).astype(
        np.int32)} for _ in range(steps)]


def _global(name: str, start: int) -> str:
    """A stage's parameter name under the whole model's layer index."""
    if not name.startswith("blocks."):
        return name
    i, sub = name[len("blocks."):].split(".", 1)
    return f"blocks.{start + int(i)}.{sub}"


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def stage_model(cfg, spec, sd=None, seed=None):
    """A ``GPT2LMHead`` stage of ``PipelineParallel`` on ``MeshSpec(**spec)``
    (f32), built on the meta device: its weights from the whole
    state_dict ``sd`` or drawn from ``seed``."""
    from pytorch_distributed_tpu_torch.models.gpt2 import GPT2LMHead
    from pytorch_distributed_tpu_torch.parallel.pipeline_lm import (
        PipelineParallel,
    )
    from pytorch_distributed_tpu_torch.runtime.mesh import MeshSpec
    from pytorch_distributed_tpu_torch.runtime.precision import Policy

    strategy = PipelineParallel("cpu", mesh_spec=MeshSpec(**spec))
    model = strategy.wrap(GPT2LMHead(cfg, device="meta",
                                     policy=Policy.full()))
    if sd is not None:
        start = model.pipeline_stage.start
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(torch.from_numpy(sd[_global(name, start)]))
    else:
        model.init_weights(torch.Generator().manual_seed(seed))
    return strategy, model


def named(model, tensors=None):
    """``{whole-model name: numpy}`` of a stage's parameters (or of
    ``tensors``, one per parameter, in order)."""
    start = model.pipeline_stage.start
    items = list(model.named_parameters())
    if tensors is None:
        tensors = [p for _, p in items]
    return {_global(n, start): _numpy(t) for (n, _), t in zip(items, tensors)}


# -- parallel/pipeline.py ------------------------------------------------------


def forward_grads(stacked, xs, spec):
    """``pipeline_forward`` of a tanh-dense stage over the ``pp`` group of
    ``MeshSpec(**spec)``, and the gradients of ``sum(y ** 2)``: this
    stage's rows and the microbatches'."""
    from pytorch_distributed_tpu_torch.parallel.pipeline import (
        pipeline_forward,
    )
    from pytorch_distributed_tpu_torch.parallel.sequence import axis_group
    from pytorch_distributed_tpu_torch.runtime.mesh import MeshSpec, make_mesh

    group, _, stage = axis_group("pp", make_mesh(MeshSpec(**spec), "cpu"))
    params = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in stacked.items()}
    x = torch.from_numpy(xs).requires_grad_(True)

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    y = pipeline_forward(stage_fn, params, x, group=group)
    (y ** 2).sum().backward()
    return {"y": _numpy(y), "xs": _numpy(x.grad), "stage": stage,
            **{k: _numpy(p.grad[stage]) for k, p in params.items()},
            "other_rows": float(sum(p.grad.abs().sum() - p.grad[stage].abs()
                                    .sum() for p in params.values()))}


# -- parallel/pipeline_lm.py: the GPipe form -----------------------------------


def lm_grads(cfg_kw, spec, sd, ids, M):
    """Logits, the pipelined loss and every gradient of a stage of
    ``PipelineParallel`` on ``MeshSpec(**spec)``, and the blocks it
    allocated."""
    from pytorch_distributed_tpu_torch.parallel.pipeline_lm import (
        gpt2_pipeline_logits,
        pipelined_causal_lm_loss_fn,
    )

    cfg = gpt2_cfg(**cfg_kw)
    _, model = stage_model(cfg, spec, sd)
    ids = torch.from_numpy(ids)
    with torch.no_grad():
        logits = gpt2_pipeline_logits(model, ids, num_microbatches=M)
    loss, _ = pipelined_causal_lm_loss_fn(model, num_microbatches=M)(
        {"input_ids": ids}, None)
    loss.backward()
    return {"logits": _numpy(logits), "loss": float(loss.detach()),
            "grads": named(model, [p.grad for p in model.parameters()]),
            "blocks": len(model.blocks),
            "layers": model.pipeline_stage.layers}


def refusals(cfg_kw, spec):
    """The errors of a pipeline whose layers do not divide over the
    stages (the strategy's and the forward's, on a whole model), and of
    the data-parallel strategies on a mesh with ``pp``."""
    from pytorch_distributed_tpu_torch.models.gpt2 import GPT2LMHead
    from pytorch_distributed_tpu_torch.parallel.pipeline_lm import (
        PipelineParallel,
        gpt2_pipeline_logits,
    )
    from pytorch_distributed_tpu_torch.runtime.mesh import MeshSpec
    from pytorch_distributed_tpu_torch.runtime.precision import Policy

    cfg = gpt2_cfg(**cfg_kw)
    errors = {}
    strategy = PipelineParallel("cpu", mesh_spec=MeshSpec(**spec))
    try:
        strategy.wrap(GPT2LMHead(cfg, device="meta", policy=Policy.full()))
    except ValueError as e:
        errors["wrap"] = str(e)
    whole = GPT2LMHead(cfg, device="cpu", policy=Policy.full())
    try:
        gpt2_pipeline_logits(whole, torch.zeros(2, 8, dtype=torch.long),
                             num_microbatches=2, group=strategy.group)
    except ValueError as e:
        errors["logits"] = str(e)
    # the data-parallel strategies refuse a pp axis
    from pytorch_distributed_tpu_torch.parallel import FSDP, DataParallel

    for name, cls in (("dp", DataParallel), ("fsdp", FSDP)):
        try:
            cls("cpu", mesh_spec=MeshSpec(**spec))
        except ValueError as e:
            errors[name] = str(e)
    return errors


def recipe(argv, cfg_kw=None):
    """The port's GPT-2 recipe (``main``) on this world, at a config of
    its own (``--size pp-test``) with ``cfg_kw``: the logged losses, the
    eval and the closing sample."""
    from pytorch_distributed_tpu_torch.recipes import gpt2 as gpt2_recipe

    if cfg_kw is not None:
        gpt2_recipe.SIZES["pp-test"] = lambda: gpt2_cfg(**cfg_kw)
        argv = ["--size", "pp-test"] + list(argv)
    trainer = gpt2_recipe.main(list(argv))
    return {"losses": [r["loss"] for r in trainer.history],
            "eval": trainer.last_eval_metrics,
            "step": trainer.state.step,
            "sample": (None if trainer.sample is None
                       else trainer.sample.tolist())}


def _snapshot(model, opt):
    """Parameters, AdamW moments and counts under whole-model names."""
    out = {"step_count": sorted({int(s["step"]) for s in opt.state.values()
                                 if "step" in s})}
    out.update(named(model))
    for key in ("exp_avg", "exp_avg_sq"):
        out.update({f"{key}:{n}": v for n, v in named(
            model, [opt.state[p][key] for p in model.parameters()]).items()})
    return out


def ckpt_round_trip(cfg_kw, spec, ckpt_in, ckpt_out, batch, M):
    """Under ``PipelineParallel``: restore ``ckpt_in`` (a world-1
    checkpoint) into a stage of other weights, snapshot it, take one
    clip + AdamW step and save ``ckpt_out``; both snapshots."""
    from pytorch_distributed_tpu_torch import optim
    from pytorch_distributed_tpu_torch.parallel.pipeline_lm import (
        pipelined_causal_lm_loss_fn,
    )
    from pytorch_distributed_tpu_torch.runtime.precision import Policy
    from pytorch_distributed_tpu_torch.train import (
        TrainState,
        build_train_step,
        restore_checkpoint,
        save_checkpoint,
    )

    cfg = gpt2_cfg(**cfg_kw)
    strategy, model = stage_model(cfg, spec, seed=99)
    inner = optim.AdamW(model, lr=1e-3, weight_decay=1e-4)
    state = TrainState(model, optim.clip_grad_norm(inner, 1.0),
                       policy=Policy.full())
    restore_checkpoint(ckpt_in, state)
    restored = dict(_snapshot(model, inner), step=state.step)
    step = build_train_step(pipelined_causal_lm_loss_fn(
        model, num_microbatches=M))
    state, _ = step(state, strategy.shard_batch(batch))
    save_checkpoint(ckpt_out, state)
    return {"restored": restored,
            "saved": dict(_snapshot(model, inner), step=state.step)}


# -- parallel/pipeline_schedule.py: the host executor ---------------------------


def host_run(opts, sd):
    """One stage (rank == stage) of a host pipeline over the world (solo
    at world 1) on the whole GPT-2 weights ``sd``: SGD steps over
    ``make_batches``; the last stage's losses and the stage's final
    parameters. ``opts``: layers, steps, batch, seq, microbatches,
    seed, lr, schedule, depths, delay_s, debug, trace."""
    from pytorch_distributed_tpu_torch import optim
    from pytorch_distributed_tpu_torch.models.gpt2 import GPT2LMHead
    from pytorch_distributed_tpu_torch.parallel.pipeline_lm import (
        GPT2HostStagePrograms,
        host_act_template,
        host_stage_params,
    )
    from pytorch_distributed_tpu_torch.parallel.pipeline_schedule import (
        HostPipelineStep,
    )
    from pytorch_distributed_tpu_torch.runtime import distributed as dist
    from pytorch_distributed_tpu_torch.runtime import tracing
    from pytorch_distributed_tpu_torch.runtime.precision import Policy

    rank, size = dist.get_rank(), dist.get_world_size()
    cfg = gpt2_cfg(num_layers=opts["layers"], vocab_size=opts["vocab"],
                   hidden_size=opts["hidden"],
                   n_positions=opts["n_positions"])
    model = GPT2LMHead(cfg, device="cpu", policy=Policy.full())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    module, buffers = host_stage_params(model, stage=rank, num_stages=size,
                                        depths=opts.get("depths"))
    programs = GPT2HostStagePrograms(module, stage=rank, num_stages=size)
    link = (dist.StageLink(debug=opts.get("debug", False)) if size > 1
            else None)
    M = opts["microbatches"]
    host = HostPipelineStep(
        programs, stage=rank, num_stages=size, num_microbatches=M,
        optimizer=optim.SGD(module.parameters(), lr=opts["lr"]),
        group=link, schedule=opts.get("schedule", "1f1b"),
        act_template=host_act_template(cfg, opts["batch"] // M, opts["seq"],
                                       torch.float32),
        delay_s=opts.get("delay_s", 0.0))
    tracer = None
    if opts.get("trace"):
        tracer = tracing.configure()
        tracing.set_meta(rank=rank, world=size)
    losses = []
    for b in make_batches(opts["steps"], opts["batch"], opts["seq"],
                          cfg.vocab_size, opts["seed"] + 1):
        met = host.step(b, buffers)
        if "loss" in met:
            losses.append(met["loss"])
    params = {k: _numpy(v) for k, v in module.state_dict().items()}
    crc = 0
    for k in sorted(params):
        crc = zlib.crc32(np.ascontiguousarray(params[k]).tobytes(), crc)
    res = {"losses": losses, "stage_params": params, "crc": crc}
    if opts.get("trace"):
        import json
        import os
        import tempfile

        path = os.path.join(tempfile.mkdtemp(), "trace.json")
        tracer.export(path)
        with open(path) as f:
            res["trace"] = json.load(f)
        tracing.clear()
    return res


def link_mismatch():
    """A matched tagged pair over a debug link, then a desynced one: the
    sender ships ``act.m1.s1``, the receiver expects ``act.m2.s1``; each
    end's error (the sender's at its flush)."""
    from pytorch_distributed_tpu_torch.runtime import distributed as dist

    link = dist.StageLink(debug=True)
    a = torch.full((4, 8), float(dist.get_rank()))
    if link.stage == 0:
        link.send(a, 1, tag="act.m0.s1")
    else:
        got = link.recv(a, 0, tag="act.m0.s1")
        assert torch.all(got == 0.0), got
    err = None
    try:
        if link.stage == 0:
            link.send(a, 1, tag="act.m1.s1")
            link.flush()
        else:
            link.recv(a, 0, tag="act.m2.s1")
    except RuntimeError as e:
        err = str(e)
    time.sleep(0.2)   # the peer reads its verdict before this rank leaves
    return {"mismatch_error": err}
