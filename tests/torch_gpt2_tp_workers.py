"""Rank processes for tests/test_torch_gpt2_tp.py,
tests/test_torch_tp_generate.py and tests/test_torch_tp_serve.py
(spawned by ``torch_dp_workers.spawn``; this module imports no JAX).
Each rank joins a gloo group on localhost, builds its models sharded on
the mesh a case names, loads whole world-1 weights (each rank its own
box) and returns numpy results that the tests hold against the JAX
package.
"""

from __future__ import annotations

import dataclasses

import torch

from tests.torch_dp_workers import _join, _run
from tests.torch_fsdp_workers import full
from tests.torch_tp_workers import load_full, recipe_f32

LR = 1e-4
WEIGHT_DECAY = 1e-4   # optax.adamw's default


def model_parts(family: str):
    """``(model class, partition rules, config class)`` of a family."""
    from pytorch_distributed_tpu_torch.models.gemma import (
        GemmaConfig,
        gemma_partition_rules,
    )
    from pytorch_distributed_tpu_torch.models.gpt2 import (
        GPT2Config,
        GPT2LMHead,
        gpt2_partition_rules,
    )
    from pytorch_distributed_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
    )
    from pytorch_distributed_tpu_torch.models.mixtral import (
        MixtralConfig,
        MixtralForCausalLM,
        mixtral_partition_rules,
    )

    return {
        "gpt2": (GPT2LMHead, gpt2_partition_rules, GPT2Config),
        "llama": (LlamaForCausalLM,
                  lambda: gemma_partition_rules(LlamaConfig.tiny()),
                  LlamaConfig),
        "gemma": (LlamaForCausalLM,
                  lambda: gemma_partition_rules(GemmaConfig.tiny()),
                  GemmaConfig),
        "mixtral": (MixtralForCausalLM, mixtral_partition_rules,
                    MixtralConfig),
    }[family]


def build(family: str, cfg, spec, state_dict, strategy: str = "dp"):
    """``(model, strategy)``: ``family``'s model of ``cfg`` in f32, the
    whole ``state_dict`` (the port's names) loaded; with ``spec`` sharded
    on that mesh under ``strategy`` (``dp``, ``zero1`` or, with ``fsdp``
    above 1, FSDP), else one plain model."""
    from pytorch_distributed_tpu_torch.parallel import (
        FSDP,
        DataParallel,
        ZeRO1,
    )
    from pytorch_distributed_tpu_torch.runtime.mesh import MeshSpec
    from pytorch_distributed_tpu_torch.runtime.precision import Policy

    cls, rules, _ = model_parts(family)
    if spec is None:
        model = cls(cfg, device="cpu", policy=Policy.full())
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in state_dict.items()})
        return model, None
    if spec.get("fsdp", 1) > 1:
        st = FSDP("cpu", MeshSpec(**spec), extra_rules=rules())
    else:
        st = (ZeRO1 if strategy == "zero1" else DataParallel)(
            "cpu", mesh_spec=MeshSpec(**spec), extra_rules=rules())
    model = cls(cfg, device="meta", policy=Policy.full())
    st.wrap(model)
    model.to_empty(device="cpu")
    load_full(model, {k: torch.as_tensor(v) for k, v in state_dict.items()})
    return model, st


def whole_jax(model) -> dict:
    """The model's parameters gathered whole, as the JAX tree."""
    from pytorch_distributed_tpu_torch import interop

    rows = getattr(model, "whole_rows", lambda n, t: t)
    sd = {n: rows(n, torch.from_numpy(full(p)))
          for n, p in model.named_parameters()}
    if hasattr(model, "qkv_ways"):
        return interop.gpt2_params_to_jax(sd, model.config)
    return interop.llama_params_to_jax(sd, model.config)


def _local_shapes(model):
    from pytorch_distributed_tpu_torch.runtime.mesh import shard_box

    return {n: tuple(shard_box(p)[0].shape)
            for n, p in model.named_parameters()}


# --------------------------------------------------------------------------
# GPT-2 training under tensor parallelism (tests/test_torch_gpt2_tp.py)
# --------------------------------------------------------------------------


def _train_case(case):
    """Logits, and with ``steps`` three clip + AdamW steps under
    ``case["strategy"]``: losses, whole parameters, the optimizer's
    placement; with ``ckpt`` the state saved and diffed."""
    from pytorch_distributed_tpu_torch import optim
    from pytorch_distributed_tpu_torch.interop import unwrap_optimizer
    from pytorch_distributed_tpu_torch.runtime.mesh import data_rank
    from pytorch_distributed_tpu_torch.runtime.precision import Policy
    from pytorch_distributed_tpu_torch.train import (
        TrainState,
        build_train_step,
        causal_lm_loss_fn,
        save_checkpoint,
    )
    from pytorch_distributed_tpu_torch.train.checkpoint import (
        checkpoint_diff,
    )

    model, st = build("gpt2", case["cfg"], case["spec"], case["sd"],
                      case["strategy"])
    with torch.no_grad():
        got = {"logits": model(torch.from_numpy(case["ids"])).numpy().copy(),
               "local": _local_shapes(model)}
    if not case.get("steps"):
        return got
    kw = dict(lr=LR, weight_decay=WEIGHT_DECAY)
    inner = (st.optimizer(model, optim.AdamW, **kw)
             if case["strategy"] == "zero1" else optim.AdamW(model, **kw))
    state = TrainState(model, optim.clip_grad_norm(inner, 1.0),
                       policy=Policy.full())
    step = build_train_step(causal_lm_loss_fn(model))
    losses = []
    for batch in case["steps"]:
        state, metrics = step(state, st.shard_batch(batch))
        losses.append(float(metrics["loss"]))
    _, adam, _ = unwrap_optimizer(state.optimizer)
    names = {id(p): n for n, p in model.named_parameters()}
    got.update(losses=losses, params=whole_jax(model),
               data=data_rank()[0],
               owned=sorted(names[id(p)] for g in adam.param_groups
                            for p in g["params"]),
               moments={names[id(p)]: tuple(s["exp_avg"].to_local().shape)
                        for p, s in adam.state.items()})
    if case.get("ckpt"):
        save_checkpoint(case["ckpt"], state)
        got["diff"] = checkpoint_diff(case["ckpt"], state)
        got["restored"] = _restore_at(case["cfg"], case["restore_spec"],
                                      case["ckpt"])
    return got


def _restore_at(cfg, spec, ckpt_dir):
    """A fresh ZeRO-1 GPT-2 on ``spec`` restored from ``ckpt_dir``: its
    diff against the files and its whole parameters."""
    from pytorch_distributed_tpu_torch import optim
    from pytorch_distributed_tpu_torch.models.gpt2 import (
        GPT2LMHead,
        gpt2_partition_rules,
    )
    from pytorch_distributed_tpu_torch.parallel import ZeRO1
    from pytorch_distributed_tpu_torch.runtime.mesh import MeshSpec
    from pytorch_distributed_tpu_torch.runtime.precision import Policy
    from pytorch_distributed_tpu_torch.train import (
        TrainState,
        restore_checkpoint,
    )
    from pytorch_distributed_tpu_torch.train.checkpoint import (
        checkpoint_diff,
    )

    st = ZeRO1("cpu", mesh_spec=MeshSpec(**spec),
               extra_rules=gpt2_partition_rules())
    model = st.wrap(GPT2LMHead(cfg, device="meta", policy=Policy.full()))
    model.to_empty(device="cpu")
    model.init_weights(torch.Generator().manual_seed(9))
    state = TrainState(model, optim.clip_grad_norm(st.optimizer(
        model, optim.AdamW, lr=LR, weight_decay=WEIGHT_DECAY), 1.0),
        policy=Policy.full())
    restore_checkpoint(ckpt_dir, state)
    return {"diff": checkpoint_diff(ckpt_dir, state),
            "params": whole_jax(model), "step": state.step}


def _pipelined_case(case):
    """One pipelined clip + AdamW step at ``case["spec"]`` (``pp`` and
    ``tp``): its loss, and the stage's local shapes."""
    from pytorch_distributed_tpu_torch import optim
    from pytorch_distributed_tpu_torch.models.gpt2 import (
        GPT2LMHead,
        gpt2_partition_rules,
    )
    from pytorch_distributed_tpu_torch.parallel.pipeline_lm import (
        PipelineParallel,
        pipelined_causal_lm_loss_fn,
    )
    from pytorch_distributed_tpu_torch.runtime.mesh import MeshSpec
    from pytorch_distributed_tpu_torch.runtime.precision import Policy
    from pytorch_distributed_tpu_torch.train import (
        TrainState,
        build_train_step,
    )

    st = PipelineParallel("cpu", mesh_spec=MeshSpec(**case["spec"]),
                          extra_rules=gpt2_partition_rules())
    model = st.wrap(GPT2LMHead(case["cfg"], device="meta",
                               policy=Policy.full()))
    start = model.pipeline_stage.start
    sd = {}
    for name, arr in case["sd"].items():
        if name.startswith("blocks."):
            i, sub = name[len("blocks."):].split(".", 1)
            if not start <= int(i) < model.pipeline_stage.stop:
                continue
            name = f"blocks.{int(i) - start}.{sub}"
        sd[name] = torch.as_tensor(arr)
    load_full(model, sd)
    inner = optim.AdamW(model, lr=LR, weight_decay=WEIGHT_DECAY)
    for group in inner.param_groups:
        # the card's multi-tensor step (the CPU's default is per tensor),
        # which takes DTensors and plain tensors in separate groups
        group["foreach"] = True
    state = TrainState(model, optim.clip_grad_norm(inner, 1.0),
                       policy=Policy.full())
    step = build_train_step(pipelined_causal_lm_loss_fn(
        model, num_microbatches=case["micro"]))
    state, metrics = step(state, st.shard_batch(case["batch"]))
    return {"loss": float(metrics["loss"]), "local": _local_shapes(model),
            "stage": model.pipeline_stage.stage,
            "groups": [sorted({type(p).__name__ for p in g["params"]})
                       for g in inner.param_groups]}


def train_world(rank, world, port, job, out):
    """``job["cases"]``: per case :func:`_train_case` (or, with ``micro``,
    :func:`_pipelined_case`); ``job["llama_recipe"]``: the port's Llama
    recipe ``main(argv)`` for each argv, products in f32, its logged
    losses."""

    def body():
        _join(rank, world, port)
        res = {}
        for name, case in job.get("cases", {}).items():
            res[name] = (_pipelined_case(case) if case.get("micro")
                         else _train_case(case))
        argvs = job.get("llama_recipe", [])
        if argvs:
            with recipe_f32() as llama_fsdp:
                res["llama_recipe"] = [
                    [r["loss"] for r in llama_fsdp.main(argv).history]
                    for argv in argvs]
        return res

    _run(rank, out, body)


# --------------------------------------------------------------------------
# generate and the serving engine on a sharded model
# --------------------------------------------------------------------------


def cache_heads(model) -> int:
    """The heads of the model's dense cache (its pool's too)."""
    return int(model.init_cache(1, 8)[0][0].shape[2])


def generate_world(rank, world, port, job, out):
    """Per case: greedy ``generate`` of ``case["ids"]`` on ``family``'s
    model sharded on ``spec`` (``new`` tokens), and its cache's heads."""
    from pytorch_distributed_tpu_torch.generation import generate

    def body():
        _join(rank, world, port)
        res = {}
        for name, case in job.items():
            model, _ = build(case["family"], case["cfg"], case["spec"],
                             case["sd"])
            with torch.no_grad():
                toks = generate(model, torch.from_numpy(case["ids"]),
                                max_new_tokens=case["new"], temperature=0.0,
                                device="cpu")
            res[name] = {"tokens": toks.numpy(), "heads": cache_heads(model)}
        return res

    _run(rank, out, body)


ENGINE = dict(num_slots=2, max_len=32, page_size=8, prefill_chunk=8)


def serve(model, prompts, new: int, sampled: dict):
    """``ServeEngine`` over ``prompts`` (greedy, ``new`` tokens each) and
    one ``sampled`` request: the streams and the pool's K buffer shape."""
    from pytorch_distributed_tpu_torch.serve import (
        EngineConfig,
        Request,
        ServeEngine,
    )

    eng = ServeEngine(model, EngineConfig(**ENGINE), device="cpu")
    hs = [eng.submit(Request(p, new, request_id=str(i)))
          for i, p in enumerate(prompts)]
    hs.append(eng.submit(Request(prompts[0], new, request_id="sampled",
                                 **sampled)))
    eng.run_until_drained()
    return {"streams": [list(h.tokens) for h in hs],
            "pool": tuple(eng.pool.cache[0][0].shape)}


def serve_world(rank, world, port, job, out):
    """Per case: :func:`serve` on ``family``'s model (``cfg``, with and
    without the int8 pool) sharded on ``spec``."""

    def body():
        _join(rank, world, port)
        res = {}
        for name, case in job.items():
            for quant in (None, "int8"):
                cfg = dataclasses.replace(case["cfg"],
                                          kv_cache_quantize=quant)
                model, _ = build(case["family"], cfg, case["spec"],
                                 case["sd"])
                with torch.no_grad():
                    res[(name, quant)] = serve(model, case["prompts"],
                                               case["new"], case["sampled"])
        return res

    _run(rank, out, body)
