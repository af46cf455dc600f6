"""Rank processes for tests/test_torch_t5_tp_sp.py (spawned by
``torch_dp_workers.spawn``; this module imports no JAX). Each rank joins
a gloo group on localhost and returns numpy results; the test holds them
against the JAX package on the same inputs, and under tensor
parallelism also against the world of one.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from tests.torch_dp_workers import _join, _run
from tests.torch_fsdp_workers import full
from tests.torch_tp_workers import _chunk, _coord, load_full, local_part


def _table_fn(case, coord=None, sizes=None):
    """The case's ``bias_fn``: T5's buckets over its table, every head,
    or with ``coord`` and ``sizes`` this rank's ``tp`` share of them (the
    table sharded on heads, as ``place_tables`` shards T5's)."""
    from pytorch_distributed_tpu_torch.models import t5

    table = case["table"]
    if coord is not None:
        table = _chunk(table, 1, coord["tp"], sizes["tp"])
    table = torch.from_numpy(np.ascontiguousarray(table))

    def fn(q_pos, k_pos):
        return t5.relative_bias_from_table(
            table, q_pos, k_pos, bidirectional=case["bidirectional"],
            num_buckets=table.shape[0], max_distance=case["max_distance"])

    return fn


def sp_world(rank, world, port, job, out):
    """``job["attn"]``: per case, ring attention with a ``bias_fn`` on this
    rank's part of global q/k/v (``mesh``, ``causal``), the output and
    the gradients of ``sum(out * w)``. ``job["t5"]``: per case, T5's
    logits of this rank's encoder and decoder positions under ring
    sequence parallelism (f32)."""
    from pytorch_distributed_tpu_torch.interop import t5_params_from_jax
    from pytorch_distributed_tpu_torch.models import t5
    from pytorch_distributed_tpu_torch.parallel import sequence
    from pytorch_distributed_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )
    from pytorch_distributed_tpu_torch.runtime.precision import Policy

    def body():
        _join(rank, world, port)
        res = {}
        for name, case in job.get("attn", {}).items():
            spec = MeshSpec(**case["mesh"]).resolve(world)
            sizes = dict(dp=spec.dp, fsdp=spec.fsdp, sp=spec.sp, tp=spec.tp)
            coord = _coord(make_mesh(spec, "cpu"))
            q, k, v, w = (torch.from_numpy(np.ascontiguousarray(
                local_part(case[n], coord, sizes))).requires_grad_(n != "w")
                for n in ("q", "k", "v", "w"))
            o = sequence.ring_attention(q, k, v, causal=case["causal"],
                                        scale=1.0,
                                        bias_fn=_table_fn(case, coord, sizes))
            (o * w).sum().backward()
            res[name] = {"coord": coord, "sizes": sizes,
                         "out": o.detach().numpy(), "dq": q.grad.numpy(),
                         "dk": k.grad.numpy(), "dv": v.grad.numpy()}
        for name, case in job.get("t5", {}).items():
            spec = MeshSpec(**case["mesh"]).resolve(world)
            sizes = dict(dp=spec.dp, fsdp=spec.fsdp, sp=spec.sp, tp=spec.tp)
            coord = _coord(make_mesh(spec, "cpu"))
            cfg = case["cfg"]
            model = t5.T5ForConditionalGeneration(cfg, device="cpu",
                                                  policy=Policy.full())
            model.load_state_dict(t5_params_from_jax(case["params"], cfg))
            enc, dec = (torch.from_numpy(np.ascontiguousarray(local_part(
                case[n][..., None], coord, sizes, heads=False)[..., 0]))
                for n in ("enc", "dec"))
            with sequence.sequence_parallel("sp", "ring"), torch.no_grad():
                logits = model(enc, dec)
            res[name] = {"coord": coord, "sizes": sizes,
                         "logits": logits.numpy()}
        return res

    _run(rank, out, body)


@contextlib.contextmanager
def recipe_f32():
    """The port's T5 recipe with its products in f32 (``Policy.full()``
    where it takes ``Policy.train()``), so that the mesh's reordered sums
    are the only difference between two meshes' losses."""
    from pytorch_distributed_tpu_torch.recipes import t5_seq2seq
    from pytorch_distributed_tpu_torch.runtime.precision import Policy

    class F32(Policy):
        @classmethod
        def train(cls):
            return Policy.full()

    t5_seq2seq.Policy = F32
    try:
        yield t5_seq2seq
    finally:
        t5_seq2seq.Policy = Policy


def tp_run(job):
    """On the current group: the recipe ``main(job["argv"])`` in f32 (its
    logged losses and closing match rates), then a model of
    ``job["cfg"]`` built by the recipe on ``MeshSpec(**job["mesh"])``
    (f32) with the JAX ``job["params"]`` loaded into each rank's box:
    the placements of its leaves, its logits on ``job["enc"]``/
    ``job["dec"]``, ``generate_encdec``'s greedy tokens and the whole
    gradients of ``seq2seq_lm_loss_fn`` on ``job["batch"]``."""
    from pytorch_distributed_tpu_torch.interop import t5_params_from_jax
    from pytorch_distributed_tpu_torch.models import t5
    from pytorch_distributed_tpu_torch.parallel import DataParallel
    from pytorch_distributed_tpu_torch.runtime.mesh import MeshSpec
    from pytorch_distributed_tpu_torch.runtime.precision import Policy
    from pytorch_distributed_tpu_torch.train import seq2seq_lm_loss_fn

    with recipe_f32() as recipe:
        trainer = recipe.main(job["argv"])
        res = {"losses": [r["loss"] for r in trainer.history],
               "seq2seq": trainer.seq2seq}
        strategy = DataParallel("cpu", mesh_spec=MeshSpec(**job["mesh"]),
                                extra_rules=t5.t5_partition_rules())
        model, _ = recipe.build_model(job["cfg"], strategy, "cpu",
                                      job["seed"], Policy.full())
    load_full(model, t5_params_from_jax(job["params"], job["cfg"]))
    res["placements"] = {
        name: dict(zip(p.device_mesh.mesh_dim_names,
                       map(str, p.placements)))
        if hasattr(p, "placements") else {}
        for name, p in model.named_parameters()}
    enc, dec = torch.from_numpy(job["enc"]), torch.from_numpy(job["dec"])
    mask = torch.from_numpy(job["mask"])
    with torch.no_grad():
        res["logits"] = full(model(enc, dec, input_mask=mask))
    res["tokens"] = t5.generate_encdec(
        model, enc, max_new_tokens=job["new"], input_mask=mask,
        eos_id=-1).numpy()
    batch = {k: torch.from_numpy(v) for k, v in job["batch"].items()}
    loss, _ = seq2seq_lm_loss_fn(model)(batch, torch.Generator())
    loss.backward()
    res["grads"] = {name: full(p.grad)
                    for name, p in model.named_parameters()}
    return res


def tp_world(rank, world, port, job, out):
    """:func:`tp_run` on this rank of a gloo world."""

    def body():
        _join(rank, world, port)
        return tp_run(job)

    _run(rank, out, body)
