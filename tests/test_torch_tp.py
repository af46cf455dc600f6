"""Tensor parallelism in the port (``parallel/rules.py``,
``parallel/sharding.py``, ``parallel.FSDP`` with ``tp > 1``) against the
JAX package:

* placements by the pure rule functions, without a world: every leaf
  of the tiny Llama, Gemma (MQA: k/v forced whole), Qwen2 (its 2 kv
  heads at tp 4 replicate, with the engine's warning), NeoX, GPT-2 and
  BERT gets the JAX rules' ``PartitionSpec`` at tp 2 and 4, and the port
  tensor that stands for each Llama-body and NeoX leaf gets the port dim
  its spec shards;
* Llama-tiny in gloo worlds of 2 (tp 2) and 4 (fsdp 2 x tp 2; the
  chunked loss over the gathered head): the logits on the JAX model's
  weights (``interop`` converters) within ``1e-5 x max|ref|``, and three
  clip + AdamW(1e-4) steps: the losses within 1e-5 and the parameters
  within ``1e-4 x max|ref|`` of the JAX recipe's step (f32 products);
* the kv-head slice: Gemma-tiny's one kv head at tp 2, and Llama-tiny's 2
  kv heads at tp 4 (a rank's one query head reads kv head ``r // 2``):
  logits, and three clip + AdamW steps (k/v's gradient summed over tp),
  against the JAX model;
* each rank's batch rows at fsdp 2 x tp 2: the JAX loader's slice of
  its ``fsdp`` coordinate (the tp ranks of a share read the same rows);
* a checkpoint saved at fsdp 2 x tp 2 (``torch_fsdp_workers.CFG``, whose
  kv head, vocab 509 and FFN 97 replicate over tp, so q/o and the
  embedding shard, FSDP's rows cut unevenly) restores bitwise at fsdp 4,
  at world 1, and in the JAX package.
"""

import logging
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from pytorch_distributed_tpu.models import bert as jax_bert
from pytorch_distributed_tpu.models import gemma as jax_gemma
from pytorch_distributed_tpu.models import gpt2 as jax_gpt2
from pytorch_distributed_tpu.models import llama as jax_llama
from pytorch_distributed_tpu.models import neox as jax_neox
from pytorch_distributed_tpu.models import qwen2 as jax_qwen2
from pytorch_distributed_tpu.parallel.sharding import (
    PartitionRules as JaxRules,
    path_str as jax_path_str,
)
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu.train import TrainState as JaxTrainState
from pytorch_distributed_tpu.train import build_train_step as jax_step
from pytorch_distributed_tpu.train import causal_lm_loss_fn as jax_loss_fn
from pytorch_distributed_tpu.train.checkpoint import (
    _leaf_files,
    restore_checkpoint as jax_restore_checkpoint,
)
from pytorch_distributed_tpu_torch import models as port_models
from pytorch_distributed_tpu_torch.models.gemma import GemmaConfig
from pytorch_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
)
from pytorch_distributed_tpu_torch.models.neox import (
    NeoXConfig,
    NeoXForCausalLM,
)
from pytorch_distributed_tpu_torch.models.qwen2 import Qwen2Config
from pytorch_distributed_tpu_torch.parallel import rules as port_rules
from pytorch_distributed_tpu_torch.parallel import sharding
from pytorch_distributed_tpu_torch.parallel.strategies import tp_plan
from pytorch_distributed_tpu_torch.runtime.mesh import MeshSpec
from pytorch_distributed_tpu_torch.train import verify_checkpoint
from pytorch_distributed_tpu_torch.train.ckpt_io import load_checkpoint
from tests import torch_dp_workers
from tests import torch_fsdp_workers as fsdp_workers
from tests import torch_tp_workers as workers
from tests.test_torch_fsdp_ckpt import _assert_state_equal, _template
from tests.torch_parity import assert_close

LOGIT_RTOL, LOSS_RTOL, PARAM_RTOL = 1e-5, 1e-5, 1e-4
# lr 1e-4: at 1e-3 the one-process port reads 1.4e-4 x max on the gate
# kernel against the JAX step by itself (Adam steps entries whose
# gradient is rounding noise by up to lr, in either framework)
LR, CHUNK = 1e-4, 100
F32 = JaxPolicy(compute_dtype=jnp.float32)


def _sizes(tp):
    return dict(dp=1, fsdp=1, pp=1, ep=1, sp=1, tp=tp)


def _jax_params(jmodel, ids_len=8):
    with use_policy(F32):
        return jax.device_get(jmodel.init(
            jax.random.key(0), jnp.zeros((1, ids_len), jnp.int32))["params"])


FAMILIES = {
    "llama": (lambda: jax_llama.LlamaForCausalLM(
        jax_llama.LlamaConfig.tiny()), jax_llama.llama_partition_rules,
        port_models.llama_partition_rules),
    "gemma": (lambda: jax_gemma.GemmaForCausalLM(
        jax_gemma.GemmaConfig.tiny()),
        lambda: jax_gemma.gemma_partition_rules(jax_gemma.GemmaConfig.tiny()),
        lambda: port_models.gemma_partition_rules(GemmaConfig.tiny())),
    "qwen2": (lambda: jax_qwen2.Qwen2ForCausalLM(
        jax_qwen2.Qwen2Config.tiny()), jax_qwen2.qwen2_partition_rules,
        port_models.qwen2_partition_rules),
    "neox": (lambda: jax_neox.NeoXForCausalLM(jax_neox.NeoXConfig.tiny()),
             jax_neox.neox_partition_rules, port_models.neox_partition_rules),
    "gpt2": (lambda: jax_gpt2.GPT2LMHead(jax_gpt2.GPT2Config.tiny()),
             jax_gpt2.gpt2_partition_rules, port_models.gpt2_partition_rules),
    "bert": (lambda: jax_bert.BertForSequenceClassification(
        jax_bert.BertConfig.tiny()), jax_bert.bert_partition_rules,
        port_models.bert_partition_rules),
}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_every_leaf_gets_the_jax_rules_spec(family, tp):
    make, jax_rules, rules = FAMILIES[family]
    jmodel = make()
    shapes = jax.eval_shape(lambda: {"params": jmodel.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]})
    mesh = types.SimpleNamespace(shape=_sizes(tp))
    want_rules, got_rules = JaxRules(jax_rules()), sharding.as_rules(rules())
    n_sharded = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        p = jax_path_str(path)
        want = want_rules.spec_for(p, leaf.shape, mesh)
        got = got_rules.spec_for(p, leaf.shape, _sizes(tp))
        want = None if want is None else tuple(want)
        assert (None if got is None else tuple(got)) == want, (family, p)
        n_sharded += want is not None and "tp" in want
    assert n_sharded >= 6, family


def test_tree_and_optimizer_state_inference_match_jax():
    """``infer_tree_shardings`` with ``shard_along`` (the JAX FSDP
    fallback) over Llama-tiny's leaves, and ``infer_opt_tree_shardings``
    on Adam-shaped and factored (Adafactor) states, against the JAX
    functions on the same paths and shapes."""
    from jax.sharding import PartitionSpec as JaxP

    from pytorch_distributed_tpu.parallel import sharding as jax_sharding

    jmodel = jax_llama.LlamaForCausalLM(jax_llama.LlamaConfig.tiny())
    params = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), params,
                                    is_leaf=lambda x: hasattr(x, "shape"))
    sizes = dict(_sizes(2), fsdp=4)
    mesh = types.SimpleNamespace(shape=sizes)
    fallback = [(".*", jax_sharding.shard_along("fsdp"))]
    rules = jax_sharding.PartitionRules(
        jax_llama.llama_partition_rules()).extended(fallback)
    port = sharding.as_rules(port_models.llama_partition_rules()).extended(
        [(".*", sharding.shard_along("fsdp"))])
    want = {jax_path_str(p): tuple(rules.spec_for(jax_path_str(p), s, mesh))
            for p, s in jax.tree_util.tree_leaves_with_path(
                shapes, is_leaf=lambda x: isinstance(x, tuple))}
    got = sharding.infer_tree_shardings(shapes, port, sizes)
    assert {k: tuple(v) for k, v in got.items()} == want
    # a moment of the parameter's shape takes its rules; a factored one
    # (another shape) the mismatch rules, or replicates
    opt = {"mu": shapes, "v_row": {"layers": {"block": {"gate": {
        "kernel": (2, 64)}}}}}
    for mismatch in (None, fallback):
        jm = None if mismatch is None else jax_sharding.PartitionRules(
            mismatch)
        pm = None if mismatch is None else sharding.as_rules(
            [(".*", sharding.shard_along("fsdp"))])
        got = sharding.infer_opt_tree_shardings(opt, shapes, port, sizes,
                                                mismatch_rules=pm)
        row = "v_row/layers/block/gate/kernel"
        want_row = (JaxP() if jm is None else jm.spec_for(row, (2, 64),
                                                           mesh))
        assert tuple(got[row]) == tuple(want_row)
        assert tuple(got["mu/layers/block/q/kernel"]) == want[
            "layers/block/q/kernel"]
    assert sharding.stacked(sharding.P("tp", None))((2, 8, 8), sizes) == (
        None, "tp", None)
    assert tuple(sharding.REPLICATED.spec_for("x", (4,), sizes) or ()) == ()


def _llama_dims(kv):
    dims = {"q.weight": 0, "o.weight": 1, "gate.weight": 0, "up.weight": 0,
            "down.weight": 1}
    if kv:
        dims.update({"k.weight": 0, "v.weight": 0})
    return dims


@pytest.mark.parametrize("case", ["llama2", "gemma2", "qwen2_tp4",
                                  "neox2"])
def test_port_tensors_take_the_dim_their_leaf_shards(case, caplog):
    cfg, tp, kv, tied = {
        "llama2": (LlamaConfig.tiny(), 2, True, False),
        "gemma2": (GemmaConfig.tiny(), 2, False, True),
        "qwen2_tp4": (Qwen2Config.tiny(), 4, False, False),
        "neox2": (NeoXConfig.tiny(), 2, None, None),
    }[case]
    logger = logging.getLogger(port_rules.__name__)
    logger.addHandler(caplog.handler)
    port_rules.reset_warned()
    try:
        if case == "neox2":
            model = NeoXForCausalLM(cfg, device="meta")
            placed = sharding.infer_placements(
                model, port_models.neox_partition_rules(), _sizes(tp))
            want = {"embed.weight": 1, "embed_out.weight": 0}
            for i in range(cfg.num_layers):
                want.update({f"layers.{i}.{n}": d for n, d in (
                    ("qkv.weight", 0), ("qkv.bias", 0),
                    ("attn_out.weight", 1), ("mlp_up.weight", 0),
                    ("mlp_up.bias", 0), ("mlp_down.weight", 1))})
        else:
            model = LlamaForCausalLM(cfg, device="meta")
            rules = port_models.gemma_partition_rules(cfg)
            placed = sharding.infer_placements(model, rules, _sizes(tp))
            want = {"embed.weight": 1}
            if not tied:
                want["lm_head.weight"] = 0
            for i in range(cfg.num_layers):
                want.update({f"layers.{i}.{n}": d
                             for n, d in _llama_dims(kv).items()})
    finally:
        logger.removeHandler(caplog.handler)
    assert placed == {n: {"tp": d} for n, d in want.items()}, case
    warned = [r for r in caplog.records if "replicating" in r.getMessage()]
    # shape-based replication warns once per shape; Gemma's forced MQA
    # form consults no shape
    assert len(warned) == (1 if case == "qwen2_tp4" else 0), case
    if case == "qwen2_tp4":
        # the JAX rules leave Qwen2's q/k/v biases whole: no TP plan
        with pytest.raises(NotImplementedError, match="A10.1"):
            tp_plan(model, port_models.qwen2_partition_rules(),
                    MeshSpec(dp=1, tp=4).resolve(4))


# --------------------------------------------------------------------------
# Llama-tiny in gloo worlds of 2 and 4
# --------------------------------------------------------------------------


def _batches(n, seed=11, B=4, S=16, vocab=512):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (B, S)).astype(np.int64)}
            for _ in range(n)]


def _jax_steps(jmodel, params, data, chunk):
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR))
    state = JaxTrainState.create(apply_fn=jmodel.apply, params=params, tx=tx)
    step = jax.jit(jax_step(jax_loss_fn(jmodel, vocab_chunk_size=chunk)))
    losses = []
    for batch in data:
        with use_policy(F32):
            state, metrics = step(state, {k: jnp.asarray(v.astype(np.int32))
                                          for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
    return losses, jax.device_get(state.params)


def _logits(jmodel, params, ids):
    with use_policy(F32):
        return np.asarray(jmodel.apply({"params": params},
                                       jnp.asarray(ids.astype(np.int32))))


@pytest.fixture(scope="module")
def jax_ref():
    llama = jax_llama.LlamaForCausalLM(jax_llama.LlamaConfig.tiny())
    gemma = jax_gemma.GemmaForCausalLM(jax_gemma.GemmaConfig.tiny())
    lp, gp = _jax_params(llama), _jax_params(gemma)
    ids = _batches(1, seed=3)[0]["input_ids"]
    data = _batches(3)
    return {
        "ids": ids, "data": data, "llama": lp, "gemma": gp,
        "llama_logits": _logits(llama, lp, ids),
        "gemma_logits": _logits(gemma, gp, ids),
        "steps_full": _jax_steps(llama, lp, data, None),
        "steps_chunk": _jax_steps(llama, lp, data, CHUNK),
        "gemma_steps": _jax_steps(gemma, gp, data, None),
    }


def _case(cfg, spec, params, ids, steps=None, chunk=None):
    return dict(cfg=cfg, spec=spec, params=params, ids=ids, steps=steps,
                chunk=chunk, lr=LR)


@pytest.fixture(scope="module")
def world2(jax_ref):
    r = jax_ref
    cases = {
        "llama_tp2": _case(LlamaConfig.tiny(), dict(dp=1, tp=2), r["llama"],
                           r["ids"], r["data"]),
        "gemma_tp2": _case(GemmaConfig.tiny(), dict(dp=1, tp=2), r["gemma"],
                           r["ids"], r["data"]),
    }
    return torch_dp_workers.spawn(workers.tp_world, 2, {"cases": cases})


@pytest.fixture(scope="module")
def world4(jax_ref, tmp_path_factory):
    r = jax_ref
    cases = {
        "llama_fsdp2_tp2": _case(LlamaConfig.tiny(), dict(dp=1, fsdp=2,
                                                          tp=2),
                                 r["llama"], r["ids"], r["data"], CHUNK),
        "llama_tp4": _case(LlamaConfig.tiny(), dict(dp=1, tp=4), r["llama"],
                           r["ids"], r["data"]),
    }
    pdir = str(tmp_path_factory.mktemp("tp_ckpt"))
    ranks = torch_dp_workers.spawn(
        workers.tp_world, 4,
        {"cases": cases, "ckpt": {"spec": dict(dp=1, fsdp=2, tp=2),
                                  "steps": 2, "dir": pdir}})
    return ranks, pdir


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v)


def _assert_steps_match(ranks, case, ref_logits, steps):
    losses, params = steps
    want = dict(_flat(params))
    # each rank logs its data share's mean; the shares' mean is the
    # batch's (at fsdp 2 the two data shares, each held by 2 tp ranks)
    assert_close(np.mean([r[case]["losses"] for r in ranks], axis=0),
                 losses, LOSS_RTOL, f"{case} losses")
    for res in ranks:
        got = res[case]
        assert_close(got["logits"], ref_logits, LOGIT_RTOL, f"{case} logits")
        for path, arr in _flat(got["params"]):
            assert_close(arr, want[path], PARAM_RTOL, f"{case} {path}")


@pytest.mark.parametrize("world, case", [(2, "llama_tp2"),
                                         (4, "llama_fsdp2_tp2")])
def test_llama_logits_and_steps_match_jax(world2, world4, jax_ref, world,
                                          case):
    ranks = world2 if world == 2 else world4[0]
    _assert_steps_match(ranks, case, jax_ref["llama_logits"],
                        jax_ref["steps_full" if world == 2
                                else "steps_chunk"])
    # each rank held half the query heads of q (and, at fsdp 2, half
    # of those rows)
    rows = 64 // 2 // (2 if world == 4 else 1)
    assert ranks[-1][case]["local"]["layers.0.q.weight"][0] == rows


def test_ranks_read_the_jax_loaders_rows_of_their_data_coordinate(
        world4, monkeypatch):
    """At fsdp 2 x tp 2 the two tp ranks of a data share read the same
    rows: the JAX loader's slice for the ``fsdp`` coordinate, over two
    shares."""
    from pytorch_distributed_tpu.data.loader import (
        DataLoader as JaxDataLoader,
    )
    from pytorch_distributed_tpu.runtime import distributed as jax_dist

    loader = JaxDataLoader(list(range(4)), 2, shuffle=False)
    for rank, res in enumerate(world4[0]):
        share = rank // 2   # ranks (fsdp, tp) in the JAX order
        ring = type("Ring", (), {"world_size": 2, "rank": share})()
        monkeypatch.setattr(jax_dist, "multiprocess_ring", lambda r=ring: r)
        for n, rows in res["llama_fsdp2_tp2"]["rows"].items():
            np.testing.assert_array_equal(
                rows, loader._rank_slice(np.arange(n)),
                err_msg=f"rank {rank} of {n}")


@pytest.mark.parametrize("world, case, ref, steps", [
    (2, "gemma_tp2", "gemma_logits", "gemma_steps"),
    (4, "llama_tp4", "llama_logits", "steps_full")])
def test_replicated_kv_heads_are_sliced_to_the_local_queries(
        world2, world4, jax_ref, world, case, ref, steps):
    """k/v whole on every rank while q shards: the forward reads each
    rank's kv slice, and the backward sums k/v's gradient over tp, so
    the logits, the losses and the parameters after three clip + AdamW
    steps match the JAX model's."""
    ranks = world2 if world == 2 else world4[0]
    _assert_steps_match(ranks, case, jax_ref[ref], jax_ref[steps])
    for res in ranks:
        # k/v whole on every rank, q a 1/tp share
        local = res[case]["local"]
        assert local["layers.0.k.weight"][0] == (16 if case == "gemma_tp2"
                                                 else 32)
        assert local["layers.0.q.weight"][0] == 64 // world


def test_fsdp2_tp2_checkpoint_restores_at_fsdp4_world1_and_in_jax(world4):
    ranks, pdir = world4
    final = ranks[0]["ckpt"]["final"]
    for res in ranks:
        ck = res["ckpt"]
        _assert_state_equal(ck["final"], final, "gathered at fsdp2 x tp2")
        _assert_state_equal(ck["restored"], final, "restored at fsdp 4")
        assert set(ck["diff"].values()) == {0.0}
        assert set(ck["diff_saved"].values()) == {0.0}
    # q and o shard over tp (then q's rows over fsdp), k/v and the FFN 97
    # stay whole over tp
    local = ranks[3]["ckpt"]["local"]
    assert local["layers.0.q.weight"] == (16, 64)
    assert local["layers.0.o.weight"] == (32, 32)
    assert local["layers.0.gate.weight"] == (48, 64)
    w1 = torch_dp_workers.in_process(fsdp_workers.fsdp_ckpt,
                                     {"restore": pdir, "seed": 2})
    _assert_state_equal(w1["restored"], final, "restored at world 1")
    assert verify_checkpoint(pdir) == []
    files = load_checkpoint(os.path.join(pdir, "latest")).leaves
    restored = jax_restore_checkpoint(pdir, _template())
    got = {k: np.asarray(v) for k, v in _leaf_files(restored)}
    assert sorted(got) == sorted(files)
    for name, arr in files.items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    assert int(restored.step) == 2
