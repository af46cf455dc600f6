"""T5 under sequence and tensor parallelism in the port, over gloo
(ranks in ``tests/torch_t5_workers.py``):

* ring attention with T5's ``bias_fn`` (evaluated per block from global
  positions) at sp 4, causal and bidirectional, and at sp 2 x tp 2 with
  each rank's fn giving its own heads (its ``tp`` share of the table, as
  ``place_tables`` shards T5's): outputs within
  2e-5 and q/k/v gradients (of ``sum(out * w)``) within 1e-4 of the
  largest magnitude of JAX ``dot_product_attention`` with the bias
  materialized over the whole sequence (f32);
* Ulysses refuses ``bias_fn`` and names ring; the dispatcher outside
  sequence parallelism materializes the bias unsharded, as JAX's
  ``attention`` does;
* a whole T5 forward (tiny, f32) under ring sp 4 against the JAX
  model's plain forward, within 1e-5 of the logits' largest magnitude;
* the recipe at ``--tp 2`` (world 2, products in f32) takes world 1's
  losses within 1e-5 of themselves and its closing match rates, and a
  T5 sharded by ``t5_partition_rules`` (q/k/v and ``wi`` on heads and
  hidden, ``o``/``wo`` row-parallel, ``shared`` on hidden, the bias
  tables on heads) gives world 1's logits within 1e-5 and
  ``generate_encdec``'s tokens exactly;
* with JAX-initialised params loaded into each rank's box, that model
  at tp 1 and tp 2 gives JAX's own logits within 1e-5 of their largest
  magnitude, JAX ``generate_encdec``'s greedy tokens exactly, and
  ``seq2seq_lm_loss_fn``'s gradients within 1e-4 of the largest
  magnitude of ``jax.grad``'s, per tensor (f32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models import t5 as jt5
from pytorch_distributed_tpu.ops.attention import dot_product_attention
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu.train import losses as jlosses
from pytorch_distributed_tpu_torch.interop import t5_params_from_jax
from pytorch_distributed_tpu_torch.models import t5
from pytorch_distributed_tpu_torch.ops.attention import attention
from pytorch_distributed_tpu_torch.parallel import sequence
from tests import torch_dp_workers
from tests import torch_t5_workers as workers
from tests.torch_parity import assert_close, assert_equal
from tests.torch_tp_workers import local_part

OUT_RTOL, GRAD_RTOL, LOGIT_RTOL, LOSS_RTOL = 2e-5, 1e-4, 1e-5, 1e-5
F32 = JaxPolicy(compute_dtype=jnp.float32)

# name: (port mesh, causal, bidirectional buckets)
ATTN = {"ring_sp4_causal": (dict(dp=1, sp=4), True, False),
        "ring_sp4_bidirectional": (dict(dp=1, sp=4), False, True),
        "ring_sp2_tp2": (dict(dp=1, sp=2, tp=2), True, False)}


def _attn_case(i, mesh, causal, bidirectional, B=2, S=32, H=4, D=8):
    rng = np.random.default_rng(i)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(q=f(B, S, H, D), k=f(B, S, H, D), v=f(B, S, H, D),
                w=f(B, S, H, D), table=f(8, H), max_distance=16,
                bidirectional=bidirectional, causal=causal, mesh=mesh)


def _jax_attn(case):
    """Output and q/k/v gradients with the bias materialized whole."""
    S = case["q"].shape[1]
    bias = jt5.relative_bias_from_table(
        jnp.asarray(case["table"]), jnp.arange(S), jnp.arange(S),
        bidirectional=case["bidirectional"], num_buckets=8,
        max_distance=case["max_distance"])[None]

    def loss(q, k, v):
        out = dot_product_attention(q, k, v, causal=case["causal"],
                                    bias=bias, scale=1.0)
        return (out * case["w"]).sum(), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        *(jnp.asarray(case[n]) for n in ("q", "k", "v")))
    return {"out": np.asarray(out),
            **{k: np.asarray(g) for k, g in zip(("dq", "dk", "dv"), grads)}}


def _t5_cfgs():
    kw = dict(vocab_size=256, d_model=64, d_kv=16, d_ff=128, num_layers=2,
              num_heads=4, relative_attention_num_buckets=8,
              relative_attention_max_distance=32, dropout_rate=0.0)
    return jt5.T5Config(**kw), t5.T5Config(**kw)


@pytest.fixture(scope="module")
def t5_ref():
    jcfg, cfg = _t5_cfgs()
    rng = np.random.default_rng(0)
    enc = rng.integers(2, 256, size=(2, 64))
    dec = rng.integers(2, 256, size=(2, 32))
    jmodel = jt5.T5ForConditionalGeneration(jcfg)
    with use_policy(F32):
        params = jax.device_get(jmodel.init(
            jax.random.key(0), jnp.zeros((1, 4), jnp.int32),
            jnp.zeros((1, 4), jnp.int32))["params"])
        logits = np.asarray(jax.jit(jmodel.apply)(
            {"params": params}, jnp.asarray(enc), jnp.asarray(dec)))
    return dict(cfg=cfg, params=params, enc=enc, dec=dec, mesh=dict(dp=1,
                                                                    sp=4)), \
        logits


@pytest.fixture(scope="module")
def sp_ranks(t5_ref):
    attn = {name: _attn_case(i, *spec)
            for i, (name, spec) in enumerate(sorted(ATTN.items()))}
    case, _ = t5_ref
    return attn, torch_dp_workers.spawn(
        workers.sp_world, 4, {"attn": attn, "t5": {"t5_ring": case}})


@pytest.mark.parametrize("name", sorted(ATTN))
def test_ring_bias_fn_matches_the_materialized_bias(sp_ranks, name):
    attn, results = sp_ranks
    want = _jax_attn(attn[name])
    for res in results:
        got = res[name]
        for key in ("out", "dq", "dk", "dv"):
            ref = local_part(want[key], got["coord"], got["sizes"])
            assert_close(got[key], ref,
                         OUT_RTOL if key == "out" else GRAD_RTOL,
                         f"{name} {key} at {got['coord']}")


def test_t5_forward_under_ring_matches_plain(sp_ranks, t5_ref):
    _, results = sp_ranks
    _, logits = t5_ref
    for res in results:
        got = res["t5_ring"]
        want = local_part(logits, got["coord"], got["sizes"], heads=False)
        assert_close(got["logits"], want, LOGIT_RTOL, f"at {got['coord']}")


def test_ulysses_refuses_bias_fn_toward_ring():
    case = _attn_case(0, dict(dp=1, sp=1), True, False)
    q = torch.from_numpy(case["q"])
    with pytest.raises(NotImplementedError, match="ring"):
        sequence.ulysses_attention(q, q, q, bias_fn=workers._table_fn(case))
    with sequence.sequence_parallel("sp", "ulysses"):
        with pytest.raises(NotImplementedError, match="ring"):
            attention(q, q, q, causal=True, bias_fn=workers._table_fn(case))


def test_dispatcher_materializes_bias_fn_unsharded():
    case = _attn_case(1, dict(dp=1), True, False, S=16)
    got = attention(*(torch.from_numpy(case[n]) for n in ("q", "k", "v")),
                    causal=True, scale=1.0, bias_fn=workers._table_fn(case))
    assert_close(got, _jax_attn(case)["out"], OUT_RTOL, "unsharded")


# -- tensor parallelism ------------------------------------------------------

RECIPE = ["--size", "tiny", "--device", "cpu", "--backend", "gloo",
          "--batch-size", "8", "--steps-per-epoch", "3", "--log-every", "1",
          "--eval-rows", "8", "--vocab", "64"]


def _tp_cfgs():
    kw = dict(dropout_rate=0.0, vocab_size=64)
    return (dataclasses.replace(jt5.T5Config.tiny(), **kw),
            dataclasses.replace(t5.T5Config.tiny(), **kw))


@pytest.fixture(scope="module")
def tp_ref():
    """JAX-initialised params and inputs, and JAX's own logits,
    ``generate_encdec`` tokens and loss gradients on them (f32)."""
    jcfg, cfg = _tp_cfgs()
    rng = np.random.default_rng(3)
    mask = np.ones((3, 9), bool)
    mask[2, 5:] = False
    labels = rng.integers(2, 64, (4, 6))
    batch = {"input_ids": rng.integers(2, 64, (4, 10)), "labels": labels,
             "label_mask": labels > 0, "input_mask": np.ones((4, 10), bool)}
    batch["label_mask"][2, 4:] = False
    batch["input_mask"][1, 7:] = False
    case = dict(cfg=cfg, seed=1, enc=rng.integers(2, 64, (3, 9)),
                dec=rng.integers(2, 64, (3, 5)), mask=mask, new=7,
                batch=batch)
    jmodel = jt5.T5ForConditionalGeneration(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with use_policy(F32):
        params = jax.device_get(jmodel.init(
            jax.random.key(4), jnp.zeros((1, 4), jnp.int32),
            jnp.zeros((1, 4), jnp.int32))["params"])
        logits = jax.jit(lambda p, e, d, m: jmodel.apply(
            {"params": p}, e, d, input_mask=m))(
            params, jnp.asarray(case["enc"]), jnp.asarray(case["dec"]),
            jnp.asarray(mask))
        tokens = jax.jit(lambda p, e, m: jt5.generate_encdec(
            jmodel, p, e, max_new_tokens=case["new"], input_mask=m,
            eos_id=-1))(params, jnp.asarray(case["enc"]), jnp.asarray(mask))
        loss_fn = jlosses.seq2seq_lm_loss_fn(jmodel)
        grads = jax.device_get(jax.jit(jax.grad(lambda p: loss_fn(
            p, None, jb, jax.random.key(0))[0]))(params))
    case["params"] = params
    want = {"logits": np.asarray(logits),
            "tokens": np.asarray(tokens).astype(np.int64),
            "grads": {k: v.numpy()
                      for k, v in t5_params_from_jax(grads, cfg).items()}}
    return case, want


@pytest.fixture(scope="module")
def tp_results(tp_ref):
    case, _ = tp_ref
    jobs = {tp: dict(case, argv=RECIPE + ["--tp", str(tp)],
                     mesh=dict(dp=1, tp=tp)) for tp in (1, 2)}
    want = torch_dp_workers.in_process(workers.tp_world, jobs[1])
    got = torch_dp_workers.spawn(workers.tp_world, 2, jobs[2])
    return want, got


def test_tp2_recipe_takes_world1_losses(tp_results):
    want, got = tp_results
    assert len(want["losses"]) == 3
    for res in got:
        assert_close(res["losses"], want["losses"], LOSS_RTOL, "losses")
        assert res["seq2seq"] == want["seq2seq"]


def test_tp2_shards_by_the_rules(tp_results):
    _, got = tp_results
    place = got[0]["placements"]
    for name, dim in (("encoder.layers.0.attn.q.weight", 0),
                      ("decoder.layers.1.cross_attn.v.weight", 0),
                      ("encoder.layers.0.ffn.wi.weight", 0),
                      ("decoder.layers.0.attn.o.weight", 1),
                      ("decoder.layers.0.ffn.wo.weight", 1),
                      ("shared.weight", 1),
                      ("encoder.rel_bias.weight", 1),
                      ("decoder.rel_bias.weight", 1)):
        assert place[name].get("tp") == f"S({dim})", (name, place[name])
    assert place["encoder.final_norm.weight"].get("tp", "R") == "R"


def test_tp2_generate_equals_world1(tp_results):
    want, got = tp_results
    for res in got:
        assert_close(res["logits"], want["logits"], LOGIT_RTOL, "logits")
        assert_equal(res["tokens"], want["tokens"], "greedy tokens")


def _ranks(tp_results, world):
    want, got = tp_results
    return [want] if world == 1 else got


@pytest.mark.parametrize("world", [1, 2])
def test_tp_logits_and_tokens_match_jax(tp_ref, tp_results, world):
    _, want = tp_ref
    for res in _ranks(tp_results, world):
        assert_close(res["logits"], want["logits"], LOGIT_RTOL,
                     f"logits at tp {world}")
        assert_equal(res["tokens"], want["tokens"],
                     f"greedy tokens at tp {world}")


@pytest.mark.parametrize("world", [1, 2])
def test_tp_loss_gradients_match_jax(tp_ref, tp_results, world):
    _, want = tp_ref
    for res in _ranks(tp_results, world):
        assert sorted(res["grads"]) == sorted(want["grads"])
        for name, g in want["grads"].items():
            assert_close(res["grads"][name], g, GRAD_RTOL,
                         f"grad {name} at tp {world}")
