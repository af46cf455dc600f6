"""The port's Mixtral (``models/mixtral.py``), its expert parallelism and
its recipe, held against the JAX package's tiny Mixtral in f32 on the
same numpy-seeded weights (every JAX leaf redrawn from a seed and carried
over by ``interop.mixtral_params_from_jax``):

* logits drop-free and at capacity 1.25 to 1e-5 of their largest
  magnitude; ``mixtral_params_to_jax`` returns the tree bit for bit;
* the chunked loss with ``moe_aux_weight`` and its gradients (loss 1e-5,
  the load loss 1e-6, gradients 1e-4 of their largest magnitude);
* three clip + AdamW steps at capacity 1.25 against the JAX recipe's
  jitted step: losses 1e-5, each leaf's update within 2e-2 of its norm
  (Adam steps rounding noise by up to lr in either framework);
* KV-cache decode (prefill, then a token at a time) against a full
  forward, drop-free, to 1e-5; the paged engine's greedy streams against
  JAX ``generate``, a flip allowed only at a near-tie (1e-4);
* a port checkpoint restores in the JAX package, every leaf bitwise;
* the recipe at smoke size (exact match of the greedy successor chain),
  its refusal of ``--tp`` with the closing ``generate``, and the mesh's
  ``ep`` axis in the JAX order.

Expert parallelism over gloo is ``tests/test_torch_moe_ep.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_tpu.generation import generate as jax_generate
from pytorch_distributed_tpu.models import mixtral as jmixtral
from pytorch_distributed_tpu.runtime.mesh import MeshSpec as JaxMeshSpec
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu.train import TrainState as JaxTrainState
from pytorch_distributed_tpu.train import build_train_step as jax_step
from pytorch_distributed_tpu.train import causal_lm_loss_fn as jax_loss_fn
from pytorch_distributed_tpu.train.checkpoint import (
    _leaf_files,
    restore_checkpoint as jax_restore_checkpoint,
)
from pytorch_distributed_tpu_torch import optim
from pytorch_distributed_tpu_torch.generation import decode_step_body, prefill
from pytorch_distributed_tpu_torch.interop import (
    mixtral_params_from_jax,
    mixtral_params_to_jax,
)
from pytorch_distributed_tpu_torch.models.mixtral import (
    MixtralConfig,
    MixtralForCausalLM,
)
from pytorch_distributed_tpu_torch.recipes import mixtral_moe
from pytorch_distributed_tpu_torch.runtime.mesh import MeshSpec
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.serve import (
    EngineConfig,
    Request,
    RequestStatus,
    ServeEngine,
)
from pytorch_distributed_tpu_torch.train import (
    TrainState,
    build_train_step,
    causal_lm_loss_fn,
    save_checkpoint,
)
from tests.torch_parity import assert_close

F32 = JaxPolicy(compute_dtype=jnp.float32)
RTOL, AUX_RTOL, GRAD_RTOL, FLIP_RTOL = 1e-5, 1e-6, 1e-4, 1e-4
CHUNK, LR, AUX = 100, 1e-3, 0.01
CAPS = {"dropfree": None, "cf1.25": 1.25}


def _jcfg(cf):
    return dataclasses.replace(jmixtral.MixtralConfig.tiny(),
                               capacity_factor=cf)


def _cfg(cf):
    return dataclasses.replace(MixtralConfig.tiny(), capacity_factor=cf)


@pytest.fixture(scope="module")
def params():
    jmodel = jmixtral.MixtralForCausalLM(_jcfg(None))
    with use_policy(F32):
        shapes = jax.eval_shape(lambda: jmodel.init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    rng = np.random.default_rng(11)

    def one(path, x):
        draw = rng.normal(size=x.shape) * 0.08
        if path[-1].key == "scale":
            draw = 1.0 + draw
        return draw.astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


def _port(params, cf, **kw):
    cfg = dataclasses.replace(_cfg(cf), **kw)
    model = MixtralForCausalLM(cfg, device="cpu", policy=Policy.full())
    model.load_state_dict(mixtral_params_from_jax(params, cfg))
    return model


def _ids(seed, B=4, S=16, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat(v, key) if isinstance(v, dict) else
                   {key: np.asarray(v)})
    return out


@pytest.mark.parametrize("cap", sorted(CAPS))
def test_logits_match_jax_and_the_tree_round_trips(params, cap):
    cf = CAPS[cap]
    jmodel = jmixtral.MixtralForCausalLM(_jcfg(cf))
    ids = _ids(1)
    with use_policy(F32):
        ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))
    model = _port(params, cf)
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long())
    assert_close(out, ref, RTOL, "logits")
    back = _flat(mixtral_params_to_jax(model.state_dict(), model.config))
    want = _flat(params)
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_chunked_loss_with_aux_and_grads_match_jax(params):
    cf = 1.25
    jmodel = jmixtral.MixtralForCausalLM(_jcfg(cf))
    ids = _ids(2)
    jfn = jax_loss_fn(jmodel, moe_aux_weight=AUX, vocab_chunk_size=CHUNK)
    with use_policy(F32):
        (want, jaux), grads = jax.value_and_grad(
            lambda p: jfn(p, None, {"input_ids": jnp.asarray(ids)},
                          jax.random.key(0)), has_aux=True)(params)
    model = _port(params, cf)
    loss, aux = causal_lm_loss_fn(model, moe_aux_weight=AUX,
                                  vocab_chunk_size=CHUNK)(
        {"input_ids": torch.from_numpy(ids).long()}, None)
    loss.backward()
    assert_close(loss.item(), float(want), RTOL, "loss")
    assert_close(aux["metrics"]["moe_aux_loss"].item(),
                 float(jaux["metrics"]["moe_aux_loss"]), AUX_RTOL, "aux")
    got = _flat(mixtral_params_to_jax(
        {n: p.grad for n, p in model.named_parameters()}, model.config))
    jgrads = _flat(jax.device_get(grads))
    for k, v in got.items():
        assert_close(v, jgrads[k], GRAD_RTOL, k)


def test_three_steps_match_the_jax_recipe_step(params):
    cf = 1.25
    jmodel = jmixtral.MixtralForCausalLM(_jcfg(cf))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR))
    jstate = JaxTrainState.create(apply_fn=jmodel.apply, params=params,
                                  tx=tx)
    jstep = jax.jit(jax_step(jax_loss_fn(jmodel, moe_aux_weight=AUX)))
    model = _port(params, cf)
    opt = optim.clip_grad_norm(optim.AdamW(
        model, lr=LR, weight_decay=mixtral_moe.ADAMW_WEIGHT_DECAY), 1.0)
    state = TrainState(model, opt, policy=Policy.full())
    step = build_train_step(causal_lm_loss_fn(model, moe_aux_weight=AUX))
    for i in range(3):
        ids = _ids(20 + i)
        with use_policy(F32):
            jstate, jm = jstep(jstate, {"input_ids": jnp.asarray(ids)})
        before = _flat(mixtral_params_to_jax(model.state_dict(),
                                             model.config))
        state, m = step(state, {"input_ids": torch.from_numpy(ids).long()})
        assert_close(float(m["loss"]), float(jm["loss"]), RTOL, f"loss {i}")
        assert_close(float(m["moe_aux_loss"]), float(jm["moe_aux_loss"]),
                     AUX_RTOL, f"aux {i}")
        got = _flat(mixtral_params_to_jax(model.state_dict(), model.config))
        want = _flat(jax.device_get(jstate.params))
        for k, v in got.items():
            ref = want[k].astype(np.float64) - before[k]
            err = np.linalg.norm(v - before[k] - ref)
            assert err <= 2e-2 * np.linalg.norm(ref), (k, i, err)


def test_cached_decode_matches_a_full_forward(params):
    model = _port(params, None)
    ids = torch.from_numpy(_ids(3, B=2, S=14)).long()
    P, total = 9, 14
    with torch.no_grad():
        full = model(ids)
        logits, cache = prefill(model, ids[:, :P], total)
        assert_close(logits, full[:, :P], RTOL, "prefill")
        for t in range(P, total):
            step, cache = decode_step_body(
                model, cache, ids[:, t], cache_len=total,
                positions=torch.full((2, 1), t),
                write_pos=torch.full((2,), t, dtype=torch.int32))
            assert_close(step, full[:, t], RTOL, f"decode step {t}")


def test_paged_engine_greedy_matches_jax_generate(params):
    jmodel = jmixtral.MixtralForCausalLM(_jcfg(None))
    model = _port(params, None)
    prompts = _ids(4, B=3, S=10)
    new = 7
    with use_policy(F32):
        ref = np.asarray(jax_generate(jmodel, params, jnp.asarray(prompts),
                                      max_new_tokens=new))[:, 10:]
    engine = ServeEngine(model, EngineConfig(num_slots=2, max_len=32,
                                             prefill_chunk=8, page_size=8),
                         device="cpu")
    handles = [engine.submit(Request(p, new)) for p in prompts]
    engine.run_until_drained()
    for i, h in enumerate(handles):
        assert h.status is RequestStatus.COMPLETED
        if h.tokens == ref[i].tolist():
            continue
        j = next(k for k in range(new) if h.tokens[k] != ref[i, k])
        seq = np.concatenate([prompts[i], ref[i, :j]])[None]
        with use_policy(F32):
            lg = np.asarray(jmodel.apply({"params": params},
                                         jnp.asarray(seq, jnp.int32)))[0, -1]
        top2 = np.sort(lg)[-2:]
        assert top2[1] - top2[0] < FLIP_RTOL * np.abs(lg).max(), (i, j)


def test_port_checkpoint_restores_in_jax(params, tmp_path):
    jmodel = jmixtral.MixtralForCausalLM(_jcfg(1.25))
    model = _port(params, 1.25)
    opt = optim.AdamW(model, lr=1e-3, weight_decay=1e-4)
    state = TrainState(model, opt, policy=Policy.full())
    step = build_train_step(causal_lm_loss_fn(model, moe_aux_weight=AUX))
    state, _ = step(state, {"input_ids": torch.from_numpy(_ids(5)).long()})
    save_checkpoint(str(tmp_path), state)
    template = JaxTrainState.create(apply_fn=jmodel.apply, params=params,
                                    tx=optax.adamw(1e-3))
    restored = jax_restore_checkpoint(str(tmp_path), template)
    got = {k: np.asarray(v) for k, v in _leaf_files(restored)}
    want = {"step": 1, "opt_state_0_count": 1}
    moments = {key: {n: opt.state[p][key] for n, p in
                     model.named_parameters()}
               for key in ("exp_avg", "exp_avg_sq")}
    for prefix, sd in (("params", model.state_dict()),
                       ("opt_state_0_mu", moments["exp_avg"]),
                       ("opt_state_0_nu", moments["exp_avg_sq"])):
        for k, v in _flat(mixtral_params_to_jax(sd, model.config)).items():
            want[f"{prefix}_{k.replace('/', '_')}"] = v
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def test_mesh_ep_axis_follows_the_jax_order():
    for spec in (dict(ep=2), dict(dp=2, ep=4), dict(ep=2, tp=2),
                 dict(dp=-1, ep=2, sp=1, tp=2)):
        want = JaxMeshSpec(**spec).resolve(8)
        got = MeshSpec(**spec).resolve(8)
        assert got.sizes() == want.sizes(), spec
    spec = MeshSpec(dp=2, ep=2, tp=2).resolve(8)
    shape, names = spec.mesh_shape()
    assert names == ("dp", "fsdp", "ep", "sp", "tp")
    # rank r's coordinate: JAX device r's in (dp, fsdp, pp, ep, sp, tp)
    coords = np.arange(8).reshape(shape)
    jax_coords = np.arange(8).reshape(JaxMeshSpec(dp=2, ep=2, tp=2)
                                      .resolve(8).sizes())
    for r in range(8):
        got = [int(i[0]) for i in np.nonzero(coords == r)]
        want = [int(i[0]) for i in np.nonzero(jax_coords == r)]
        # the JAX coordinate without pp (want[2], 1 on this mesh)
        assert got == want[:2] + want[3:], r
    # with pp in the mesh, all six axes, in the JAX order
    spec = MeshSpec(dp=-1, pp=2, ep=2).resolve(8)
    shape, names = spec.mesh_shape()
    assert names == ("dp", "fsdp", "pp", "ep", "sp", "tp")
    jax_spec = JaxMeshSpec(dp=-1, pp=2, ep=2).resolve(8)
    assert spec.sizes() == jax_spec.sizes()
    coords = np.arange(8).reshape(shape)
    jax_coords = np.arange(8).reshape(jax_spec.sizes())
    for r in range(8):
        assert ([int(i[0]) for i in np.nonzero(coords == r)]
                == [int(i[0]) for i in np.nonzero(jax_coords == r)]), r


# -- the recipe -------------------------------------------------------------


def test_recipe_learns_the_successor_chain_on_the_cpu():
    trainer = mixtral_moe.main(["--device", "cpu", "--epochs", "2",
                                "--steps-per-epoch", "5", "--log-every",
                                "5"])
    losses = [r["loss"] for r in trainer.history]
    assert losses[-1] < losses[0]
    assert all("moe_aux_loss" in r for r in trainer.history)
    assert trainer.successor["exact_match"] >= 0.5, trainer.successor
    # drop-free training and the chunked loss take the same path
    trainer = mixtral_moe.main(["--device", "cpu", "--steps-per-epoch", "2",
                                "--capacity-factor", "0", "--vocab-chunk",
                                "16", "--eval-rows", "4", "--log-every",
                                "1"])
    assert np.isfinite(trainer.history[-1]["loss"])
    # --tp decodes on the sharded model (tests/test_torch_tp_generate.py);
    # a world of one cannot hold tp 2
    with pytest.raises(ValueError, match="not divisible"):
        mixtral_moe.main(["--device", "cpu", "--tp", "2"])
