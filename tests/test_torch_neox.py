"""The port's GPT-NeoX (``models/neox.py``) held against the JAX
package's at ``NeoXConfig.tiny()`` (rotary on half of each head), with
the parallel and the sequential residual.

Every JAX leaf is redrawn with numpy from a seed and carried to the port
by ``interop.neox_params_from_jax``; both sides compute in f32:

* logits agree to 1e-5 of their largest magnitude (sums in another
  order);
* greedy ``generate`` on the dense KV cache equals JAX ``generate``'s
  tokens, a flip allowed only at a near-tie (1e-4) of the reference's
  logits;
* ``neox_params_to_jax`` returns the JAX tree bit for bit, and a
  checkpoint the port writes restores in the JAX package bitwise;
* a paged view raises (the JAX NeoX has no paged form either).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_tpu.generation import generate as jax_generate
from pytorch_distributed_tpu.models.neox import (
    NeoXConfig as JaxNeoXConfig,
    NeoXForCausalLM as JaxNeoX,
)
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu.train import TrainState as JaxTrainState
from pytorch_distributed_tpu.train.checkpoint import (
    _leaf_files,
    restore_checkpoint as jax_restore_checkpoint,
)
from pytorch_distributed_tpu_torch import optim
from pytorch_distributed_tpu_torch.generation import generate
from pytorch_distributed_tpu_torch.interop import (
    model_slots,
    neox_params_from_jax,
    neox_params_to_jax,
)
from pytorch_distributed_tpu_torch.models.neox import (
    NeoXConfig,
    NeoXForCausalLM,
)
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.train import TrainState, save_checkpoint

RTOL = 1e-5
FLIP_RTOL = 1e-4
F32 = JaxPolicy(compute_dtype=jnp.float32)


@pytest.fixture(scope="module", params=[True, False],
                ids=["parallel", "sequential"])
def pair(request):
    jcfg = dataclasses.replace(JaxNeoXConfig.tiny(),
                               use_parallel_residual=request.param)
    cfg = dataclasses.replace(NeoXConfig.tiny(),
                              use_parallel_residual=request.param)
    jmodel = JaxNeoX(jcfg)
    with use_policy(F32):   # shapes only: every leaf is redrawn
        shapes = jax.eval_shape(lambda: jmodel.init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    rng = np.random.default_rng(7 + request.param)

    def one(path, x):
        draw = rng.normal(size=x.shape) * 0.08
        if path[-1].key == "scale":
            draw = 1.0 + draw
        return draw.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(one, shapes)
    model = NeoXForCausalLM(cfg, device="cpu", policy=Policy.full())
    model.load_state_dict(neox_params_from_jax(params, cfg))
    return jmodel, params, model, cfg


def _close(out, ref, what):
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=RTOL * np.abs(ref).max(), err_msg=what)


def test_logits_match_jax(pair):
    jmodel, params, model, cfg = pair
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 20))
    with use_policy(F32):
        ref = jmodel.apply({"params": params}, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        out = model(torch.from_numpy(ids))
    _close(out, ref, "logits")


def test_greedy_generate_matches_jax(pair):
    jmodel, params, model, cfg = pair
    P, new = 9, 8
    prompts = np.random.default_rng(2).integers(
        1, cfg.vocab_size, (3, P)).astype(np.int32)
    with use_policy(F32):
        ref = np.asarray(jax_generate(jmodel, params, jnp.asarray(prompts),
                                      max_new_tokens=new))[:, P:]
    out = generate(model, torch.from_numpy(prompts).long(),
                   max_new_tokens=new, device="cpu")[:, P:].numpy()
    for i in range(3):
        if out[i].tolist() == ref[i].tolist():
            continue
        j = next(k for k in range(new) if out[i, k] != ref[i, k])
        seq = np.concatenate([prompts[i], ref[i, :j]])[None]
        with use_policy(F32):
            lg = np.asarray(jmodel.apply({"params": params},
                                         jnp.asarray(seq, jnp.int32)))[0, -1]
        top2 = np.sort(lg)[-2:]
        assert top2[1] - top2[0] < FLIP_RTOL * np.abs(lg).max(), (i, j)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}_{k}" if prefix else str(k)
        out.update(_flat(v, key) if isinstance(v, dict) else
                   {key: np.asarray(v)})
    return out


def test_to_jax_round_trip_and_checkpoint(pair, tmp_path):
    jmodel, params, model, cfg = pair
    want = _flat(jax.device_get(params))
    back = _flat(neox_params_to_jax(model.state_dict(), cfg))
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    assert set(model_slots(model)) == set(model.state_dict())
    # a port checkpoint (untrained: AdamW's moments read as zeros) in the
    # JAX package
    opt = optim.AdamW(model, lr=1e-3)
    save_checkpoint(str(tmp_path), TrainState(model, opt,
                                              policy=Policy.full()))
    template = JaxTrainState.create(apply_fn=jmodel.apply, params=params,
                                    tx=optax.adamw(1e-3))
    got = {k: np.asarray(v) for k, v in _leaf_files(
        jax_restore_checkpoint(str(tmp_path), template))}
    for k, v in want.items():
        np.testing.assert_array_equal(got[f"params_{k}"], v, err_msg=k)
        assert not got[f"opt_state_0_mu_{k}"].any()


def test_paged_view_raises(pair):
    _, _, model, _ = pair
    with pytest.raises(NotImplementedError, match="paged"):
        model(torch.zeros(1, 1, dtype=torch.long),
              torch.zeros(1, 1, dtype=torch.long), decode=True,
              write_pos=torch.zeros(1, dtype=torch.int32), paged=object())
