"""The Llama-body families of the port (Gemma, Mistral, Qwen2, Qwen3,
Phi-3 and the tied Llama-3.2) held against the JAX package's, at their
``tiny()`` configs (the tied Llama-3.2 as Llama's ``tiny()`` with
``llama3_2_1b``'s tie and rope scaling).

Every JAX leaf is redrawn with numpy from a seed (the q/k/v biases, the
zero-centred Gemma norms and the Qwen3 q/k norms then differ from their
inits), carried to the port by ``interop.llama_params_from_jax``, and
both sides compute in f32:

* logits agree to 1e-5 of their largest magnitude (sums in another
  order; cos/sin differ by an ulp);
* the port's KV-cache decode (prefill, then one token at a time) gives
  the logits of a full forward over the same tokens, to 1e-5;
* the paged engine's greedy streams equal JAX ``generate``'s, a flip
  allowed only at a near-tie (1e-4) of the reference's logits;
* ``llama_params_to_jax`` returns the JAX tree bit for bit;
* a checkpoint the port writes restores in the JAX package, every leaf
  bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_tpu.generation import generate as jax_generate
from pytorch_distributed_tpu.models import gemma as jgemma
from pytorch_distributed_tpu.models import llama as jllama
from pytorch_distributed_tpu.models import mistral as jmistral
from pytorch_distributed_tpu.models import neox as jneox
from pytorch_distributed_tpu.models import phi3 as jphi3
from pytorch_distributed_tpu.models import qwen2 as jqwen2
from pytorch_distributed_tpu.models import qwen3 as jqwen3
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu.train import TrainState as JaxTrainState
from pytorch_distributed_tpu.train.checkpoint import (
    _leaf_files,
    restore_checkpoint as jax_restore_checkpoint,
)
from pytorch_distributed_tpu_torch import optim
from pytorch_distributed_tpu_torch.generation import decode_step_body, prefill
from pytorch_distributed_tpu_torch.interop import (
    llama_params_from_jax,
    llama_params_to_jax,
)
from pytorch_distributed_tpu_torch.models import (
    GemmaConfig,
    GemmaForCausalLM,
    LlamaConfig,
    LlamaForCausalLM,
    MistralConfig,
    MistralForCausalLM,
    NeoXConfig,
    Phi3Config,
    Phi3ForCausalLM,
    Qwen2Config,
    Qwen2ForCausalLM,
    Qwen3Config,
    Qwen3ForCausalLM,
)
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.serve import (
    EngineConfig,
    Request,
    RequestStatus,
    ServeEngine,
)
from pytorch_distributed_tpu_torch.train import TrainState, save_checkpoint

RTOL = 1e-5
FLIP_RTOL = 1e-4
F32 = JaxPolicy(compute_dtype=jnp.float32)


def _tied_llama(config_cls):
    """Llama's ``tiny()`` with ``llama3_2_1b``'s tie and rope scaling."""
    return dataclasses.replace(
        config_cls.tiny(), tie_word_embeddings=True,
        rope_scaling=config_cls.llama3_2_1b().rope_scaling)


# family: (JAX config, JAX model class, port config, port model class)
FAMILIES = {
    "gemma": (jgemma.GemmaConfig.tiny(), jgemma.GemmaForCausalLM,
              GemmaConfig.tiny(), GemmaForCausalLM),
    "mistral": (jmistral.MistralConfig.tiny(), jmistral.MistralForCausalLM,
                MistralConfig.tiny(), MistralForCausalLM),
    "qwen2": (jqwen2.Qwen2Config.tiny(), jqwen2.Qwen2ForCausalLM,
              Qwen2Config.tiny(), Qwen2ForCausalLM),
    "qwen3": (jqwen3.Qwen3Config.tiny(), jqwen3.Qwen3ForCausalLM,
              Qwen3Config.tiny(), Qwen3ForCausalLM),
    "phi3": (jphi3.Phi3Config.tiny(), jphi3.Phi3ForCausalLM,
             Phi3Config.tiny(), Phi3ForCausalLM),
    "llama3_2_1b": (_tied_llama(jllama.LlamaConfig), jllama.LlamaForCausalLM,
                    _tied_llama(LlamaConfig), LlamaForCausalLM),
}


def redraw(params, seed, offset_norms):
    """Every leaf drawn anew from ``seed``: scales about one (about zero
    with Gemma's offset norms), everything else 0.08 x normal."""
    rng = np.random.default_rng(seed)

    def one(path, x):
        draw = rng.normal(size=x.shape) * 0.08
        if path[-1].key == "scale" and not offset_norms:
            draw = 1.0 + draw
        return draw.astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, params)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(name, JAX model, its params, the port model on the same weights,
    the port config)."""
    jcfg, jcls, cfg, cls = FAMILIES[request.param]
    jmodel = jcls(jcfg)
    with use_policy(F32):   # shapes only: every leaf is redrawn
        shapes = jax.eval_shape(lambda: jmodel.init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    params = redraw(shapes, sum(map(ord, request.param)), cfg.rms_offset)
    model = cls(cfg, device="cpu", policy=Policy.full())
    model.load_state_dict(llama_params_from_jax(params, cfg))
    return request.param, jmodel, params, model, cfg


def _close(out, ref, what, rtol=RTOL):
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rtol * np.abs(ref).max(), err_msg=what)


def test_published_configs_match_jax():
    """Every published classmethod builds the JAX config's geometry (the
    port's fields are a subset: no scan or mesh settings)."""
    pairs = [
        (GemmaConfig.gemma_2b(), jgemma.GemmaConfig.gemma_2b()),
        (GemmaConfig.gemma_7b(), jgemma.GemmaConfig.gemma_7b()),
        (MistralConfig.mistral_7b(), jmistral.MistralConfig.mistral_7b()),
        (Qwen2Config.qwen2_7b(), jqwen2.Qwen2Config.qwen2_7b()),
        (Qwen3Config.qwen3_8b(), jqwen3.Qwen3Config.qwen3_8b()),
        (Phi3Config.phi3_mini(), jphi3.Phi3Config.phi3_mini()),
        (LlamaConfig.llama3_2_1b(), jllama.LlamaConfig.llama3_2_1b()),
        (NeoXConfig.pythia_1b(), jneox.NeoXConfig.pythia_1b()),
    ]
    for port, ref in pairs:
        mine = dataclasses.asdict(port)
        theirs = dataclasses.asdict(ref)
        assert mine == {k: theirs[k] for k in mine}, type(port).__name__
        assert port.head_dim == ref.head_dim
    assert GemmaConfig.gemma_2b().head_dim == 256
    assert Phi3Config.phi3_mini().head_dim == 96
    with pytest.raises(ValueError, match="hidden_act"):
        LlamaConfig(hidden_act="relu")


def test_logits_match_jax(family):
    name, jmodel, params, model, cfg = family
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 20))
    with use_policy(F32):
        ref = jmodel.apply({"params": params}, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        out = model(torch.from_numpy(ids))
    assert out.shape == (2, 20, cfg.vocab_size)
    _close(out, ref, name)


def test_cached_decode_matches_recompute(family):
    name, _, _, model, cfg = family
    ids = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 14)))
    P, total = 9, 14
    with torch.no_grad():
        full = model(ids)
        logits, cache = prefill(model, ids[:, :P], total)
        _close(logits, full[:, :P], f"{name} prefill")
        for t in range(P, total):
            pos = torch.full((2, 1), t)
            step, cache = decode_step_body(
                model, cache, ids[:, t], cache_len=total, positions=pos,
                write_pos=torch.full((2,), t, dtype=torch.int32))
            _close(step, full[:, t], f"{name} decode step {t}")


def test_paged_engine_greedy_matches_jax_generate(family):
    """Three greedy requests over two slots (a slot reused) through the
    paged engine against one batched JAX ``generate``; Mistral's tiny
    window (8) binds inside the rows."""
    name, jmodel, params, model, cfg = family
    rng = np.random.default_rng(3)
    P, new = 10, 7
    prompts = rng.integers(1, cfg.vocab_size, size=(3, P)).astype(np.int32)
    with use_policy(F32):
        ref = np.asarray(jax_generate(jmodel, params, jnp.asarray(prompts),
                                      max_new_tokens=new))[:, P:]
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
        assert top2[1] - top2[0] < FLIP_RTOL * np.abs(lg).max(), (name, i, j)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat(v, key) if isinstance(v, dict) else
                   {key: np.asarray(v)})
    return out


def test_to_jax_round_trip_is_bitwise(family):
    name, _, params, model, cfg = family
    back = _flat(llama_params_to_jax(model.state_dict(), cfg))
    want = _flat(jax.device_get(params))
    assert sorted(back) == sorted(want), name
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    again = llama_params_from_jax(llama_params_to_jax(model.state_dict(),
                                                      cfg), cfg)
    for k, t in model.state_dict().items():
        assert torch.equal(again[k], t), k
    if cfg.tie_word_embeddings:
        assert model.lm_head is None and "lm_head" not in back
        assert not any(k.startswith("lm_head") for k in model.state_dict())


def test_port_checkpoint_restores_in_jax(family, tmp_path):
    """One AdamW step in the port, saved; the JAX package's restore into
    its family model's TrainState gives every leaf (params, both moments,
    the counts) bit for bit."""
    name, jmodel, params, _, cfg = family
    model = type(family[3])(cfg, device="cpu", policy=Policy.full())
    model.load_state_dict(llama_params_from_jax(params, cfg))
    opt = optim.AdamW(model, lr=1e-3, weight_decay=1e-4)
    ids = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12)))
    loss = torch.nn.functional.cross_entropy(
        model(ids[:, :-1]).reshape(-1, cfg.vocab_size), ids[:, 1:].reshape(-1))
    loss.backward()
    opt.step()
    state = TrainState(model, opt, policy=Policy.full())
    state.step = 1
    save_checkpoint(str(tmp_path), state)
    template = JaxTrainState.create(apply_fn=jmodel.apply, params=params,
                                    tx=optax.adamw(1e-3))
    restored = jax_restore_checkpoint(str(tmp_path), template)
    got = {k: np.asarray(v) for k, v in _leaf_files(restored)}
    moments = {key: {n: opt.state[p][key]
                     for n, p in model.named_parameters()}
               for key in ("exp_avg", "exp_avg_sq")}
    want = {"step": 1, "opt_state_0_count": 1}
    for prefix, sd in (("params", model.state_dict()),
                       ("opt_state_0_mu", moments["exp_avg"]),
                       ("opt_state_0_nu", moments["exp_avg_sq"])):
        for k, v in _flat(llama_params_to_jax(sd, cfg)).items():
            want[f"{prefix}_{k.replace('/', '_')}"] = v
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
