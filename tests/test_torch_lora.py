"""The port's LoRA (``lora.py``) held against the JAX package's on the same
base weights and adapters.

Adapters are drawn by the JAX ``lora_init`` (with ``b`` redrawn from a
numpy seed, so every delta is non-zero) and carried across by
``interop.lora_params_from_jax``; both sides compute in f32. Limits:

* ``lora_merge`` agrees with JAX's to ``RTOL`` = 1e-6 of each merged
  leaf's largest magnitude (an f32 ``a @ b`` over the rank, summed in
  another order);
* with fresh adapters (``b`` zero) the output equals the base to the bit;
* logits through ``LoRAModel`` agree with the JAX ``LoRAModel`` to 1e-5,
  the forward's own limit, and the adapter gradients with JAX's
  gradients of the adapter tree to ``RTOL_GRAD`` = 1e-4 of each leaf's
  largest magnitude (a backward through the whole model); the base gets
  no gradient;
* QLoRA (an int8 or int4 base) matches the JAX ``LoRAModel`` over the
  JAX quantized tree to the same limits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu import lora as jlora
from pytorch_distributed_tpu.models import bert as jbert
from pytorch_distributed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from pytorch_distributed_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from pytorch_distributed_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlama,
)
from pytorch_distributed_tpu.ops import quant as jquant
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu_torch import interop, lora
from pytorch_distributed_tpu_torch.generation import generate
from pytorch_distributed_tpu_torch.models import bert
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from pytorch_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
)
from pytorch_distributed_tpu_torch.ops import quant
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from torch_parity import assert_close, assert_equal

RTOL = 1e-6
RTOL_FWD = 1e-5
RTOL_GRAD = 1e-4
F32 = JaxPolicy(compute_dtype=jnp.float32)
RANK = 4


def _family(name):
    """(JAX model, params, port() -> a fresh port model on those weights,
    the port's state_dict -> JAX params)."""
    if name == "gpt2":
        jmodel, cfg = JaxGPT2(JaxGPT2Config.tiny()), GPT2Config.tiny()
        to_port, to_jax = interop.gpt2_params_from_jax, \
            interop.gpt2_params_to_jax
        make = lambda: GPT2LMHead(cfg, device="cpu",  # noqa: E731
                                  policy=Policy.full())
    elif name == "llama":
        jmodel, cfg = JaxLlama(JaxLlamaConfig.tiny()), LlamaConfig.tiny()
        to_port, to_jax = interop.llama_params_from_jax, \
            interop.llama_params_to_jax
        make = lambda: LlamaForCausalLM(cfg, device="cpu",  # noqa: E731
                                        policy=Policy.full())
    else:
        cfg = dataclasses.replace(bert.BertConfig.tiny(), dropout_rate=0.0)
        jmodel = jbert.BertForSequenceClassification(
            dataclasses.replace(jbert.BertConfig.tiny(), dropout_rate=0.0))
        to_port, to_jax = interop.bert_params_from_jax, \
            interop.bert_params_to_jax
        make = lambda: bert.BertForSequenceClassification(  # noqa: E731
            cfg, device="cpu", policy=Policy.full())
    with use_policy(F32):
        params = jax.device_get(jmodel.init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])

    def port():
        m = make()
        m.load_state_dict(to_port(params, cfg))
        return m
    return jmodel, params, port, lambda sd: to_jax(sd, cfg)


@pytest.fixture(scope="module", params=["bert", "gpt2", "llama"])
def family(request):
    jmodel, params, port, to_jax = _family(request.param)
    adapters = jlora.lora_init(jax.random.key(1), params, rank=RANK)
    rng = np.random.default_rng(2)
    adapters = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.05, x.shape).astype(
            np.float32), jax.device_get(adapters))
    return request.param, jmodel, params, port, to_jax, adapters


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: np.asarray(v)})
    return out


def _ids(name):
    return np.random.default_rng(3).integers(1, 100, size=(2, 10))


def test_adapters_round_trip_and_count(family):
    _, _, params, port, _, adapters = family
    model = port()
    pa = interop.lora_params_from_jax(adapters, model)
    back = _flat(interop.lora_params_to_jax(pa, model))
    want = _flat(adapters)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], k)
    assert lora.lora_param_count(pa) == jlora.lora_param_count(adapters)
    # the port's own init draws the JAX shapes
    fresh = lora.lora_init(torch.Generator().manual_seed(0), model, RANK)
    init = _flat(interop.lora_params_to_jax(fresh, model))
    assert {k: v.shape for k, v in init.items()} == {
        k: v.shape for k, v in want.items()}
    assert all(not v.any() for k, v in init.items() if k.endswith("/b"))


def test_merge_matches_jax(family):
    _, _, params, port, to_jax, adapters = family
    model = port()
    merged = lora.lora_merge(model, interop.lora_params_from_jax(adapters,
                                                                 model))
    got = _flat(to_jax(merged))
    want = _flat(jax.device_get(jlora.lora_merge(params, adapters)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert_close(got[k], want[k], RTOL, k)


def test_identity_at_init(family):
    name, _, _, port, _, _ = family
    model = port()
    ids = torch.from_numpy(_ids(name))
    with torch.no_grad():
        base = model(ids)
        wrapped = lora.LoRAModel(model, rank=RANK,
                                 generator=torch.Generator().manual_seed(5))
        assert torch.equal(wrapped(ids), base)


def _jax_loss_and_grads(jmodel, base, adapters, ids, cot):
    wrapped = jlora.LoRAModel(jmodel, base)

    def loss(ad):
        out = wrapped.apply({"params": ad}, jnp.asarray(ids, jnp.int32))
        return jnp.sum(out * cot)

    with use_policy(F32):
        out = wrapped.apply({"params": adapters}, jnp.asarray(ids, jnp.int32))
        grads = jax.grad(loss)(adapters)
    return np.asarray(out), _flat(jax.device_get(grads))


def _port_out_and_grads(wrapped, model, ids, cot):
    out = wrapped(torch.from_numpy(ids))
    (out * torch.from_numpy(cot)).sum().backward()
    grads = {n: {"a": ab["a"].grad, "b": ab["b"].grad}
             for n, ab in wrapped.adapters().items()}
    return out.detach(), _flat(interop.lora_params_to_jax(grads, model))


@pytest.mark.parametrize("base_kind", ["float", "int8", "int4"])
def test_forward_and_adapter_grads_match_jax(family, base_kind):
    name, jmodel, params, port, _, adapters = family
    ids = _ids(name)
    model = port()
    base, jbase = model, params
    if base_kind != "float":
        quantizer = f"quantize_tree_{base_kind}"
        jbase = getattr(jquant, quantizer)(params, include=(r"kernel$",))
        base = quant.QuantizedModel(
            model, getattr(quant, quantizer)(model, include=(r"kernel$",)))
    with use_policy(F32):
        shape = np.asarray(jmodel.apply({"params": params},
                                        jnp.asarray(ids, jnp.int32))).shape
    cot = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    ref, jgrads = _jax_loss_and_grads(jmodel, jbase, adapters, ids, cot)
    wrapped = lora.LoRAModel(base, interop.lora_params_from_jax(adapters,
                                                                model))
    out, grads = _port_out_and_grads(wrapped, model, ids, cot)
    assert_close(out, ref, RTOL_FWD, f"{name} {base_kind} logits")
    assert sorted(grads) == sorted(jgrads)
    for k in jgrads:
        assert_close(grads[k], jgrads[k], RTOL_GRAD, f"grad {k}")
    # the base is frozen: no gradient, and only adapters require one
    frozen = [p for p in model.parameters() if not p.requires_grad]
    assert frozen and all(p.grad is None for p in frozen)
    trainable = [n for n, p in wrapped.named_parameters() if p.requires_grad]
    assert len(trainable) == 2 * len(wrapped.adapters())
    assert all(n.endswith((".a", ".b")) for n in trainable)


def test_generate_through_lora_equals_the_merged_model():
    _, params, port, _ = _family("gpt2")
    model = port()
    ad = lora.lora_init(torch.Generator().manual_seed(1), model, RANK)
    for ab in ad.values():
        ab["b"].normal_(0, 0.05, generator=torch.Generator().manual_seed(2))
    merged = lora.lora_merge(model, ad)
    plain = port()
    plain.load_state_dict(merged)
    ids = torch.from_numpy(_ids("gpt2"))
    wrapped = lora.LoRAModel(model, ad)
    assert_equal(generate(wrapped, ids, max_new_tokens=6, device="cpu"),
                 generate(plain, ids, max_new_tokens=6, device="cpu"),
                 "lora generate")


def test_refusals():
    _, params, port, _ = _family("gpt2")
    model = port()
    with pytest.raises(ValueError, match="rank"):
        lora.lora_init(torch.Generator(), model, 0)
    with pytest.raises(ValueError, match="no kernel matched"):
        lora.lora_init(torch.Generator(), model, 2, targets={"nothing": 1})
    with pytest.raises(ValueError, match="found no weight"):
        lora.lora_merge(model, {"blocks.9.attn_qkv.weight": {
            "a": torch.zeros(64, 2), "b": torch.zeros(2, 192)}})
    with pytest.raises(NotImplementedError, match="A8"):
        interop.lora_params_from_jax(
            {"blocks": {"block": {"attn_qkv": {"kernel": {
                "a": np.zeros((2, 64, 2), np.float32)}}}}}, model)
    with pytest.raises(NotImplementedError, match="extra"):
        interop.lora_params_from_jax({"extra": {"kernel": {
            "a": np.zeros((2, 2), np.float32),
            "b": np.zeros((2, 2), np.float32)}}}, model)
