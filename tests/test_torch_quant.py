"""The port's weight quantization (``ops/quant.py``) held against the JAX
package's on the same weights.

The port quantizes in the JAX geometry (``interop.Geometry``), so:

* int8 payloads are integer-equal to JAX's and their scales equal to the
  bit; int4 packed bytes are integer-equal after the layout map
  (``interop.quantized_params_to_jax``, which stacks scanned layers), and
  a JAX tree carried into the port (``quantized_params_from_jax``) is the
  port's own;
* ``dequantize_tree`` lands within scale/2 of every source value (the
  quantizers' rounding bound), and ``quantized_bytes`` equals JAX's;
* ``QuantizedModel``'s logits agree with the JAX ``QuantizedModel``'s to
  ``RTOL`` = 1e-5 of their largest magnitude (f32 on both sides, the
  forward's own limit), its greedy tokens are JAX's, and its per-layer
  dequantization equals the plain model loaded with ``dequantize_tree``'s
  weights to the bit (the JAX ``scan_dequant`` pin).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.generation import generate as jax_generate
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
from pytorch_distributed_tpu_torch import interop
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

RTOL = 1e-5
F32 = JaxPolicy(compute_dtype=jnp.float32)
KERNELS = (r"kernel$", r"embedding$")


def _gpt2():
    jmodel = JaxGPT2(JaxGPT2Config.tiny())
    with use_policy(F32):
        params = jax.device_get(jmodel.init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])

    def port():
        m = GPT2LMHead(GPT2Config.tiny(), device="cpu", policy=Policy.full())
        m.load_state_dict(interop.gpt2_params_from_jax(params,
                                                       GPT2Config.tiny()))
        return m
    return jmodel, params, port


def _llama():
    jmodel = JaxLlama(JaxLlamaConfig.tiny())
    with use_policy(F32):
        params = jax.device_get(jmodel.init(
            jax.random.key(1), jnp.zeros((1, 8), jnp.int32))["params"])

    def port():
        m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                             policy=Policy.full())
        m.load_state_dict(interop.llama_params_from_jax(params,
                                                        LlamaConfig.tiny()))
        return m
    return jmodel, params, port


def _bert():
    cfg = dataclasses.replace(bert.BertConfig.tiny(), dropout_rate=0.0)
    jmodel = jbert.BertForSequenceClassification(
        dataclasses.replace(jbert.BertConfig.tiny(), dropout_rate=0.0))
    with use_policy(F32):
        params = jax.device_get(jmodel.init(
            jax.random.key(2), jnp.zeros((1, 8), jnp.int32))["params"])

    def port():
        m = bert.BertForSequenceClassification(cfg, device="cpu",
                                               policy=Policy.full())
        m.load_state_dict(interop.bert_params_from_jax(params, cfg))
        return m
    return jmodel, params, port


MODELS = {"gpt2": _gpt2, "llama": _llama, "bert": _bert}


@pytest.fixture(scope="module", params=sorted(MODELS))
def family(request):
    return (request.param,) + MODELS[request.param]()


def _quantizers(name):
    """The selections each family is held with: the scanned families'
    default gate would quantize stacked biases and norms over their
    layer axis (refused below), so they take the scanned kernels or the
    kernels and embeddings."""
    return ("scan", "kernels") if name != "bert" else ("kernels", "default")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: np.asarray(v)})
    return out


def _call(sel, mod, kind, target):
    """``mod``'s (the JAX or the port's ``ops.quant``) quantizer of
    ``kind`` with selection ``sel`` on ``target``."""
    if sel == "scan":
        return mod.quantize_for_scan_dequant(target, kind)
    fn = getattr(mod, f"quantize_tree_{kind}")
    return fn(target, include=KERNELS) if sel == "kernels" else fn(target)


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("sel_index", [0, 1])
def test_payloads_and_bytes_equal_jax(family, kind, sel_index):
    name, _, params, port = family
    sel = _quantizers(name)[sel_index]
    jq = _call(sel, jquant, kind, params)
    model = port()
    pq = _call(sel, quant, kind, model)
    n_q = sum(1 for v in pq.values() if quant._is_qleaf(v))
    assert n_q > 0
    got = _flat(interop.quantized_params_to_jax(pq))
    want = _flat(jax.device_get(jq))
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
    for path, w in want.items():
        g = got[path]
        if path.endswith(("/q8", "/q4")):
            assert g.dtype == w.dtype, (path, g.dtype, w.dtype)
            assert_equal(g, w, path)
        elif path.endswith("/scale") and path.rsplit("/", 2)[-2] in (
                "kernel", "embedding"):
            np.testing.assert_array_equal(g, w.astype(np.float32), path)
        else:
            np.testing.assert_array_equal(g, w, path)
    assert quant.quantized_bytes(pq) == jquant.quantized_bytes(jq)
    # the JAX tree carried into the port is the port's own tree
    back = interop.quantized_params_from_jax(jax.device_get(jq), model)
    assert sorted(back) == sorted(pq)
    for k, v in pq.items():
        if quant._is_qleaf(v):
            for sub in v:
                assert torch.equal(back[k][sub], v[sub]), (k, sub)
        else:
            assert torch.equal(back[k], v), k


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_dequantize_is_within_half_a_step(family, kind):
    name, _, _, port = family
    model = port()
    src = {k: v.clone() for k, v in model.state_dict().items()}
    pq = _call(_quantizers(name)[0], quant, kind, model)
    deq = quant.dequantize_tree(pq)
    for k, leaf in pq.items():
        if not quant._is_qleaf(leaf):
            assert torch.equal(deq[k], src[k])
            continue
        g = pq.geometry[k]
        f = g.to_jax(src[k])
        err = (g.to_jax(deq[k]) - f).abs()
        # scale/2, plus the f32 rounding of the product q * scale at a tie
        slack = 4 * torch.finfo(torch.float32).eps * f.abs()
        scale = leaf["scale"]
        if kind == "int4":   # per (group, out): broadcast over the group
            in_last, groups = err.shape[-2], scale.shape[-3]
            shape = (*err.shape[:-2], groups, in_last // groups,
                     err.shape[-1])
            err, slack = err.reshape(shape), slack.reshape(shape)
        assert bool((err <= scale / 2 + slack).all()), k


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_model_matches_jax(family, kind):
    name, jmodel, params, port = family
    sel = _quantizers(name)[0]
    ids = np.random.default_rng(0).integers(1, 100, size=(2, 12))
    jq = _call(sel, jquant, kind, params)
    with use_policy(F32):
        ref = np.asarray(jquant.QuantizedModel(jmodel).apply(
            {"params": jq}, jnp.asarray(ids, jnp.int32)))
    model = port()
    pq = _call(sel, quant, kind, model)
    # the whole-tree path: the plain model with the dequantized weights
    plain = port()
    plain.load_state_dict(quant.dequantize_tree(pq))
    qm = quant.QuantizedModel(model, pq)
    with torch.no_grad():
        got = qm(torch.from_numpy(ids))
        whole = plain(torch.from_numpy(ids))
    assert_close(got, ref, RTOL, f"{name} {kind} logits")
    assert torch.equal(got, whole), "per-layer vs whole-tree dequantization"
    # the float weights are gone: the resident tensors are the tree's
    resident = sum(t.numel() * t.element_size() for t in
                   list(qm.parameters()) + list(qm.buffers()))
    assert resident == quant.quantized_bytes(pq)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_generate_matches_jax(kind):
    jmodel, params, port = _gpt2()
    ids = np.random.default_rng(1).integers(1, 512, size=(2, 6))
    jq = jquant.quantize_for_scan_dequant(params, kind)
    with use_policy(F32):
        want = np.asarray(jax_generate(
            jquant.QuantizedModel(jmodel), jq, jnp.asarray(ids, jnp.int32),
            max_new_tokens=8))
    model = port()
    qm = quant.QuantizedModel(model, quant.quantize_for_scan_dequant(model,
                                                                     kind))
    got = generate(qm, torch.from_numpy(ids), max_new_tokens=8, device="cpu")
    assert_equal(got, want, kind)


def test_geometry_is_the_slot_map(family):
    """``Geometry.to_jax`` (torch, on the device) is ``Slot.to_jax``
    (numpy) for every tensor of every family."""
    name, _, _, port = family
    model = port()
    slots = interop.model_slots(model)
    sd = model.state_dict()
    for k, g in interop.geometries(model).items():
        want = slots[k].to_jax(sd[k].numpy())
        np.testing.assert_array_equal(g.to_jax(sd[k]).numpy(), want, k)
        assert torch.equal(g.from_jax(g.to_jax(sd[k])), sd[k]), k


def test_cross_layer_leaves_are_refused():
    """A scan-stacked [L, n] bias quantizes over its layer axis in JAX:
    the port keeps one tensor a layer and refuses it by name."""
    _, _, port = _gpt2()
    with pytest.raises(NotImplementedError, match="quantize_for_scan_dequant"):
        quant.quantize_tree_int8(port(), min_size=1)
    with pytest.raises(ValueError, match="kind"):
        quant.quantize_for_scan_dequant(port(), "int2")


def test_rounding_is_half_to_even_with_the_division():
    """``round(f / scale)``: ties go to even, as ``jnp.round``."""
    x = torch.tensor([[2.5, -0.5], [127.0, 1.5]])
    q, s = quant.symmetric_int8(x, 0)
    jq, js = jquant.symmetric_int8(jnp.asarray(x.numpy()), 0)
    assert_equal(q, np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_converter_refuses_a_leaf_it_does_not_map():
    """``quantized_params_from_jax`` accounts for every leaf: an extra
    one, or a quantized node that is neither q8 nor q4, raises by name."""
    _, params, port = _gpt2()
    model = port()
    jq = jax.device_get(jquant.quantize_for_scan_dequant(params, "int8"))
    with pytest.raises(NotImplementedError, match="extra"):
        interop.quantized_params_from_jax(
            dict(jq, extra={"kernel": np.zeros((2, 2), np.float32)}), model)
    bad = jax.tree_util.tree_map(lambda x: x, jq)
    node = bad["blocks"]["block"]["mlp_up"]["kernel"]
    bad["blocks"]["block"]["mlp_up"]["kernel"] = dict(node, zero=node["scale"])
    with pytest.raises(NotImplementedError, match="mlp_up"):
        interop.quantized_params_from_jax(bad, model)
