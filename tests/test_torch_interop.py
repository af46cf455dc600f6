"""The port's weight converters account for every leaf of the JAX tree.

A JAX Llama built with ``attention_bias`` (Qwen2) or ``qk_norm`` (Qwen3)
converts under the port config that enables them, and under one that
does not it raises, naming the leaves it has no place for; a tied tree
(``tie_word_embeddings``) converts under a tied config and, under an
untied one, raises naming the missing head; a mixture-of-experts GPT-2
raises naming its expert leaves and the ROADMAP item. All in both JAX
layouts (scan-stacked and unrolled). Trees are built with
``jax.eval_shape`` (shapes only) and zero-filled: the converters read
layout, not values. The plain trees still convert.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytorch_distributed_tpu.models.gpt2 import (
    GPT2Config as JaxGPT2Config,
    GPT2LMHead as JaxGPT2,
)
from pytorch_distributed_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlama,
)
from pytorch_distributed_tpu.models.resnet import (
    BasicBlock as JaxBasicBlock,
    ResNet as JaxResNet,
)
from pytorch_distributed_tpu_torch.interop import (
    gpt2_params_from_jax,
    llama_params_from_jax,
    resnet_params_from_jax,
)
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config
from pytorch_distributed_tpu_torch.models.llama import LlamaConfig


def _zeros(model, *args, collection="params"):
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.key(0), *args))[collection]
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


def _llama_tree(scan, **kw):
    cfg = dataclasses.replace(JaxLlamaConfig.tiny(), scan_layers=scan, **kw)
    return _zeros(JaxLlama(cfg), jnp.zeros((1, 8), jnp.int32))


LAYOUTS = pytest.mark.parametrize("scan", [True, False],
                                  ids=["scanned", "unrolled"])


@LAYOUTS
@pytest.mark.parametrize("kw, leaves", [
    (dict(attention_bias=True), ("q/bias", "k/bias", "v/bias")),
    (dict(qk_norm=True), ("q_norm/scale", "k_norm/scale")),
], ids=["attention_bias", "qk_norm"])
def test_llama_refuses_leaves_it_does_not_map(scan, kw, leaves):
    tree = _llama_tree(scan, **kw)
    with pytest.raises(NotImplementedError, match="A7") as err:
        llama_params_from_jax(tree, LlamaConfig.tiny())
    for leaf in leaves:
        assert leaf in str(err.value), (leaf, str(err.value))
    # the config that enables them maps every leaf (Qwen2's [H * hd]
    # biases, Qwen3's [hd] norm scales)
    cfg = dataclasses.replace(LlamaConfig.tiny(), **kw)
    sd = llama_params_from_jax(tree, cfg)
    hd = cfg.head_dim
    for leaf in leaves:
        mod = leaf.split("/")[0]
        port = f"layers.1.{mod}.{'bias' if 'bias' in leaf else 'weight'}"
        want = (cfg.num_heads if mod == "q" else cfg.num_kv_heads) * hd \
            if "bias" in leaf else hd
        assert sd[port].shape == (want,), (port, sd[port].shape)


@LAYOUTS
def test_llama_refuses_a_tied_tree_by_name(scan):
    tree = _llama_tree(scan, tie_word_embeddings=True)
    with pytest.raises(NotImplementedError,
                       match=r"lm_head/kernel.*which this tree lacks.*A7"):
        llama_params_from_jax(tree, LlamaConfig.tiny())
    # a tied config: the head is embed.weight, no lm_head tensor
    tied = dataclasses.replace(LlamaConfig.tiny(), tie_word_embeddings=True)
    sd = llama_params_from_jax(tree, tied)
    assert "lm_head.weight" not in sd
    assert len(sd) == 2 + 9 * tied.num_layers


@LAYOUTS
def test_gpt2_refuses_mixture_of_experts_leaves(scan):
    cfg = dataclasses.replace(JaxGPT2Config.tiny(), scan_layers=scan,
                              moe_experts=4)
    tree = _zeros(JaxGPT2(cfg), jnp.zeros((1, 8), jnp.int32))
    with pytest.raises(NotImplementedError, match="A7") as err:
        gpt2_params_from_jax(tree, GPT2Config.tiny())
    assert "moe/w_in" in str(err.value) and "moe/router" in str(err.value)


@LAYOUTS
def test_plain_trees_convert_every_leaf(scan):
    sd = llama_params_from_jax(_llama_tree(scan), LlamaConfig.tiny())
    assert len(sd) == 3 + 9 * LlamaConfig.tiny().num_layers
    cfg = dataclasses.replace(JaxGPT2Config.tiny(), scan_layers=scan)
    sd = gpt2_params_from_jax(_zeros(JaxGPT2(cfg),
                                     jnp.zeros((1, 8), jnp.int32)),
                              GPT2Config.tiny())
    assert len(sd) == 4 + 12 * GPT2Config.tiny().num_layers


def test_resnet_refuses_a_leaf_it_does_not_map():
    model = JaxResNet(stage_sizes=[1, 1], block_cls=JaxBasicBlock,
                      num_classes=5, width=8, stem="cifar")
    x = jnp.zeros((1, 16, 16, 3))
    params = _zeros(model, x)
    stats = _zeros(model, x, collection="batch_stats")
    sd = resnet_params_from_jax(params, stats)
    assert sd["stage2_block1.proj_bn.running_var"].shape == (16,)
    params["stage1_block1"]["extra"] = {"kernel": np.zeros((3, 3))}
    with pytest.raises(NotImplementedError,
                       match=r"stage1_block1/extra/kernel.*A3"):
        resnet_params_from_jax(params, stats)
    del params["stage1_block1"]["extra"]
    del stats["stem_bn"]["var"]
    with pytest.raises(NotImplementedError, match="batch_stats/stem_bn/var"):
        resnet_params_from_jax(params, stats)
