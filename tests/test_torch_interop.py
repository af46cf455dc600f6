"""The port's weight converters account for every leaf of the JAX tree.

A JAX Llama built with ``attention_bias`` (Qwen2) or ``qk_norm`` (Qwen3),
a tied one (``tie_word_embeddings``), and a mixture-of-experts GPT-2
each carry leaves the port's models have no place for; converting them
must raise, naming the leaves (or the missing head) and the ROADMAP item
that would port them, in both JAX layouts (scan-stacked and unrolled).
Trees are built with ``jax.eval_shape`` (shapes only) and zero-filled:
the converters read layout, not values. The plain trees still convert.
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
    with pytest.raises(NotImplementedError, match="A7") as err:
        llama_params_from_jax(_llama_tree(scan, **kw), LlamaConfig.tiny())
    for leaf in leaves:
        assert leaf in str(err.value), (leaf, str(err.value))


@LAYOUTS
def test_llama_refuses_a_tied_tree_by_name(scan):
    with pytest.raises(NotImplementedError,
                       match=r"no lm_head.*tied word embeddings.*A7"):
        llama_params_from_jax(_llama_tree(scan, tie_word_embeddings=True),
                              LlamaConfig.tiny())


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
