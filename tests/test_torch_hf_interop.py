"""The port's Hugging Face converters (``interop.load_*``/``export_*``)
held against the JAX package's, on one seeded HF-named state_dict per
family: GPT-2, Llama, Mistral, Qwen2, Qwen3, Gemma, Phi-3 and NeoX.

The HF dict is the JAX ``export_*`` of a JAX tree whose every leaf is
drawn with numpy from a seed, so it has HF's names and shapes (fused
``qkv_proj``/``gate_up_proj`` for Phi-3, ``query_key_value`` for NeoX,
``Conv1D`` ``[in, out]`` weights for GPT-2). Then:

* the JAX ``load_*`` and the port's ``load_*`` of that dict give equal
  logits, to 1e-5 of their largest magnitude (f32, sums in another
  order);
* the port's ``export_*`` of what it loaded equals the JAX ``export_*``
  array by array, bit for bit (renames, transposes and splits only);
* the refusals of the JAX loader hold: biases or q/k norms the config
  does not enable, and a tied config given a differing head;
* ViT, BERT, Mixtral and T5 (both layouts: tied/relu/scanned and the
  untied/gated/unrolled v1.1) load to the JAX loader's leaves and export
  back bit for bit; T5's logits equal a random-init ``transformers``
  model's within 2e-4 where ``transformers`` imports (no download).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu import interop as jinterop
from pytorch_distributed_tpu.models import gemma as jgemma
from pytorch_distributed_tpu.models import gpt2 as jgpt2
from pytorch_distributed_tpu.models import llama as jllama
from pytorch_distributed_tpu.models import mistral as jmistral
from pytorch_distributed_tpu.models import neox as jneox
from pytorch_distributed_tpu.models import phi3 as jphi3
from pytorch_distributed_tpu.models import qwen2 as jqwen2
from pytorch_distributed_tpu.models import qwen3 as jqwen3
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.models import (
    GemmaConfig,
    GemmaForCausalLM,
    LlamaConfig,
    LlamaForCausalLM,
    MistralConfig,
    MistralForCausalLM,
    NeoXConfig,
    NeoXForCausalLM,
    Phi3Config,
    Phi3ForCausalLM,
    Qwen2Config,
    Qwen2ForCausalLM,
    Qwen3Config,
    Qwen3ForCausalLM,
)
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from pytorch_distributed_tpu_torch.runtime.precision import Policy

RTOL = 1e-5
F32 = JaxPolicy(compute_dtype=jnp.float32)
_GPT2 = dataclasses.replace(GPT2Config.tiny(), dropout_rate=0.0)
_JGPT2 = dataclasses.replace(jgpt2.GPT2Config.tiny(), dropout_rate=0.0)

# family: (JAX config, JAX model, port config, port model, converter name)
FAMILIES = {
    "gpt2": (_JGPT2, jgpt2.GPT2LMHead, _GPT2, GPT2LMHead, "gpt2"),
    "llama": (jllama.LlamaConfig.tiny(), jllama.LlamaForCausalLM,
              LlamaConfig.tiny(), LlamaForCausalLM, "llama"),
    "mistral": (jmistral.MistralConfig.tiny(), jmistral.MistralForCausalLM,
                MistralConfig.tiny(), MistralForCausalLM, "mistral"),
    "qwen2": (jqwen2.Qwen2Config.tiny(), jqwen2.Qwen2ForCausalLM,
              Qwen2Config.tiny(), Qwen2ForCausalLM, "qwen2"),
    "qwen3": (jqwen3.Qwen3Config.tiny(), jqwen3.Qwen3ForCausalLM,
              Qwen3Config.tiny(), Qwen3ForCausalLM, "qwen3"),
    "gemma": (jgemma.GemmaConfig.tiny(), jgemma.GemmaForCausalLM,
              GemmaConfig.tiny(), GemmaForCausalLM, "gemma"),
    "phi3": (jphi3.Phi3Config.tiny(), jphi3.Phi3ForCausalLM,
             Phi3Config.tiny(), Phi3ForCausalLM, "phi3"),
    "neox": (jneox.NeoXConfig.tiny(), jneox.NeoXForCausalLM,
             NeoXConfig.tiny(), NeoXForCausalLM, "neox"),
}


def _hf_dict(name):
    """A seeded HF-named state_dict of the family (numpy f32)."""
    jcfg, jcls, _, _, conv = FAMILIES[name]
    jmodel = jcls(jcfg)
    with use_policy(F32):
        shapes = jax.eval_shape(lambda: jmodel.init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    rng = np.random.default_rng(sum(map(ord, name)))

    def one(path, x):
        draw = rng.normal(size=x.shape) * 0.08
        if path[-1].key == "scale" and not getattr(jcfg, "rms_offset",
                                                   False):
            draw = 1.0 + draw
        return draw.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(one, shapes)
    return jmodel, getattr(jinterop, f"export_{conv}_weights")(params, jcfg)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_load_and_export_match_jax(name):
    jcfg, _, cfg, cls, conv = FAMILIES[name]
    jmodel, hf = _hf_dict(name)
    jparams = getattr(jinterop, f"load_{conv}_weights")(hf, jcfg)
    sd = getattr(interop, f"load_{conv}_weights")(hf, cfg)
    model = cls(cfg, device="cpu", policy=Policy.full())
    model.load_state_dict(sd)
    ids = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 16))
    with use_policy(F32):
        ref = np.asarray(jmodel.apply({"params": jparams},
                                      jnp.asarray(ids, jnp.int32)))
    with torch.no_grad():
        out = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=RTOL * np.abs(ref).max(), err_msg=name)
    want = getattr(jinterop, f"export_{conv}_weights")(jparams, jcfg)
    got = getattr(interop, f"export_{conv}_weights")(model.state_dict(), cfg)
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    # the HF dict itself comes back too (the tied head aside: HF keeps
    # the shared tensor under both names)
    for k, v in hf.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def test_loads_keep_dtype_and_take_tensors():
    """A ``.pt``-style dict of bf16 tensors loads as bf16 tensors, the
    values untouched."""
    _, hf = _hf_dict("qwen2")
    pt = {k: torch.from_numpy(np.asarray(v)).to(torch.bfloat16)
          for k, v in hf.items()}
    sd = interop.load_qwen2_weights(pt, Qwen2Config.tiny())
    assert all(t.dtype == torch.bfloat16 for t in sd.values())
    assert torch.equal(sd["layers.0.q.bias"],
                       pt["model.layers.0.self_attn.q_proj.bias"])


def test_llama_loader_refusals_match_jax():
    _, hf = _hf_dict("qwen2")
    with pytest.raises(ValueError, match="attention_bias=False"):
        interop.load_llama_weights(hf, LlamaConfig.tiny())
    _, hf = _hf_dict("qwen3")
    with pytest.raises(ValueError, match="qk_norm=False"):
        interop.load_llama_weights(hf, LlamaConfig.tiny())
    _, hf = _hf_dict("llama")
    tied = dataclasses.replace(LlamaConfig.tiny(), tie_word_embeddings=True)
    with pytest.raises(ValueError, match="UNTIED"):
        interop.load_llama_weights(hf, tied)
    untied = dict(hf)
    del untied["lm_head.weight"]   # a tied dict, an untied config
    sd = interop.load_llama_weights(untied, LlamaConfig.tiny())
    assert torch.equal(sd["lm_head.weight"], sd["embed.weight"])


# -- ViT, BERT, Mixtral and T5: the loaders' leaves against the JAX loaders

from pytorch_distributed_tpu.models import bert as jbert  # noqa: E402
from pytorch_distributed_tpu.models import mixtral as jmixtral  # noqa: E402
from pytorch_distributed_tpu.models import t5 as jt5  # noqa: E402
from pytorch_distributed_tpu.models import vit as jvit  # noqa: E402
from pytorch_distributed_tpu_torch.models.bert import BertConfig  # noqa: E402
from pytorch_distributed_tpu_torch.models.mixtral import (  # noqa: E402
    MixtralConfig,
)
from pytorch_distributed_tpu_torch.models.t5 import (  # noqa: E402
    T5Config,
    T5ForConditionalGeneration,
)
from pytorch_distributed_tpu_torch.models.vit import ViTConfig  # noqa: E402

# T5's two layouts: tied/relu/scanned (t5) and untied/gated/unrolled
# (v1.1)
_T5_V11 = dict(tie_word_embeddings=False, feed_forward_proj="gated-gelu",
               scan_layers=False)

# name: (JAX model, its init input, JAX converter, port config, the port's
# JAX-tree converter, the port's HF load keywords)
TREES = {
    "vit": (lambda: jvit.ViT(jvit.ViTConfig.tiny()),
            jnp.zeros((1, 32, 32, 3)), "vit", ViTConfig.tiny(),
            interop.vit_params_from_jax, {}),
    "bert_cls": (lambda: jbert.BertForSequenceClassification(
        jbert.BertConfig.tiny()), jnp.zeros((1, 8), jnp.int32), "bert",
        BertConfig.tiny(), interop.bert_params_from_jax,
        {"num_labels": 2}),
    "bert_mlm": (lambda: jbert.BertForMaskedLM(jbert.BertConfig.tiny()),
                 jnp.zeros((1, 8), jnp.int32), "bert", BertConfig.tiny(),
                 interop.bert_params_from_jax, {}),
    "mixtral": (lambda: jmixtral.MixtralForCausalLM(
        jmixtral.MixtralConfig.tiny()), jnp.zeros((1, 8), jnp.int32),
        "mixtral", MixtralConfig.tiny(), interop.mixtral_params_from_jax,
        {}),
    "t5": (lambda: jt5.T5ForConditionalGeneration(jt5.T5Config.tiny()),
           (jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 5), jnp.int32)),
           "t5", T5Config.tiny(), interop.t5_params_from_jax, {}),
    "t5_v1_1": (lambda: jt5.T5ForConditionalGeneration(dataclasses.replace(
        jt5.T5Config.tiny(), **_T5_V11)),
        (jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 5), jnp.int32)), "t5",
        dataclasses.replace(T5Config.tiny(), **_T5_V11),
        interop.t5_params_from_jax, {}),
}


def _hf_of_tree(name):
    """``(JAX params, HF dict)``: a seeded JAX tree of the model and its
    JAX ``export_*``."""
    make, x, conv, cfg, _, kw = TREES[name]
    jmodel = make()
    args = x if isinstance(x, tuple) else (x,)   # T5: encoder and decoder
    with use_policy(F32):
        shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0),
                                                    *args))["params"]
    rng = np.random.default_rng(sum(map(ord, name)))
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: (rng.normal(size=s.shape) * 0.08 + (
            path[-1].key == "scale")).astype(np.float32), shapes)
    return params, getattr(jinterop, f"export_{conv}_weights")(
        params, jmodel.config)


@pytest.mark.parametrize("name", sorted(TREES))
def test_vit_bert_mixtral_loaders_give_the_jax_loaders_leaves(name):
    make, _, conv, cfg, from_jax, kw = TREES[name]
    jcfg = make().config
    _, hf = _hf_of_tree(name)
    jparams = getattr(jinterop, f"load_{conv}_weights")(hf, jcfg, **kw)
    want = from_jax(jparams, cfg)
    got = getattr(interop, f"load_{conv}_weights")(hf, cfg, **kw)
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
    for k in want:
        torch.testing.assert_close(got[k].float(), want[k], rtol=0, atol=0,
                                   msg=k)
    # the exports round-trip bitwise, against the JAX export too
    back = getattr(interop, f"export_{conv}_weights")(got, cfg)
    jback = getattr(jinterop, f"export_{conv}_weights")(jparams, jcfg)
    assert sorted(back) == sorted(jback), sorted(set(back) ^ set(jback))
    for k, v in jback.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    for k, v in hf.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)


def test_vit_and_bert_loader_edges():
    """HF's poolerless masked LM loads a zero pooler (as the JAX loader);
    a mean-pooling ViT refuses the HF layout."""
    _, hf = _hf_of_tree("bert_mlm")
    hf = {k: v for k, v in hf.items() if "pooler" not in k}
    sd = interop.load_bert_weights(hf, BertConfig.tiny())
    assert not sd["bert.pooler.weight"].any()
    _, hf = _hf_of_tree("vit")
    with pytest.raises(ValueError, match="pooling='cls'"):
        interop.load_vit_weights(hf, dataclasses.replace(ViTConfig.tiny(),
                                                         pooling="mean"))


@pytest.mark.parametrize("v1_1", [False, True], ids=["t5", "t5_v1_1"])
def test_t5_logits_match_transformers(v1_1):
    """A random-init HF ``T5ForConditionalGeneration`` (no download) loaded
    by ``load_t5_weights``: the port's f32 logits equal HF's within 2e-4
    (the JAX package's own HF pin, ``tests/test_t5.py``), a padded
    encoder row included."""
    transformers = pytest.importorskip("transformers")
    kw = dict(vocab_size=211, d_model=48, d_kv=12, d_ff=96, num_layers=2,
              num_heads=4, relative_attention_num_buckets=8,
              relative_attention_max_distance=20, dropout_rate=0.0,
              feed_forward_proj="gated-gelu" if v1_1 else "relu",
              tie_word_embeddings=not v1_1)
    torch.manual_seed(0)
    hf = transformers.T5ForConditionalGeneration(transformers.T5Config(
        num_decoder_layers=2, **kw)).eval()
    cfg = T5Config(**kw)
    model = T5ForConditionalGeneration(cfg, device="cpu",
                                       policy=Policy.full())
    model.load_state_dict(interop.load_t5_weights(
        {k: v.numpy() for k, v in hf.state_dict().items()}, cfg))
    rng = np.random.default_rng(0)
    enc = torch.from_numpy(rng.integers(2, 211, size=(2, 13)))
    dec = torch.from_numpy(rng.integers(2, 211, size=(2, 7)))
    mask = torch.ones(2, 13, dtype=torch.long)
    mask[1, 9:] = 0
    with torch.no_grad():
        want = hf(input_ids=enc, attention_mask=mask,
                  decoder_input_ids=dec).logits
        got = model(enc, dec, input_mask=mask.bool())
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
