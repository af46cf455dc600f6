"""The port's generation (``generation.py``, GPT-2's KV-cache decode, the
int8 dense cache) held against the JAX package's on the same weights.

Weights come from a JAX init and are carried across by the interop; both
sides compute in f32 (the JAX model under an f32 ``Policy``, the port
under ``Policy.full()``). Limits:

* decode logits (prefill, then single-token steps over the cache) agree
  to ``RTOL`` = 1e-5 of their largest magnitude, the GPT-2 forward's own
  limit (tests/test_torch_gpt2.py): the frameworks sum in other orders;
* greedy ``generate`` (plain, ragged left-padded prompts, repetition
  penalty, n-gram bans, eos) and ``generate_beam``'s sequences are
  token-equal to JAX's; beam scores agree to 1e-5 relative;
* the int8 cache: both packages quantize the same K/V per token, but a
  value within float noise of a rounding boundary may land one int8
  step apart, so its decode logits are held to ``RTOL_INT8`` = 1e-3 of
  their largest magnitude, and its greedy tokens equal JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.generation import generate as jax_generate
from pytorch_distributed_tpu.generation import (
    generate_beam as jax_generate_beam,
)
from pytorch_distributed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from pytorch_distributed_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from pytorch_distributed_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlama,
)
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu_torch.generation import (
    generate,
    generate_beam,
    ragged_prompt_state,
)
from pytorch_distributed_tpu_torch.interop import (
    gpt2_params_from_jax,
    llama_params_from_jax,
)
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from pytorch_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
)
from pytorch_distributed_tpu_torch.ops.attention import (
    cache_bytes,
    map_cache,
)
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from torch_parity import assert_close, assert_equal

RTOL = 1e-5
RTOL_INT8 = 1e-3
F32 = JaxPolicy(compute_dtype=jnp.float32)
VOCAB = 97


def _gpt2_cfg(**kw):
    return dict(vocab_size=VOCAB, n_positions=64, hidden_size=32,
                num_layers=2, num_heads=2, dropout_rate=0.0, **kw)


@pytest.fixture(scope="module", params=[None, "int8"], ids=["exact", "int8"])
def gpt2(request):
    """(JAX model, params, port model) with the KV cache exact or int8."""
    q = request.param
    jmodel = JaxGPT2(JaxGPT2Config(**_gpt2_cfg(), kv_cache_quantize=q))
    with use_policy(F32):
        params = jax.device_get(jmodel.init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    cfg = GPT2Config(**_gpt2_cfg(), kv_cache_quantize=q)
    model = GPT2LMHead(cfg, device="cpu", policy=Policy.full())
    model.load_state_dict(gpt2_params_from_jax(params, cfg))
    return jmodel, params, model


def _ids(B=3, P=7, seed=0):
    return np.random.default_rng(seed).integers(1, VOCAB, size=(B, P))


def _jax_generate(jmodel, params, ids, **kw):
    with use_policy(F32):
        out = jax_generate(jmodel, params, jnp.asarray(ids, jnp.int32), **kw)
    return np.asarray(out)


def _rtol(model):
    return RTOL if model.config.kv_cache_quantize is None else RTOL_INT8


def test_decode_logits_match_jax(gpt2):
    """Prefill of 5 tokens, then 3 single-token steps, each against the
    JAX model's decode over its own cache."""
    jmodel, params, model = gpt2
    ids = _ids(2, 8)
    L = 8
    with use_policy(F32):
        ref, state = jmodel.apply(
            {"params": params}, jnp.asarray(ids[:, :5], jnp.int32),
            decode=True, cache_len=L, mutable=["cache"])
        refs = [np.asarray(ref)]
        for t in range(5, 8):
            r, state = jmodel.apply(
                {"params": params, "cache": state["cache"]},
                jnp.asarray(ids[:, t:t + 1], jnp.int32), decode=True,
                cache_len=L, mutable=["cache"])
            refs.append(np.asarray(r))
    x = torch.from_numpy(ids)
    with torch.no_grad():
        out, cache = model(x[:, :5], torch.arange(5)[None].expand(2, 5),
                           write_pos=torch.zeros(2, dtype=torch.int32),
                           decode=True, cache_len=L)
        outs = [out]
        for t in range(5, 8):
            pos = torch.full((2,), t, dtype=torch.int32)
            o, cache = model(x[:, t:t + 1], pos[:, None], cache=cache,
                             write_pos=pos, decode=True, cache_len=L)
            outs.append(o)
    for i, (o, r) in enumerate(zip(outs, refs)):
        assert_close(o, r, _rtol(model), f"decode call {i}")


CASES = {
    "plain": dict(),
    "ragged": dict(ragged=True),
    "penalty": dict(repetition_penalty=1.3),
    "ngram1": dict(no_repeat_ngram_size=1),
    "ngram2": dict(no_repeat_ngram_size=2),
    "ngram3_ragged_penalty": dict(ragged=True, repetition_penalty=1.5,
                                  no_repeat_ngram_size=3),
    "eos": dict(eos_id=7, pad_id=0),
}
MASK = np.array([[0, 0, 1, 1, 1, 1, 1], [1] * 7, [0, 0, 0, 0, 1, 1, 1]],
                bool)


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_generate_matches_jax(gpt2, case):
    jmodel, params, model = gpt2
    kw = dict(CASES[case])
    ids = _ids()
    if kw.pop("ragged", False):
        kw["prompt_mask"] = MASK
    want = _jax_generate(
        jmodel, params, ids, max_new_tokens=10,
        **{k: (jnp.asarray(v) if k == "prompt_mask" else v)
           for k, v in kw.items()})
    got = generate(model, torch.from_numpy(ids), max_new_tokens=10,
                   device="cpu", **kw)
    assert_equal(got, want, case)
    if "no_repeat_ngram_size" in kw and kw["no_repeat_ngram_size"] >= 2:
        n = kw["no_repeat_ngram_size"]
        mask = kw.get("prompt_mask", np.ones_like(MASK))
        for row, m in zip(got.numpy(), mask):
            seq = row[np.concatenate([m, np.ones(10, bool)])]
            grams = [tuple(seq[i:i + n]) for i in range(len(seq) - n + 1)]
            assert len(grams) == len(set(grams)), (case, seq)


@pytest.mark.parametrize("eos", [None, 5], ids=["no_eos", "eos"])
@pytest.mark.parametrize("length_penalty", [1.0, 0.6])
def test_beam_search_matches_jax(gpt2, eos, length_penalty):
    jmodel, params, model = gpt2
    ids = _ids(2, 6, seed=1)
    with use_policy(F32):
        want, wscores = jax_generate_beam(
            jmodel, params, jnp.asarray(ids, jnp.int32), max_new_tokens=8,
            num_beams=3, eos_id=eos, length_penalty=length_penalty,
            return_scores=True)
    got, scores = generate_beam(
        model, torch.from_numpy(ids), max_new_tokens=8, num_beams=3,
        eos_id=eos, length_penalty=length_penalty, return_scores=True,
        device="cpu")
    assert_equal(got, np.asarray(want), "beam sequences")
    assert_close(scores, np.asarray(wscores), 1e-5, "beam scores")


def test_ragged_rows_equal_their_unpadded_runs(gpt2):
    """Port against port: each left-padded row continues exactly as the
    same prompt run alone (positions count real tokens only: GPT-2's
    learned wpe is looked up at them)."""
    _, _, model = gpt2
    ids = torch.from_numpy(_ids())
    kw = dict(max_new_tokens=8, device="cpu", repetition_penalty=1.2,
              no_repeat_ngram_size=2)
    got = generate(model, ids, prompt_mask=torch.from_numpy(MASK), **kw)
    for b, m in enumerate(MASK):
        alone = generate(model, ids[b:b + 1, int(np.argmax(m)):], **kw)
        assert_equal(got[b, -8:], alone[0, -8:], f"row {b}")


def test_sampling_repeats_with_the_same_generator(gpt2):
    _, _, model = gpt2
    ids = torch.from_numpy(_ids())
    runs = [generate(model, ids, max_new_tokens=6, temperature=0.8, top_k=10,
                     generator=torch.Generator().manual_seed(4),
                     device="cpu") for _ in range(2)]
    assert_equal(runs[0], runs[1], "same generator")
    other = generate(model, ids, max_new_tokens=6, temperature=0.8,
                     top_k=10, generator=torch.Generator().manual_seed(5),
                     device="cpu")
    assert not torch.equal(runs[0], other)


def test_ragged_prompt_state_refuses_bad_masks():
    with pytest.raises(ValueError, match="LEFT-padded"):
        ragged_prompt_state(torch.tensor([[1, 1, 0]]), 1, 3, 5)
    with pytest.raises(ValueError, match="no real tokens"):
        ragged_prompt_state(torch.tensor([[1, 1, 1], [0, 0, 0]]), 2, 3, 5)
    with pytest.raises(ValueError, match=r"\(1, 3\)"):
        ragged_prompt_state(torch.ones(1, 4), 1, 3, 5)
    mask, pos, lens, kv = ragged_prompt_state(
        torch.tensor([[0, 1, 1], [1, 1, 1]]), 2, 3, 5)
    assert pos.tolist() == [[0, 0, 1], [0, 1, 2]]
    assert lens.tolist() == [2, 3]
    assert kv.tolist() == [[False, True, True, True, True], [True] * 5]


def test_generate_validates(gpt2):
    _, _, model = gpt2
    ids = torch.from_numpy(_ids())
    with pytest.raises(ValueError, match="repetition_penalty"):
        generate(model, ids, max_new_tokens=2, repetition_penalty=0.0,
                 device="cpu")
    with pytest.raises(ValueError, match="no_repeat_ngram_size"):
        generate(model, ids, max_new_tokens=2, no_repeat_ngram_size=-1,
                 device="cpu")
    with pytest.raises(ValueError, match="maximum sequence length"):
        generate(model, ids, max_new_tokens=60, device="cpu")
    with pytest.raises(ValueError, match="num_beams"):
        generate_beam(model, ids, max_new_tokens=2, num_beams=1,
                      device="cpu")


def test_gpt2_decode_contract(gpt2):
    """GPT-2 takes the Llama model's decode contract and refusals."""
    _, _, model = gpt2
    ids = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="write_pos"):
        model(ids, decode=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        model(ids, torch.arange(4)[None], decode=True,
              write_pos=torch.zeros(1, dtype=torch.int32),
              segment_ids=torch.ones(1, 4, dtype=torch.long))
    with pytest.raises(ValueError, match="kv_mask"):
        model(ids, kv_mask=torch.ones(1, 4, dtype=torch.bool))
    with pytest.raises(ValueError, match="cache_len"):
        model(ids, torch.arange(4)[None], decode=True, cache_len=65,
              write_pos=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="A9"):
        model(ids, torch.arange(4)[None], decode=True, paged=object(),
              write_pos=torch.zeros(1, dtype=torch.int32))


def test_int8_cache_moves_scales_with_payloads():
    """A beam reorder (``map_cache``) gathers the int8 cache's scale
    buffers with their payloads, and the int8 cache rests in ~0.5x the
    bytes of a bf16 one, plus 4/head_dim for the scales."""
    cfg = GPT2Config(**_gpt2_cfg(), kv_cache_quantize="int8")
    model = GPT2LMHead(cfg, device="cpu", policy=Policy.full())
    cache = model.init_cache(3, 8)
    for layer in cache:
        for i, buf in enumerate(layer):
            buf.copy_(torch.arange(3).view(3, 1, 1, 1).to(buf.dtype) + i)
    order = torch.tensor([2, 0, 1])
    moved = map_cache(lambda x, ax: x.index_select(ax, order), cache)
    for layer, new in zip(cache, moved):
        assert len(new) == 4
        for buf, nb in zip(layer, new):
            assert torch.equal(nb, buf[order])
    bf16 = dataclasses.replace(cfg, kv_cache_quantize=None)
    ref = GPT2LMHead(bf16, device="cpu", policy=Policy()).init_cache(3, 8)
    hd = cfg.head_dim
    assert cache_bytes(cache) / cache_bytes(ref) == pytest.approx(
        0.5 + 2.0 / hd)


@pytest.fixture(scope="module", params=[None, "int8"], ids=["exact", "int8"])
def llama(request):
    q = request.param
    jcfg = dataclasses.replace(JaxLlamaConfig.tiny(), kv_cache_quantize=q)
    jmodel = JaxLlama(jcfg)
    with use_policy(F32):
        params = jax.device_get(jmodel.init(
            jax.random.key(1), jnp.zeros((1, 8), jnp.int32))["params"])
    cfg = dataclasses.replace(LlamaConfig.tiny(), kv_cache_quantize=q)
    model = LlamaForCausalLM(cfg, device="cpu", policy=Policy.full())
    model.load_state_dict(llama_params_from_jax(params, cfg))
    return jmodel, params, model


def test_llama_generate_matches_jax(llama):
    """Llama's dense cache, exact or int8 (the int8 paged pool stays
    refused: tests/test_torch_llama.py), greedy on ragged prompts."""
    jmodel, params, model = llama
    ids = np.random.default_rng(2).integers(1, 512, size=(3, 7))
    want = _jax_generate(jmodel, params, ids, max_new_tokens=8,
                         prompt_mask=jnp.asarray(MASK))
    got = generate(model, torch.from_numpy(ids), max_new_tokens=8,
                   prompt_mask=torch.from_numpy(MASK), device="cpu")
    assert_equal(got, want, "llama greedy")


def test_recipe_samples_on_cpu():
    """``recipes/gpt2.py --sample`` on the CPU: 2 rows of the first 8
    eval tokens and N new ones, repeatable from the seed."""
    from pytorch_distributed_tpu_torch.recipes import gpt2 as recipe

    argv = ["--size", "tiny", "--device", "cpu", "--batch-size", "4",
            "--seq-len", "16", "--steps-per-epoch", "1", "--sample", "6",
            "--strategy", "single"]
    a = recipe.main(argv).sample
    b = recipe.main(argv).sample
    assert a.shape == (2, 14)
    assert_equal(a, b, "sample")
