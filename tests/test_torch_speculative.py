"""The port's speculative decoding (``speculative.py``).

* Greedy ``generate_speculative`` equals the port's greedy ``generate``
  token for token, port against port, as the JAX package pins its own:
  an independent draft (mixed acceptance), the target as its own draft
  (full acceptance), draft widths 1-5, eos, ragged left-padded prompts
  and a Llama pair.
* ``speculative_accept`` is integer-equal to the JAX function given the
  same draws (the coins and the residual's Gumbel noise, drawn from the
  JAX keys the JAX function splits).
* The sampled mode is held by the JAX tests' Monte-Carlo bounds: the
  acceptance core's first token within total variation 0.03 of ``p``
  (B = 16384, V = 12), and each emitted position's marginal within 0.1
  of ``generate``'s (B = 2048 rows of one prompt, V = 32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.speculative import (
    speculative_accept as jax_speculative_accept,
)
from pytorch_distributed_tpu_torch.generation import generate
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from pytorch_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
)
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.speculative import (
    generate_speculative,
    speculative_accept,
)
from torch_parity import assert_equal


def _gpt2(vocab, n_positions, hidden, layers, heads, seed):
    cfg = GPT2Config(vocab_size=vocab, n_positions=n_positions,
                     hidden_size=hidden, num_layers=layers, num_heads=heads,
                     dropout_rate=0.0)
    return GPT2LMHead(cfg, device="cpu", policy=Policy.full()).init_weights(
        torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def pair():
    target = _gpt2(97, 96, 32, 2, 2, 0)
    draft = _gpt2(97, 96, 16, 1, 2, 1)
    ids = torch.from_numpy(
        np.random.default_rng(7).integers(97, size=(3, 6)))
    return target, draft, ids


def _greedy(target, ids, n, **kw):
    return generate(target, ids, max_new_tokens=n, device="cpu", **kw)


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_greedy_equals_target_greedy(pair, k):
    target, draft, ids = pair
    want = _greedy(target, ids, 12)
    got, stats = generate_speculative(
        target, draft, ids, max_new_tokens=12, num_draft_tokens=k,
        return_stats=True, device="cpu")
    assert_equal(got, want, f"k={k}")
    assert 1 <= stats["rounds"] <= 11
    assert 0 <= stats["accepted"] <= stats["drafted"]


def test_self_draft_accepts_everything(pair):
    target, _, ids = pair
    got, stats = generate_speculative(
        target, target, ids, max_new_tokens=13, num_draft_tokens=3,
        return_stats=True, device="cpu")
    assert_equal(got, _greedy(target, ids, 13), "self draft")
    assert stats["accepted"] == stats["drafted"]
    assert stats["rounds"] == 3   # 12 tokens after the prefill's, 4 a round


def test_eos_pads_as_generate(pair):
    target, draft, ids = pair
    want = _greedy(target, ids, 10)
    eos = int(want[0, 8])          # a token row 0 emits mid-stream
    want = _greedy(target, ids, 10, eos_id=eos, pad_id=0)
    got = generate_speculative(target, draft, ids, max_new_tokens=10,
                               num_draft_tokens=3, eos_id=eos, pad_id=0,
                               device="cpu")
    assert_equal(got, want, "eos")


def test_ragged_prompts_match_ragged_generate(pair):
    target, draft, ids = pair
    mask = torch.tensor([[0, 0, 1, 1, 1, 1], [1] * 6, [0, 1, 1, 1, 1, 1]],
                        dtype=torch.bool)
    want = _greedy(target, ids, 9, prompt_mask=mask)
    got = generate_speculative(target, draft, ids, max_new_tokens=9,
                               num_draft_tokens=3, prompt_mask=mask,
                               device="cpu")
    assert_equal(got, want, "ragged")
    right = torch.tensor([[1, 1, 1, 1, 1, 0]] * 3, dtype=torch.bool)
    with pytest.raises(ValueError, match="LEFT-padded"):
        generate_speculative(target, draft, ids, max_new_tokens=4,
                             prompt_mask=right, device="cpu")


def test_single_token_and_llama_pair(pair):
    target, draft, ids = pair
    assert_equal(generate_speculative(target, draft, ids, max_new_tokens=1,
                                      device="cpu"),
                 _greedy(target, ids, 1), "one token")
    cfg = LlamaConfig.tiny()
    t = LlamaForCausalLM(cfg, device="cpu", policy=Policy.full())
    t.init_weights(torch.Generator().manual_seed(3))
    d = LlamaForCausalLM(LlamaConfig(
        vocab_size=512, hidden_size=32, num_layers=1, num_heads=2,
        num_kv_heads=1, intermediate_size=64, max_seq_len=128),
        device="cpu", policy=Policy.full())
    d.init_weights(torch.Generator().manual_seed(4))
    lids = torch.from_numpy(np.random.default_rng(1).integers(512,
                                                              size=(2, 5)))
    assert_equal(generate_speculative(t, d, lids, max_new_tokens=9,
                                      num_draft_tokens=3, device="cpu"),
                 _greedy(t, lids, 9), "llama")


def _draws(key, B, k, V):
    """The coins and Gumbel noise the JAX function draws from ``key``."""
    rng_coin, rng_res = jax.random.split(key)
    coins = jax.random.uniform(rng_coin, (B, k))
    gumbel = jax.random.gumbel(rng_res, (B, V), jnp.float32)
    return (torch.from_numpy(np.array(coins)),
            torch.from_numpy(np.array(gumbel)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accept_matches_jax_on_the_same_draws(seed):
    B, k, V = 64, 3, 9
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.ones(V) * 0.5, size=(B, k + 1)).astype(np.float32)
    q = rng.dirichlet(np.ones(V) * 0.5, size=(B, k)).astype(np.float32)
    # half the rows: the draft agrees with the target (high acceptance)
    p[: B // 2, :k] = q[: B // 2]
    proposals = np.stack([[rng.choice(V, p=row / row.sum()) for row in b]
                          for b in q]).astype(np.int32)
    key = jax.random.key(seed + 10)
    ja, jcorr = jax_speculative_accept(jnp.asarray(p), jnp.asarray(q),
                                       jnp.asarray(proposals), key)
    coins, gumbel = _draws(key, B, k, V)
    a, corr = speculative_accept(torch.from_numpy(p), torch.from_numpy(q),
                                 torch.from_numpy(proposals).long(),
                                 coins=coins, gumbel=gumbel)
    assert_equal(a, np.asarray(ja), "accepted prefix")
    assert_equal(corr, np.asarray(jcorr), "correction token")
    assert 0 < int((a == k).sum()) < B


def test_accept_distribution_monte_carlo():
    """Leviathan et al.'s Theorem 1: the first emitted token is
    distributed as p, for p and q that disagree; the bonus draw after a
    full acceptance too."""
    V, B, k = 12, 16384, 2
    rng = np.random.default_rng(0)
    p_row = rng.dirichlet(np.ones(V) * 0.7)
    q_row = rng.dirichlet(np.ones(V) * 0.7)
    p = torch.tensor(np.tile(p_row, (B, k + 1, 1)), dtype=torch.float32)
    q = torch.tensor(np.tile(q_row, (B, k, 1)), dtype=torch.float32)
    gen = torch.Generator().manual_seed(42)
    proposals = torch.multinomial(q.reshape(-1, V), 1, generator=gen
                                  ).reshape(B, k)
    a, corr = speculative_accept(p, q, proposals, gen)
    first = torch.where(a >= 1, proposals[:, 0], corr).numpy()
    emp = np.bincount(first, minlength=V) / B
    assert 0.5 * np.abs(emp - p_row).sum() < 0.03
    bonus = corr[a == k].numpy()
    assert len(bonus) > 200
    emp_b = np.bincount(bonus, minlength=V) / len(bonus)
    assert 0.5 * np.abs(emp_b - p_row).sum() < 0.06


def test_sampled_marginals_match_generate():
    vocab, B, max_new = 32, 2048, 3
    target = _gpt2(vocab, 32, 16, 1, 2, 0)
    draft = _gpt2(vocab, 32, 8, 1, 1, 1)
    prompt = torch.tensor([[5, 11, 2]]).repeat(B, 1)
    ref = generate(target, prompt, max_new_tokens=max_new, temperature=1.0,
                   generator=torch.Generator().manual_seed(7),
                   device="cpu")[:, 3:].numpy()
    got = generate_speculative(
        target, draft, prompt, max_new_tokens=max_new, num_draft_tokens=2,
        temperature=1.0, generator=torch.Generator().manual_seed(8),
        device="cpu")[:, 3:].numpy()
    for pos in range(max_new):
        e1 = np.bincount(ref[:, pos], minlength=vocab) / B
        e2 = np.bincount(got[:, pos], minlength=vocab) / B
        assert 0.5 * np.abs(e1 - e2).sum() < 0.1, pos


def test_sampled_self_draft_accepts_nearly_everything(pair):
    target, _, ids = pair
    _, stats = generate_speculative(
        target, target, ids, max_new_tokens=10, num_draft_tokens=3,
        temperature=1.0, generator=torch.Generator().manual_seed(3),
        return_stats=True, device="cpu")
    assert stats["accepted"] >= 0.9 * stats["drafted"]


def test_validation(pair):
    target, draft, ids = pair
    kw = dict(max_new_tokens=4, device="cpu")
    with pytest.raises(ValueError, match="temperature"):
        generate_speculative(target, draft, ids, temperature=-1.0, **kw)
    with pytest.raises(ValueError, match="top_k"):
        generate_speculative(target, draft, ids, top_k=3, **kw)
    with pytest.raises(ValueError, match="num_draft_tokens"):
        generate_speculative(target, draft, ids, num_draft_tokens=0, **kw)
    with pytest.raises(ValueError, match="cache slots"):
        generate_speculative(target, draft, ids, max_new_tokens=40,
                             num_draft_tokens=4, device="cpu")
    windowed = LlamaForCausalLM(LlamaConfig(**{
        **LlamaConfig.tiny().__dict__, "sliding_window": 4}), device="cpu")
    with pytest.raises(NotImplementedError, match="sliding-window"):
        generate_speculative(windowed, windowed, ids, **kw)
