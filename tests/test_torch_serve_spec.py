"""Speculative decoding in the port's engine tick (``SpecConfig``), held
port against port, as the JAX package holds its own engine
(tests/test_serve_paged.py):

* greedy streams equal the target's own greedy ``generate``, whatever
  the draft (the verify accepts exactly the target's argmax prefix plus
  its correction), GPT-2 and Llama, paged and dense ticks;
* an eos inside an accepted run truncates the stream there;
* a fully accepted round leaves no hole in the draft's cache: the fill
  feed caches the last proposal, so every position below the write
  cursor holds written K/V;
* sampled rows are deterministic per seed, alone or in a mix (each
  slot draws from its own generator);
* the refusals the JAX engine makes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu_torch.generation import generate
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from pytorch_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
)
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.serve import (
    EngineConfig,
    InProcPrefixStore,
    Request,
    RequestStatus,
    ServeEngine,
    SpecConfig,
    gather_pages,
)

VOCAB = 97
ECFG = EngineConfig(num_slots=3, max_len=64, prefill_chunk=8, page_size=4)


def _gpt2(seed=0, **kw):
    cfg = GPT2Config(**dict(dict(vocab_size=VOCAB, n_positions=64,
                                 hidden_size=32, num_layers=2, num_heads=2,
                                 dropout_rate=0.0), **kw))
    model = GPT2LMHead(cfg, device="cpu", policy=Policy.full())
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.requires_grad_(False)


@pytest.fixture(scope="module")
def gpt2():
    """(target, a 1-layer half-width draft of other weights)."""
    return _gpt2(0), _gpt2(1, num_layers=1, hidden_size=16)


def _greedy(model, req, eos_id=None):
    out = generate(model, req.prompt_ids[None],
                   max_new_tokens=req.max_new_tokens, eos_id=eos_id,
                   device="cpu")[0, req.prompt_len:].tolist()
    if eos_id is not None and eos_id in out:
        out = out[:out.index(eos_id) + 1]
    return out


def _requests(n, seed, vocab=VOCAB, **kw):
    rng = np.random.default_rng(seed)
    return [Request(rng.integers(1, vocab, size=int(rng.integers(3, 20))),
                    int(rng.integers(6, 14)), request_id=f"s{seed}-{i}",
                    seed=200 + i, **kw) for i in range(n)]


def _serve(engine, reqs):
    hs = [engine.submit(r) for r in reqs]
    engine.run_until_drained()
    assert all(h.status is RequestStatus.COMPLETED for h in hs), hs
    engine.pool.check_consistency()
    engine.draft_pool.check_consistency()
    return [h.tokens for h in hs]


@pytest.mark.parametrize("draft,mode", [("other", "paged"),
                                        ("self", "paged"),
                                        ("self", "dense")])
def test_greedy_equals_target_generate(gpt2, draft, mode):
    target, other = gpt2
    dm = target if draft == "self" else other
    k = 3
    engine = ServeEngine(target, dataclasses.replace(ECFG, decode_mode=mode),
                         device="cpu", spec=SpecConfig(dm, k))
    reqs = _requests(5, 1)
    got = _serve(engine, reqs)
    for r, toks in zip(reqs, got):
        assert toks == _greedy(target, r), r.request_id
    # k drafts a row a verify; the accepted ones landed in the streams
    assert engine.spec_drafted % k == 0
    assert engine.spec_drafted >= k * engine.spec_verifies
    assert 0 <= engine.spec_accepted <= engine.spec_drafted
    if draft == "self":
        # the target as its own draft agrees with itself but where a
        # dense and a paged pass round a near-tie apart
        assert engine.spec_accepted >= 0.9 * engine.spec_drafted
    # W = k + 1 needs one more page than the plain tick at a page edge
    assert engine.decode_buckets <= set(engine._buckets)


def test_llama_greedy_equals_target_generate():
    """GQA and rotary positions through the W = k + 1 verify."""
    target = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                              policy=Policy.full())
    target.init_weights(torch.Generator().manual_seed(0))
    draft = LlamaForCausalLM(
        dataclasses.replace(LlamaConfig.tiny(), num_layers=1),
        device="cpu", policy=Policy.full())
    draft.init_weights(torch.Generator().manual_seed(1))
    engine = ServeEngine(target, ECFG, device="cpu",
                         spec=SpecConfig(draft, 4))
    reqs = _requests(4, 2, vocab=512)
    for r, toks in zip(reqs, _serve(engine, reqs)):
        assert toks == _greedy(target, r), r.request_id


def test_eos_inside_an_accepted_run(gpt2):
    target, _ = gpt2
    spec = SpecConfig(target, 4)
    req = _requests(1, 7)[0]
    free = _serve(ServeEngine(target, ECFG, device="cpu", spec=spec),
                  [req])[0]
    # the first tick emits tokens 1..5 of the stream; stop inside it, at
    # a token the stream has not emitted before
    eos = next(t for j, t in enumerate(free[2:5], 2) if t not in free[:j])
    stop = dataclasses.replace(req, eos_id=eos, request_id="eos")
    engine = ServeEngine(target, ECFG, device="cpu", spec=spec)
    got = _serve(engine, [stop])[0]
    assert got == free[:free.index(eos) + 1]
    assert got == _greedy(target, req, eos_id=eos)
    assert engine.spec_verifies == 1


def test_full_accept_round_leaves_no_draft_cache_hole(gpt2):
    target, _ = gpt2
    k = 3
    engine = ServeEngine(
        target, dataclasses.replace(ECFG, num_slots=1), device="cpu",
        spec=SpecConfig(target, k),
    )
    rng = np.random.default_rng(11)
    h = engine.submit(Request(rng.integers(1, VOCAB, size=8), 20))
    full = 0
    while not h.done and len(h.tokens) < 14:
        before = engine.spec_accepted
        engine.step()
        full += engine.spec_accepted - before == k
    assert full, "no fully accepted round"
    assert not h.done
    slot = h.slot
    L = int(engine._lengths[slot])
    assert L == engine.draft_pool.lengths[slot]
    dense = gather_pages(engine.draft_pool.cache, engine._dpt[slot:slot + 1])
    for layer in dense:
        for buf in layer:
            written = buf[0, :L].abs().flatten(1).sum(dim=1)
            assert (written > 0).all(), torch.nonzero(written == 0)


def test_sampled_rows_deterministic_per_seed(gpt2):
    target, draft = gpt2
    spec = SpecConfig(draft, 3)
    reqs = _requests(4, 5, temperature=0.9, top_k=30)
    reqs[1] = dataclasses.replace(reqs[1], temperature=0.0, top_k=None)
    mixed = _serve(ServeEngine(target, ECFG, device="cpu", spec=spec), reqs)
    again = _serve(ServeEngine(target, ECFG, device="cpu", spec=spec), reqs)
    assert mixed == again
    for i in (0, 2):
        alone = _serve(ServeEngine(target, ECFG, device="cpu", spec=spec),
                       [reqs[i]])[0]
        assert alone == mixed[i]
    assert mixed[1] == _greedy(target, reqs[1])
    assert all(len(t) == r.max_new_tokens for t, r in zip(mixed, reqs))


def test_spec_refusals(gpt2):
    target, draft = gpt2
    with pytest.raises(ValueError, match="num_draft_tokens"):
        SpecConfig(draft, 0)
    spec = SpecConfig(draft, 3)
    for role in ("prefill", "decode"):
        with pytest.raises(ValueError, match="solo-engine only"):
            ServeEngine(target, dataclasses.replace(ECFG, role=role),
                        device="cpu", spec=spec)
    with pytest.raises(ValueError, match="prefix_store requires spec"):
        ServeEngine(target, ECFG, device="cpu", spec=spec,
                    prefix_store=InProcPrefixStore())
    with pytest.raises(ValueError, match="DRAFT"):
        ServeEngine(target, ECFG, device="cpu",
                    spec=SpecConfig(_gpt2(2, n_positions=32), 3))
    engine = ServeEngine(target, ECFG, device="cpu", spec=spec)
    with pytest.raises(ValueError, match="speculative-verify"):
        engine.submit(Request(np.arange(1, 17), 46))
