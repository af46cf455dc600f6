"""The port's BERT held against the JAX BERT: ``BertConfig.tiny()`` (2
layers, hidden 64, 4 heads of 16, vocab 1024) on weights carried from a
JAX init (``bert_params_from_jax``), the same seeded numpy batches on
both sides, with no mask and with a ragged padding mask.

Three policies, the same on both sides. ``full`` is f32 everywhere, where
the two differ in summation order only: read here up to 8.4e-7 of the
largest magnitude for the sequence output, pooled output and logits,
1.8e-7 on the loss, 1.4e-6 on gradients; limits 1e-5, 1e-5 and 1e-4.
``bf16`` (``Policy.train()``) rounds every product to bf16 in both, but
their CPU kernels add in another order and the flash path rounds P to
bf16 against its running maximum, so an entry lands a bf16 step (2^-8 of
itself) apart and the difference travels through the post-LN layers:
read 1.7e-2 (outputs), 1.5e-3 (loss), 3.6e-2 (gradients); limits 4e-2,
5e-3 and 1e-1. ``fp16`` (``Policy.fp16()``) does the same with 3 more
mantissa bits: read 2.4e-3, 2.0e-4 and 3.7e-3; limits 1e-2, 1e-3 and
2e-2. A wrong weight layout or mask reads ~1. The key projection's bias
has an exactly-zero gradient (adding one constant to every score of a
row leaves the softmax as it is), so both sides hold only rounding noise
there and gradient comparisons leave it out. The JAX side runs its own
attention dispatch (the einsum path on the CPU); the port runs its
einsum path (``attn_impl="xla"``) and the plain version of its flash
kernels (``"flash"``). Dropout is off for the parities (the two draw
different masks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.data.datasets import (
    SyntheticTextDataset as JaxSyntheticTextDataset,
)
from pytorch_distributed_tpu.models import bert as jbert
from pytorch_distributed_tpu.optim import (
    DEFAULT_NO_DECAY as JAX_NO_DECAY,
    no_decay_mask as jax_no_decay_mask,
)
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy as jax_policy
from pytorch_distributed_tpu.train import losses as jlosses
from pytorch_distributed_tpu_torch import optim
from pytorch_distributed_tpu_torch.data import SyntheticTextDataset
from pytorch_distributed_tpu_torch.interop import (
    bert_params_from_jax,
    bert_params_to_jax,
    bert_slots,
    model_slots,
)
from pytorch_distributed_tpu_torch.models import bert as tbert
from pytorch_distributed_tpu_torch.runtime.precision import (
    Policy,
    autocast,
    current_policy,
    use_policy,
)
from pytorch_distributed_tpu_torch.train import (
    masked_lm_loss_fn,
    text_classification_loss_fn,
)
from tests.torch_parity import assert_close, assert_equal

POLICIES = {
    "full": (JaxPolicy(compute_dtype=jnp.float32), Policy.full()),
    "bf16": (JaxPolicy(), Policy.train()),
    "fp16": (JaxPolicy(compute_dtype=jnp.float16), Policy.fp16()),
}
RTOL = {   # (outputs, loss, gradients)
    "full": (1e-5, 1e-5, 1e-4),
    "bf16": (4e-2, 5e-3, 1e-1),
    "fp16": (1e-2, 1e-3, 2e-2),
}
B, S, V = 4, 40, 1024
LENGTHS = (40, 17, 33, 25)   # a ragged padded tail in rows 1-3
JCFG = dataclasses.replace(jbert.BertConfig.tiny(), dropout_rate=0.0)
TCFG = dataclasses.replace(tbert.BertConfig.tiny(), dropout_rate=0.0)


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v)


@pytest.fixture(scope="module")
def jax_models():
    out = {}
    for name, jmodel, seed in (
            ("cls", jbert.BertForSequenceClassification(JCFG, num_labels=3),
             0),
            ("mlm", jbert.BertForMaskedLM(JCFG), 1)):
        with jax_policy(POLICIES["full"][0]):
            params = jmodel.init(jax.random.key(seed),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
        out[name] = (jmodel, jax.device_get(params))
    return out


def _port(kind, params, policy):
    if kind == "cls":
        model = tbert.BertForSequenceClassification(TCFG, 3, device="cpu",
                                                    policy=policy)
    else:
        model = tbert.BertForMaskedLM(TCFG, device="cpu", policy=policy)
    model.load_state_dict(bert_params_from_jax(params, TCFG))
    return model


def _batch(seed, masked=True):
    rng = np.random.default_rng(seed)
    batch = {"input_ids": rng.integers(0, V, (B, S)).astype(np.int32),
             "label": rng.integers(0, 3, (B,)).astype(np.int32)}
    if masked:
        batch["attention_mask"] = (np.arange(S)[None]
                                   < np.asarray(LENGTHS)[:, None])
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("kind", ["cls", "mlm"])
def test_weights_round_trip_through_the_jax_layout(jax_models, kind):
    """Every JAX leaf has its tensor and back, to the bit; the MLM
    decoder is the word-embedding table, not a tensor of its own."""
    _, params = jax_models[kind]
    model = _port(kind, params, Policy.full())
    sd = model.state_dict()
    assert not any("decoder" in n for n in sd)
    assert sum(t.numel() for t in sd.values()) == sum(
        a.size for _, a in _flat(params))
    back = dict(_flat(bert_params_to_jax(sd, TCFG)))
    assert back.keys() == dict(_flat(params)).keys()
    for path, arr in _flat(params):
        np.testing.assert_array_equal(back[path], arr, err_msg=path)
    assert set(model_slots(model)) == set(sd)


def test_converter_refuses_a_leaf_it_does_not_map(jax_models):
    _, params = jax_models["cls"]
    extra = dict(params, lora={"a": np.zeros((2, 2), np.float32)})
    with pytest.raises(NotImplementedError, match="lora/a"):
        bert_params_from_jax(extra, TCFG)


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "padded"])
@pytest.mark.parametrize("attn", ["xla", "flash"])
def test_outputs_match_jax(jax_models, policy, masked, attn):
    """Sequence output, pooled output and classifier logits; MLM logits
    through the tied table (f32)."""
    jpol, tpol = POLICIES[policy]
    batch = _batch(1, masked)
    mask = batch.get("attention_mask")
    (jcls, pcls), (jmlm, pmlm) = jax_models["cls"], jax_models["mlm"]
    ids = jnp.asarray(batch["input_ids"])
    jmask = None if mask is None else jnp.asarray(mask)
    with jax_policy(jpol):
        want_seq, want_pooled = jbert.BertModel(JCFG).apply(
            {"params": pcls["bert"]}, ids, jmask)
        want_logits = jcls.apply({"params": pcls}, ids, jmask)
        want_mlm = jmlm.apply({"params": pmlm}, ids, jmask)
    cls, mlm = _port("cls", pcls, tpol), _port("mlm", pmlm, tpol)
    tids = torch.from_numpy(batch["input_ids"])
    tmask = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        seq, pooled = cls.bert(tids, tmask, attn_impl=attn)
        logits = cls(tids, tmask, attn_impl=attn)
        mlm_logits = mlm(tids, tmask, attn_impl=attn)
    for t in (seq, pooled, logits, mlm_logits):
        assert t.dtype == torch.float32
    rtol = RTOL[policy][0]
    assert_close(seq, want_seq, rtol, "sequence output")
    assert_close(pooled, want_pooled, rtol, "pooled output")
    assert_close(logits, want_logits, rtol, "classifier logits")
    assert_close(mlm_logits, want_mlm, rtol, "mlm logits")


def _grads_vs_jax(model, jgrads, rtol):
    got = dict(_flat(bert_params_to_jax(
        {n: p.grad for n, p in model.named_parameters()}, TCFG)))
    want = dict(_flat(jax.device_get(jgrads)))
    assert got.keys() == want.keys()
    for path, g in got.items():
        if path.endswith("attn/key/bias"):   # exactly zero: noise only
            continue
        assert_close(g, want[path], rtol, path)


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("attn", ["xla", "flash"])
def test_text_classification_loss_and_grads_match_jax(jax_models, policy,
                                                      attn):
    jpol, tpol = POLICIES[policy]
    jmodel, params = jax_models["cls"]
    batch = _batch(2)
    jfn = jlosses.text_classification_loss_fn(jmodel, label_smoothing=0.1)
    with jax_policy(jpol):
        (want, jaux), jgrads = jax.value_and_grad(
            lambda p: jfn(p, None, _jnp(batch), jax.random.key(0)),
            has_aux=True)(params)
    model = _port("cls", params, tpol)
    loss, aux = text_classification_loss_fn(
        model, label_smoothing=0.1, attn_impl=attn)(_torch(batch), None)
    loss.backward()
    _, loss_rtol, grad_rtol = RTOL[policy]
    assert_close(loss.item(), float(want), loss_rtol, "loss")
    assert float(aux["metrics"]["accuracy"]) == float(
        jaux["metrics"]["accuracy"])
    _grads_vs_jax(model, jgrads, grad_rtol)


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("attn", ["xla", "flash"])
def test_masked_lm_loss_and_grads_match_jax(jax_models, policy, attn,
                                            monkeypatch):
    """The two packages draw different maskings from their seeds, so
    both losses are given the port's masking of this batch (the JAX
    ``mask_tokens`` patched to return it): the loss, its accuracy and
    ``mask_frac``, and every gradient, the tied table's two uses summed
    in one."""
    jpol, tpol = POLICIES[policy]
    jmodel, params = jax_models["mlm"]
    batch = _batch(3)
    special = np.zeros((B, S), bool)
    special[:, 0] = True   # CLS
    batch["special_mask"] = special
    gen = torch.Generator().manual_seed(7)
    protect = torch.from_numpy(special | ~batch["attention_mask"])
    masked, labels = tbert.mask_tokens(
        gen, torch.from_numpy(batch["input_ids"]), mask_token_id=103,
        vocab_size=V, mask_prob=0.3, special_mask=protect)
    assert int((labels != -100).sum()) > 0
    monkeypatch.setattr(jbert, "mask_tokens", lambda *a, **k: (
        jnp.asarray(masked.numpy()), jnp.asarray(labels.numpy())))
    monkeypatch.setattr(tbert, "mask_tokens", lambda *a, **k: (
        masked, labels))
    kw = dict(mask_token_id=103, vocab_size=V, mask_prob=0.3)
    jfn = jlosses.masked_lm_loss_fn(jmodel, **kw)
    with jax_policy(jpol):
        (want, jaux), jgrads = jax.value_and_grad(
            lambda p: jfn(p, None, _jnp(batch), jax.random.key(0)),
            has_aux=True)(params)
    model = _port("mlm", params, tpol)
    loss, aux = masked_lm_loss_fn(model, attn_impl=attn, **kw)(
        _torch(batch), gen)
    loss.backward()
    _, loss_rtol, grad_rtol = RTOL[policy]
    assert_close(loss.item(), float(want), loss_rtol, "loss")
    for k in ("accuracy", "mask_frac"):
        assert_close(float(aux["metrics"][k]), float(jaux["metrics"][k]),
                     1e-6, k)
    _grads_vs_jax(model, jgrads, grad_rtol)


def test_mask_tokens_contract():
    """80/10/10 over the selected positions, ``-100`` labels elsewhere,
    the selected share near ``mask_prob``, protected positions (special
    tokens, padding) never selected, unselected ids untouched."""
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(200, V, (64, 128), generator=gen)
    protect = torch.zeros_like(ids, dtype=torch.bool)
    protect[:, 0] = True
    protect[:, 100:] = True   # padding
    masked, labels = tbert.mask_tokens(
        gen, ids, mask_token_id=103, vocab_size=V, mask_prob=0.15,
        special_mask=protect)
    sel = labels != -100
    assert not sel[protect].any()
    assert_equal(labels[sel], ids[sel], "labels are the original ids")
    assert_equal(masked[~sel], ids[~sel], "unselected ids untouched")
    n = int(sel.sum())
    frac = n / int((~protect).sum())
    assert abs(frac - 0.15) < 0.02, frac
    to_mask = (masked[sel] == 103).float().mean().item()
    kept = (masked[sel] == ids[sel]).float().mean().item()
    # a random id hits the original with chance 1/V: negligible here
    assert abs(to_mask - 0.8) < 0.04 and abs(kept - 0.1) < 0.03, (
        to_mask, kept)
    assert int(((masked[sel] != 103) & (masked[sel] != ids[sel])).sum()) > 0


def test_no_decay_split_matches_jax_leaf_by_leaf(jax_models):
    """The recipe's no-decay groups against the JAX ``no_decay_mask``
    through ``bert_slots``: biases and LayerNorm scales exempt, kernels,
    embeddings and the free ``mlm_bias`` decayed."""
    for kind, head in (("cls", "classifier"), ("mlm", "mlm")):
        _, params = jax_models[kind]
        want = dict(_flat(jax.device_get(
            jax_no_decay_mask(JAX_NO_DECAY)(params))))
        model = _port(kind, params, Policy.full())
        decay = optim.no_decay_mask(optim.DEFAULT_NO_DECAY)(model)
        slots = bert_slots(TCFG, head)
        got = {"/".join(slots[n].path): d for n, d in decay.items()}
        assert got.keys() == want.keys()
        for path, d in got.items():
            assert d == bool(want[path]), path
    assert decay["mlm_bias"] is True
    opt = optim.AdamW(model, lr=1e-3, weight_decay=0.01,
                      no_decay=optim.DEFAULT_NO_DECAY)
    exempt = {id(p) for p in opt.param_groups[1]["params"]}
    assert id(model.mlm_ln.weight) in exempt
    assert id(model.mlm_bias) not in exempt


@pytest.mark.parametrize("num_classes", [None, 3])
def test_synthetic_text_labels_are_byte_equal(num_classes):
    kw = dict(n=16, seq_len=24, vocab_size=V, num_classes=num_classes,
              seed=5)
    port, ref = SyntheticTextDataset(**kw), JaxSyntheticTextDataset(**kw)
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        assert a.keys() == b.keys()
        for k in a:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
            assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes()


def test_autocast_sets_the_policy_models_take():
    assert current_policy() == Policy.train()
    with autocast(dtype=torch.float16):
        model = tbert.BertForSequenceClassification(TCFG, device="cpu")
        with autocast(enabled=False):
            assert current_policy() == Policy.full()
        assert current_policy() == Policy.fp16()
    with use_policy(Policy.full()):
        assert current_policy() == Policy.full()
    assert current_policy() == Policy.train()
    assert model.policy == Policy.fp16()
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_partition_rules_and_long_rows_refused():
    # the rules are ported (held leaf by leaf against the JAX table in
    # tests/test_torch_tp.py); the BERT recipe's --tp is A10.1
    rules = tbert.bert_partition_rules()
    assert [pat for pat, _ in rules] == [
        pat for pat, _ in jbert.bert_partition_rules()]
    model = tbert.BertForSequenceClassification(TCFG, device="cpu",
                                                policy=Policy.full())
    with pytest.raises(ValueError, match="max_position_embeddings"):
        model(torch.zeros(1, TCFG.max_position_embeddings + 1,
                          dtype=torch.long))
