"""The port's T5 (``models/t5.py``), its attention bias and dropout
(``ops/attention.py``) and the seq2seq losses (``train/losses.py``) held
against the JAX package on the same numpy-seeded inputs, the JAX
model's weights carried across by ``interop.t5_params_from_jax``:

* the relative-position buckets equal the JAX ones at every distance to
  4 x ``max_distance`` both ways, bidirectional and causal, at the tiny,
  the small/base and the HF-test geometries; the bias gathered from a
  table equals the JAX one bit for bit;
* ``T5LayerNorm`` to 1e-6 of its largest output (f32);
* attention with a materialized ``bias`` against JAX
  ``dot_product_attention(bias=...)``, and with ``bias_fn`` (a decode
  offset included) against JAX ``attention(bias_fn=...)``, to 1e-5 (f32,
  sums in another order); the dispatcher's refusals;
* the whole model's logits, tied/relu/scanned and untied/gated/unrolled,
  with a padded encoder row: under the f32 policy to 2e-5 of their
  largest magnitude; under the bf16 policy within the reference's own
  bf16 noise (JAX's bf16 logits' distance from its f32 ones, 2-6% at
  this size) of JAX's bf16 logits, and within 1.5 times it of the f32
  ones (the frameworks round bf16 products and the gelu at other
  points);
* cached decode equals the full recompute's argmax; a padded row leaves
  an unpadded one unchanged;
* ``seq2seq_lm_loss_fn`` (label smoothing, a label mask) and
  ``seq2seq_eval_step``'s metrics to 1e-5; the loss's gradients against
  ``jax.grad`` to 1e-4 of each tensor's largest, and one clip + AdamW
  step from the same gradients against optax's to 1e-5;
* ``generate_encdec``'s greedy tokens equal to JAX's (f32 policy);
* the dropout sites fire in training, port against port; ``remat``
  gives the plain run's gradients bit for bit, dropout on;
* ``t5_params_to_jax`` returns the JAX tree bit for bit in both layouts.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_tpu.models import t5 as jt5
from pytorch_distributed_tpu.ops import attention as jattn
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu.train import losses as jlosses
from pytorch_distributed_tpu_torch import optim
from pytorch_distributed_tpu_torch.interop import (
    t5_params_from_jax,
    t5_params_to_jax,
)
from pytorch_distributed_tpu_torch.models import t5
from pytorch_distributed_tpu_torch.ops.attention import attention
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.train import losses
from tests.torch_parity import assert_close, assert_equal

F32 = JaxPolicy(compute_dtype=jnp.float32)
BF16 = JaxPolicy()
RTOL, LOGIT_RTOL, LOSS_RTOL = 1e-5, 2e-5, 1e-5
# the port's bf16 logits against JAX's f32 ones, in units of JAX's own
# bf16-vs-f32 distance (2.2e-2 and 5.7e-2 of the largest logit for the
# two layouts; the port's read 2.5e-2 and 6.2e-2)
BF16_NOISE = 1.5
# gradients of the seq2seq loss, f32 sums in another order; then the
# clip + AdamW step from the same gradients
LR, GRAD_RTOL = 3e-3, 1e-4
# name: (scan_layers, tie_word_embeddings, feed_forward_proj)
LAYOUTS = {"scan_tied_relu": (True, True, "relu"),
           "unrolled_untied_gated": (False, False, "gated-gelu")}


def _cfgs(name, **kw):
    scan, tie, ff = LAYOUTS[name]
    kw = dict(scan_layers=scan, tie_word_embeddings=tie,
              feed_forward_proj=ff, dropout_rate=0.0, **kw)
    return (dataclasses.replace(jt5.T5Config.tiny(), **kw),
            dataclasses.replace(t5.T5Config.tiny(), **kw))


def _jax_params(jcfg, seed=0):
    with use_policy(F32):
        return jax.device_get(jt5.T5ForConditionalGeneration(jcfg).init(
            jax.random.key(seed), jnp.zeros((1, 5), jnp.int32),
            jnp.zeros((1, 3), jnp.int32))["params"])


def _port(cfg, params, policy):
    model = t5.T5ForConditionalGeneration(cfg, device="cpu", policy=policy)
    model.load_state_dict(t5_params_from_jax(params, cfg))
    return model


def _ids(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(2, vocab, (B, S))


def _mask(B, S, lengths):
    m = np.zeros((B, S), bool)
    for b, n in enumerate(lengths):
        m[b, :n] = True
    return m


# -- buckets, tables, the norm ---------------------------------------------


@pytest.mark.parametrize("num_buckets, max_distance",
                         [(8, 32), (32, 128), (8, 20)])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_buckets_equal_jax_at_every_distance(num_buckets, max_distance,
                                             bidirectional):
    rp = np.arange(-4 * max_distance, 4 * max_distance + 1, dtype=np.int32)
    want = jt5.relative_position_bucket(
        jnp.asarray(rp), bidirectional=bidirectional,
        num_buckets=num_buckets, max_distance=max_distance)
    got = t5.relative_position_bucket(
        torch.from_numpy(rp.astype(np.int64)), bidirectional=bidirectional,
        num_buckets=num_buckets, max_distance=max_distance)
    assert_equal(got, np.asarray(want).astype(np.int64),
                 f"{num_buckets}/{max_distance}/{bidirectional}")


@pytest.mark.parametrize("bidirectional, offset", [(True, 0), (False, 0),
                                                   (False, 7)])
def test_bias_from_table_equals_jax(bidirectional, offset):
    table = np.random.default_rng(1).normal(size=(32, 6)).astype(np.float32)
    q, k = np.arange(9) + offset, np.arange(9 + offset)
    kw = dict(bidirectional=bidirectional, num_buckets=32, max_distance=128)
    want = jt5.relative_bias_from_table(jnp.asarray(table), jnp.asarray(q),
                                        jnp.asarray(k), **kw)
    got = t5.relative_bias_from_table(torch.from_numpy(table),
                                      torch.from_numpy(q),
                                      torch.from_numpy(k), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3.0
    scale = (1.0 + 0.1 * rng.normal(size=48)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = jt5.T5LayerNorm(1e-6).apply({"params": {"scale": scale}}, jx)
    norm = t5.T5LayerNorm(48, 1e-6, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        got = norm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, np.asarray(want.astype(jnp.float32)),
                 1e-6 if dtype == "float32" else 2 ** -8, dtype)


# -- attention with a bias ---------------------------------------------------


def _qkv(seed, B=2, S=6, T=6, Hq=4, Hkv=2, D=8):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return f(B, S, Hq, D), f(B, T, Hkv, D), f(B, T, Hkv, D)


def _table_fn(jax_side, bidirectional=False):
    table = np.random.default_rng(9).normal(size=(8, 4)).astype(np.float32)
    kw = dict(bidirectional=bidirectional, num_buckets=8, max_distance=16)
    if jax_side:
        return lambda q, k: jt5.relative_bias_from_table(
            jnp.asarray(table), q, k, **kw)
    return lambda q, k: t5.relative_bias_from_table(
        torch.from_numpy(table), q, k, **kw)


def test_attention_with_bias_matches_jax():
    q, k, v = _qkv(3, S=5, T=7)
    bias = np.random.default_rng(4).normal(size=(2, 4, 5, 7)).astype(
        np.float32)
    mask = _mask(2, 7, (7, 4))
    want = jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jnp.asarray(bias),
        mask=jnp.asarray(mask), scale=1.0)
    got = attention(*map(torch.from_numpy, (q, k, v)),
                    bias=torch.from_numpy(bias), mask=torch.from_numpy(mask),
                    scale=1.0)
    assert_close(got, np.asarray(want), RTOL, "bias")


@pytest.mark.parametrize("offset, S, T", [(0, 6, 6), (5, 1, 9)])
def test_attention_bias_fn_matches_jax(offset, S, T):
    """Materialized over the call's positions, a decode offset included."""
    q, k, v = _qkv(5, S=S, T=T)
    want = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, q_offset=offset, scale=1.0,
                           bias_fn=_table_fn(True))
    got = attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                    q_offset=offset, scale=1.0, bias_fn=_table_fn(False))
    assert_close(got, np.asarray(want), RTOL, f"bias_fn offset {offset}")


def test_attention_refusals():
    q = torch.zeros(1, 4, 2, 8)
    fn = _table_fn(False)
    with pytest.raises(ValueError, match="not both"):
        attention(q, q, q, bias=torch.zeros(1, 2, 4, 4), bias_fn=fn)
    with pytest.raises(NotImplementedError, match="per-row"):
        attention(q, q, q, q_offset=torch.zeros(1, dtype=torch.long),
                  bias_fn=fn)
    for kw in (dict(bias_fn=fn), dict(dropout_rate=0.1,
                                      generator=torch.Generator())):
        with pytest.raises(ValueError, match="impl='flash'"):
            attention(q, q, q, impl="flash", **kw)
    with pytest.raises(ValueError, match="generator"):
        attention(q, q, q, dropout_rate=0.1)


# -- the model -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _logits_pair(name, dtype):
    jcfg, cfg = _cfgs(name)
    params = _jax_params(jcfg)
    enc, dec = _ids(6, 2, 11, 512), _ids(7, 2, 7, 512)
    mask = _mask(2, 11, (11, 6))
    policy, port_policy = ((F32, Policy.full()) if dtype == "f32"
                           else (BF16, Policy.train()))
    with use_policy(policy):
        want = jax.jit(jt5.T5ForConditionalGeneration(jcfg).apply)(
            {"params": params}, jnp.asarray(enc), jnp.asarray(dec),
            input_mask=jnp.asarray(mask))
    model = _port(cfg, params, port_policy)
    with torch.no_grad():
        got = model(torch.from_numpy(enc), torch.from_numpy(dec),
                    input_mask=torch.from_numpy(mask))
    return got, np.asarray(want)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_logits_match_jax(name, dtype):
    got32, want32 = _logits_pair(name, "f32")
    if dtype == "f32":
        assert_close(got32, want32, LOGIT_RTOL, name)
        return
    got, want = _logits_pair(name, "bf16")
    assert got.dtype == torch.float32
    # the limit is the reference's own bf16 noise: how far JAX's bf16
    # logits lie from its f32 ones
    noise = np.abs(want - want32).max() / np.abs(want32).max()
    assert_close(got, want, noise, f"{name} vs JAX bf16")
    assert_close(got, want32, BF16_NOISE * noise, f"{name} vs JAX f32")


def test_cached_decode_equals_recompute():
    cfg = dataclasses.replace(t5.T5Config.tiny(), dropout_rate=0.0)
    model = t5.T5ForConditionalGeneration(cfg, device="cpu",
                                          policy=Policy.full())
    model.init_weights(torch.Generator().manual_seed(0))
    enc = torch.from_numpy(_ids(1, 2, 11, cfg.vocab_size))
    out = t5.generate_encdec(model, enc, max_new_tokens=9, eos_id=-1)
    assert tuple(out.shape) == (2, 9)
    with torch.no_grad():
        full = model(enc, t5.shift_right(out, cfg.pad_token_id))
    assert_equal(full.argmax(-1), out, "greedy vs recompute")


def test_padded_row_leaves_unpadded_row_unchanged():
    cfg = dataclasses.replace(t5.T5Config.tiny(), dropout_rate=0.0)
    model = t5.T5ForConditionalGeneration(cfg, device="cpu",
                                          policy=Policy.full())
    model.init_weights(torch.Generator().manual_seed(1))
    enc = torch.from_numpy(_ids(2, 2, 8, cfg.vocab_size))
    dec = torch.from_numpy(_ids(3, 2, 5, cfg.vocab_size))
    mask = torch.from_numpy(_mask(2, 8, (8, 5)))
    with torch.no_grad():
        both = model(enc, dec, input_mask=mask)
        solo = model(enc[:1], dec[:1], input_mask=mask[:1])
    assert_close(both[0], solo[0], RTOL, "unpadded row")


def test_generate_matches_jax_tokens():
    jcfg, cfg = _cfgs("scan_tied_relu")
    params = _jax_params(jcfg, seed=3)
    enc = _ids(8, 3, 9, 512)
    mask = _mask(3, 9, (9, 9, 5))
    with use_policy(F32):
        want = jax.jit(lambda p, e, m: jt5.generate_encdec(
            jt5.T5ForConditionalGeneration(jcfg), p, e, max_new_tokens=8,
            input_mask=m, eos_id=-1))(params, jnp.asarray(enc),
                                      jnp.asarray(mask))
    got = t5.generate_encdec(_port(cfg, params, Policy.full()),
                             torch.from_numpy(enc), max_new_tokens=8,
                             input_mask=torch.from_numpy(mask), eos_id=-1)
    assert_equal(got, np.asarray(want).astype(np.int64), "greedy tokens")


def test_decode_wrapper_refuses_ragged_prompts():
    cfg = dataclasses.replace(t5.T5Config.tiny(), dropout_rate=0.0)
    model = t5.T5ForConditionalGeneration(cfg, device="cpu")
    wrapper = t5.T5DecodeWrapper(model, torch.zeros(1, 3, cfg.d_model))
    with pytest.raises(NotImplementedError, match="kv_mask"):
        wrapper(torch.zeros(1, 1, dtype=torch.long), decode=True,
                cache_len=4, kv_mask=torch.ones(1, 4, dtype=torch.bool))


# -- the losses and one optimizer step --------------------------------------


def _batch(seed, cfg):
    rng = np.random.default_rng(seed)
    labels = rng.integers(2, cfg.vocab_size, (4, 6))
    return {"input_ids": rng.integers(2, cfg.vocab_size, (4, 10)),
            "labels": labels,
            "label_mask": _mask(4, 6, (6, 6, 4, 6)),
            "input_mask": _mask(4, 10, (10, 7, 10, 10))}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_seq2seq_loss_and_eval_match_jax(smoothing):
    jcfg, cfg = _cfgs("scan_tied_relu")
    params = _jax_params(jcfg, seed=4)
    batch = _batch(4, cfg)
    jmodel = jt5.T5ForConditionalGeneration(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with use_policy(F32):
        want, _ = jax.jit(jlosses.seq2seq_lm_loss_fn(
            jmodel, label_smoothing=smoothing))(params, None, jb,
                                                jax.random.key(0))
        want_eval = jax.jit(lambda p, b: jlosses.seq2seq_eval_step(jmodel)(
            type("S", (), {"params": p})(), b))(params, jb)
    model = _port(cfg, params, Policy.full())
    got, aux = losses.seq2seq_lm_loss_fn(model, label_smoothing=smoothing)(
        _torch_batch(batch), torch.Generator())
    assert_close(got, np.asarray(want), LOSS_RTOL, "loss")
    assert_close(aux["metrics"]["loss"], np.asarray(want), LOSS_RTOL)
    got_eval = losses.seq2seq_eval_step(model)(None, _torch_batch(batch))
    assert sorted(got_eval) == sorted(want_eval)
    for k, v in want_eval.items():
        assert_close(got_eval[k], np.asarray(v), LOSS_RTOL, k)


def test_clip_adamw_step_matches_optax():
    """The loss's gradients against ``jax.grad`` per tensor, then one
    clip + AdamW step from the JAX gradients against optax's."""
    jcfg, cfg = _cfgs("unrolled_untied_gated")
    params = _jax_params(jcfg, seed=5)
    batch = _batch(5, cfg)
    jmodel = jt5.T5ForConditionalGeneration(jcfg)
    loss_fn = jlosses.seq2seq_lm_loss_fn(jmodel)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with use_policy(F32):
        grads = jax.device_get(jax.jit(jax.grad(lambda p: loss_fn(
            p, None, jb, jax.random.key(0))[0]))(params))
        upd, _ = tx.update(grads, tx.init(params), params)
        want = t5_params_from_jax(jax.device_get(
            optax.apply_updates(params, upd)), cfg)
    want_grads = t5_params_from_jax(grads, cfg)
    model = _port(cfg, params, Policy.full())
    opt = optim.clip_grad_norm(optim.AdamW(model, lr=LR,
                                           weight_decay=1e-4), 1.0)
    loss, _ = losses.seq2seq_lm_loss_fn(model)(_torch_batch(batch),
                                               torch.Generator())
    loss.backward()
    for name, p in model.named_parameters():
        assert_close(p.grad, want_grads[name], GRAD_RTOL, f"grad {name}")
        p.grad.copy_(want_grads[name])
    opt.step()
    for name, p in model.state_dict().items():
        assert_close(p, want[name], RTOL, name)


# -- dropout, converters -----------------------------------------------------


def test_dropout_sites_fire_in_training():
    """Residual, attention-weight and FFN-inner dropout: outputs move in
    training, repeat under the same generator seed, and train=False is
    the deterministic path."""
    cfg = t5.T5Config.tiny()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 6, cfg.d_model)).astype(
        np.float32))
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    ffn = t5.T5FFN(cfg, policy=Policy.full(), device="cpu")
    attn = t5.T5Attention(cfg, causal=False, policy=Policy.full(),
                          device="cpu")
    for mod in (ffn, attn):
        for p in mod.parameters():
            torch.nn.init.normal_(p, std=0.1, generator=gen(7))
        with torch.no_grad():
            det = mod(x)
            a = mod(x, train=True, generator=gen(1))
            b = mod(x, train=True, generator=gen(2))
            a2 = mod(x, train=True, generator=gen(1))
            assert torch.equal(det, mod(x, train=False))
        assert not torch.allclose(det, a)
        assert not torch.allclose(a, b)
        assert torch.equal(a, a2)
    model = t5.T5ForConditionalGeneration(cfg, device="cpu",
                                          policy=Policy.full())
    model.init_weights(gen(0))
    ids = torch.from_numpy(_ids(1, 2, 7, cfg.vocab_size))
    with torch.no_grad():
        det = model(ids, ids)
        a = model(ids, ids, train=True, generator=gen(3))
    assert not torch.allclose(det, a)


def test_remat_gives_the_same_gradients():
    """``remat=True`` recomputes each block in the backward, replaying its
    dropout masks: the loss and every gradient equal the plain run's."""
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(t5.T5Config.tiny(), remat=remat)
        model = t5.T5ForConditionalGeneration(cfg, device="cpu",
                                              policy=Policy.full())
        model.init_weights(torch.Generator().manual_seed(0))
        loss, _ = losses.seq2seq_lm_loss_fn(model)(
            _torch_batch(_batch(6, cfg)), torch.Generator().manual_seed(1))
        loss.backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_params_to_jax_round_trip(name):
    jcfg, cfg = _cfgs(name)
    params = _jax_params(jcfg, seed=6)
    back = t5_params_to_jax(t5_params_from_jax(params, cfg), cfg)
    flat = lambda t: {  # noqa: E731
        "/".join(k.key for k in p): np.asarray(v)
        for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    want, got = flat(params), flat(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
