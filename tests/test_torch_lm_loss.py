"""The port's chunked-vocab cross-entropy (``ops/lm_loss.py``) held
against the JAX package's ``chunked_softmax_cross_entropy`` and against
the full-logits loss, and the chunked train/eval losses of
``train/losses.py`` against the JAX ones on the same GPT-2 weights.

Both sides compute in f32 on the same seeded numpy inputs. Limits
(``tests/torch_parity.py``, relative to the reference's largest
magnitude): 1e-6 for the loss and 1e-5 for the gradients of the hidden
states and the projection against JAX (the same chunking, summed in
another order); the same against the port's own full logits
(``F.cross_entropy``); the model-level losses and gradients 1e-5 / 1e-4,
as ``tests/test_torch_train.py`` holds the full-logits path. The memory
claim is checked by what the forward saves for the backward
(``saved_tensors_hooks``: no chunk of logits) and by the chunk-shaped
buffers alive at once during the backward (at most three: one chunk's
logits, its gradient and one temporary, however many chunks).
"""

import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from pytorch_distributed_tpu.data.packing import (
    pack_documents as jax_pack_documents,
)
from pytorch_distributed_tpu.models.gpt2 import (
    GPT2Config as JaxGPT2Config,
    GPT2LMHead as JaxGPT2,
)
from pytorch_distributed_tpu.ops.lm_loss import (
    causal_lm_chunked_loss as jax_causal_chunked,
    chunked_softmax_cross_entropy as jax_chunked_ce,
)
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu.train.losses import (
    causal_lm_eval_step as jax_eval_step,
    causal_lm_loss_fn as jax_loss_fn,
)
from pytorch_distributed_tpu_torch.data import pack_documents
from pytorch_distributed_tpu_torch.interop import (
    gpt2_params_from_jax,
    gpt2_params_to_jax,
)
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from pytorch_distributed_tpu_torch.ops.lm_loss import (
    causal_lm_chunked_loss,
    chunked_softmax_cross_entropy,
)
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.train import (
    causal_lm_eval_step,
    causal_lm_loss_fn,
)
from pytorch_distributed_tpu_torch.train.losses import _lm_projection_weight
from tests.torch_parity import assert_close, assert_equal

LOSS_RTOL, GRAD_RTOL = 1e-6, 1e-5
MODEL_LOSS_RTOL, MODEL_GRAD_RTOL = 1e-5, 1e-4
F32 = JaxPolicy(compute_dtype=jnp.float32)
N, D = 37, 16

# (V, C): divisible, ragged last chunk, one chunk wider than the vocab
SHAPES = [(96, 32), (100, 32), (50, 64)]
CASES = [(v, c, axis, ls, w) for v, c in SHAPES for axis in (0, 1)
         for ls in (0.0, 0.1) for w in (False, True)]


def _inputs(V, seed=0, weights=False):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, D)).astype(np.float32)
    emb = (rng.normal(size=(V, D)) * 0.5).astype(np.float32)
    labels = rng.integers(0, V, N).astype(np.int32)
    w = (rng.random(N) > 0.3).astype(np.float32) if weights else None
    return h, emb, labels, w


def _port(h, emb, labels, w, **kw):
    th = torch.tensor(h, requires_grad=True)
    te = torch.tensor(emb, requires_grad=True)
    loss = chunked_softmax_cross_entropy(
        th, te, torch.from_numpy(labels),
        weights=None if w is None else torch.from_numpy(w), **kw)
    loss.backward()
    return loss.item(), th.grad, te.grad


@pytest.mark.parametrize(
    "V, C, axis, ls, weighted", CASES,
    ids=[f"V{v}-C{c}-ax{a}-ls{ls}-{'w' if w else 'mean'}"
         for v, c, a, ls, w in CASES])
def test_chunked_ce_matches_jax_and_full_logits(V, C, axis, ls, weighted):
    h, emb, labels, w = _inputs(V, weights=weighted)
    emb_in = emb if axis == 0 else np.ascontiguousarray(emb.T)

    def jloss(hh, ee):
        return jax_chunked_ce(hh, ee, jnp.asarray(labels), chunk_size=C,
                              label_smoothing=ls, vocab_axis=axis,
                              weights=None if w is None else jnp.asarray(w))

    want, (jh, je) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(emb_in))
    got, gh, ge = _port(h, emb_in, labels, w, chunk_size=C,
                        label_smoothing=ls, vocab_axis=axis)
    assert_close(got, float(want), LOSS_RTOL, "loss vs JAX")
    assert_close(gh, np.asarray(jh), GRAD_RTOL, "d hidden vs JAX")
    assert_close(ge, np.asarray(je), GRAD_RTOL, "d projection vs JAX")

    # the port's own full logits, with F.cross_entropy's smoothing
    th = torch.tensor(h, requires_grad=True)
    te = torch.tensor(emb_in, requires_grad=True)
    logits = th @ (te.t() if axis == 0 else te)
    tok = F.cross_entropy(logits, torch.from_numpy(labels).long(),
                          reduction="none", label_smoothing=ls)
    if w is None:
        full = tok.mean()
    else:
        wt = torch.from_numpy(w)
        full = (tok * wt).sum() / wt.sum().clamp(min=1.0)
    full.backward()
    assert_close(got, full.item(), LOSS_RTOL, "loss vs full logits")
    assert_close(gh, th.grad, GRAD_RTOL, "d hidden vs full logits")
    assert_close(ge, te.grad, GRAD_RTOL, "d projection vs full logits")


@pytest.mark.parametrize("axis", [0, 1])
def test_causal_chunked_loss_on_packed_rows_matches_jax(axis):
    rng = np.random.default_rng(3)
    V, B, S = 100, 3, 20
    docs = [rng.integers(1, V, size=int(n)) for n in rng.integers(2, 12, 12)]
    packed = jax_pack_documents(docs, S)
    port_packed = pack_documents(docs, S)
    for k in packed:
        assert_equal(port_packed[k], packed[k], k)
    ids, seg = packed["input_ids"][:B], packed["segment_ids"][:B]
    hidden = rng.normal(size=(B, S, D)).astype(np.float32)
    emb = (rng.normal(size=(V, D)) * 0.5).astype(np.float32)
    emb_in = emb if axis == 0 else np.ascontiguousarray(emb.T)
    want, (jh, je) = jax.value_and_grad(
        lambda hh, ee: jax_causal_chunked(
            hh, ee, jnp.asarray(ids), chunk_size=32, vocab_axis=axis,
            segment_ids=jnp.asarray(seg)), argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(emb_in))
    th = torch.tensor(hidden, requires_grad=True)
    te = torch.tensor(emb_in, requires_grad=True)
    loss = causal_lm_chunked_loss(th, te, torch.from_numpy(ids),
                                  chunk_size=32, vocab_axis=axis,
                                  segment_ids=torch.from_numpy(seg))
    loss.backward()
    assert_close(loss.item(), float(want), LOSS_RTOL, "packed loss")
    assert_close(th.grad, np.asarray(jh), GRAD_RTOL, "d hidden")
    assert_close(te.grad, np.asarray(je), GRAD_RTOL, "d projection")


class _LiveChunks(TorchDispatchMode):
    """Counts the [N, C]-shaped float tensors alive at once."""

    def __init__(self, shape):
        super().__init__()
        self.shape, self.live, self.most = tuple(shape), [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and tuple(t.shape) == self.shape:
                self.live.append(weakref.ref(t))
        self.live = [r for r in self.live if r() is not None]
        self.most = max(self.most, len(self.live))
        return out


def test_backward_holds_one_chunk_of_logits_at_a_time():
    V, C = 256, 32   # eight chunks
    h, emb, labels, _ = _inputs(V)
    th = torch.tensor(h, requires_grad=True)
    te = torch.tensor(emb, requires_grad=True)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = chunked_softmax_cross_entropy(th, te, torch.from_numpy(labels),
                                             chunk_size=C)
    assert (N, C) not in saved and (N, V) not in saved, saved
    assert max(int(np.prod(s)) for s in saved) <= V * D, saved
    mode = _LiveChunks((N, C))
    with mode:
        loss.backward()
    assert 1 <= mode.most <= 3 < V // C, mode.most


@pytest.fixture(scope="module")
def jax_pair():
    jmodel = JaxGPT2(dataclasses.replace(JaxGPT2Config.tiny(),
                                         dropout_rate=0.0))
    with use_policy(F32):
        params = jmodel.init(jax.random.key(0),
                             jnp.zeros((1, 8), jnp.int32))["params"]
    return jmodel, jax.device_get(params)


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_chunked_train_and_eval_losses_match_jax(jax_pair, packed):
    jmodel, params = jax_pair
    rng = np.random.default_rng(5)
    if packed:
        docs = [rng.integers(1, 512, size=int(n))
                for n in rng.integers(2, 14, 16)]
        batch = {k: v[:4] for k, v in jax_pack_documents(docs, 24).items()}
    else:
        batch = {"input_ids": rng.integers(0, 512, (4, 24)).astype(np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jfn = jax_loss_fn(jmodel, vocab_chunk_size=100)
    with use_policy(F32):
        (want, _), grads = jax.value_and_grad(
            lambda p: jfn(p, None, jbatch, jax.random.key(0)),
            has_aux=True)(params)
        jeval = jax_eval_step(jmodel, vocab_chunk_size=100)(
            type("S", (), {"params": params})(), jbatch)
    cfg = dataclasses.replace(GPT2Config.tiny(), dropout_rate=0.0)
    model = GPT2LMHead(cfg, device="cpu", policy=Policy.full())
    model.load_state_dict(gpt2_params_from_jax(params, cfg))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = causal_lm_loss_fn(model, vocab_chunk_size=100)(tbatch, None)
    loss.backward()
    assert_close(loss.item(), float(want), MODEL_LOSS_RTOL, "train loss")
    port_grads = gpt2_params_to_jax(
        {n: p.grad for n, p in model.named_parameters()}, cfg)
    jgrads = jax.device_get(grads)
    for path, got in _flat(port_grads):
        assert_close(got, _get(jgrads, path), MODEL_GRAD_RTOL, path)
    got = causal_lm_eval_step(model, vocab_chunk_size=100)(None, tbatch)
    full = causal_lm_eval_step(model)(None, tbatch)
    for k in ("loss", "perplexity"):
        assert_close(got[k].item(), float(jeval[k]), MODEL_LOSS_RTOL, k)
        assert_close(got[k].item(), full[k].item(), MODEL_LOSS_RTOL, k)


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield "/".join(path + (k,)), v


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return np.asarray(tree)


def test_projection_weight_resolution_and_refusals():
    tiny = GPT2LMHead(GPT2Config.tiny(), device="cpu")
    w, axis = _lm_projection_weight(tiny)
    assert w is tiny.wte.weight and axis == 0

    class Head(torch.nn.Module):
        def __init__(self, **mods):
            super().__init__()
            for k, v in mods.items():
                setattr(self, k, v)

    lin = torch.nn.Linear(4, 10, bias=False)
    emb = torch.nn.Embedding(10, 4)
    w, axis = _lm_projection_weight(Head(lm_head=lin, embed=emb))
    assert w is lin.weight and axis == 0
    assert _lm_projection_weight(Head(embed=emb))[0] is emb.weight
    assert _lm_projection_weight(Head(embed=emb, head=lin), tied=True)[0] \
        is emb.weight
    with pytest.raises(ValueError, match="head-like"):
        _lm_projection_weight(Head(embed=emb, head=lin))
    with pytest.raises(ValueError, match="tie_word_embeddings=False"):
        _lm_projection_weight(Head(embed=emb), tied=False)
    with pytest.raises(ValueError, match="neither"):
        _lm_projection_weight(Head(other=lin))
    with pytest.raises(ValueError, match="chunk_size"):
        chunked_softmax_cross_entropy(torch.zeros(2, 4), emb.weight,
                                      torch.zeros(2), chunk_size=0)
