"""The port's mixture-of-experts layer (``ops/moe.py``) and GPT-2 with
expert FFNs held against the JAX package's, in f32 on the same
numpy-seeded inputs and weights:

* ``MoEMLP`` drop-free, at capacity 1.25 and at a tight capacity 0.5,
  Switch (gelu) and Mixtral (swiglu) experts: the outputs to 1e-5 of
  their largest magnitude, the load-balance loss to 1e-6 of itself, the
  gradients of the input and of every weight to 1e-4 of their largest
  magnitude (f32 sums in another order);
* the kept ``(t, k)`` pairs and their ``(expert, slot)`` equal the JAX
  dispatch tensor exactly (integer mode), and the routing over the
  whole batch of several data ranks (``route(group=...)``) puts every
  pair where the one-process routing puts it;
* ``top_k`` breaks ties to the lower index, as ``lax.top_k``;
* GPT-2 with ``moe_experts`` (``tests/test_moe_gpt2.py``'s config):
  logits, the loss with ``moe_aux_weight`` and its gradients, the
  cached decode against a full forward (drop-free), the converters
  both ways, and the distillation loss with the student's load loss.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models import gpt2 as jgpt2
from pytorch_distributed_tpu.ops import moe as jmoe
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu.train import causal_lm_loss_fn as jax_loss_fn
from pytorch_distributed_tpu_torch.interop import (
    gpt2_params_from_jax,
    gpt2_params_to_jax,
)
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from pytorch_distributed_tpu_torch.ops import moe
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.train import causal_lm_loss_fn
from tests.torch_parity import assert_close, assert_equal

F32 = JaxPolicy(compute_dtype=jnp.float32)
OUT_RTOL, AUX_RTOL, GRAD_RTOL = 1e-5, 1e-6, 1e-4
D, E, FF, K = 16, 4, 24, 2
CAPACITIES = {"dropfree": None, "cf1.25": 1.25, "tight0.5": 0.5}


def _jax_moe(cf, act):
    return jmoe.MoEMLP(num_experts=E, d_ff=FF, k=K, capacity_factor=cf,
                       activation=act)


def _params(act, seed=0):
    rng = np.random.default_rng(seed)
    p = {"router": {"kernel": rng.normal(size=(D, E)).astype(np.float32)},
         "w_in": (rng.normal(size=(E, D, FF)) / 4).astype(np.float32),
         "w_out": (rng.normal(size=(E, FF, D)) / 5).astype(np.float32)}
    if act == "swiglu":
        p["w_gate"] = (rng.normal(size=(E, D, FF)) / 4).astype(np.float32)
    return p


def _port_moe(params, cf, act):
    m = moe.MoEMLP(D, E, FF, k=K, capacity_factor=cf, activation=act,
                   policy=Policy.full(), device="cpu")
    with torch.no_grad():
        m.router.weight.copy_(torch.from_numpy(params["router"]["kernel"].T))
        for name in ("w_in", "w_gate", "w_out"):
            if name in params:
                getattr(m, name).copy_(torch.from_numpy(params[name]))
    return m


def _x(seed=1, shape=(3, 8)):
    return np.random.default_rng(seed).normal(size=shape + (D,)).astype(
        np.float32)


class _Capture:
    """``jnp`` for the JAX module, recording the dispatch tensor its
    ``"tec,td->ecd"`` einsum takes."""

    def __init__(self):
        self.dispatch = None

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        if spec == "tec,td->ecd":
            self.dispatch = np.asarray(ops[0])
        return jnp.einsum(spec, *ops, **kw)


def _jax_run(params, x, cf, act, w):
    """JAX output, aux and the gradients of ``sum(y * w) + aux``."""
    mod = _jax_moe(cf, act)

    def f(p, xx):
        y, inter = mod.apply({"params": p}, xx, mutable=["intermediates"])
        aux = inter["intermediates"]["moe_aux_loss"][0]
        return jnp.sum(y * w) + aux, (y, aux)

    with use_policy(F32):
        (_, (y, aux)), (gp, gx) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    return np.asarray(y), float(aux), jax.device_get(gp), np.asarray(gx)


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
@pytest.mark.parametrize("cap", sorted(CAPACITIES))
def test_outputs_aux_and_gradients_match_jax(cap, act):
    cf, params, x = CAPACITIES[cap], _params(act), _x()
    w = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    y_ref, aux_ref, gp_ref, gx_ref = _jax_run(params, x, cf, act, w)
    m = _port_moe(params, cf, act)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = m(xt)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    assert_close(y, y_ref, OUT_RTOL, "output")
    assert_close(aux.item(), aux_ref, AUX_RTOL, "aux")
    assert_close(xt.grad, gx_ref, GRAD_RTOL, "d input")
    assert_close(m.router.weight.grad.T, gp_ref["router"]["kernel"],
                 GRAD_RTOL, "d router")
    for name in ("w_in", "w_gate", "w_out"):
        if name in params:
            assert_close(getattr(m, name).grad, gp_ref[name], GRAD_RTOL,
                         f"d {name}")


def _port_dispatch(params, x, cf, group=None):
    """The port's dispatch tensor [T, E, C] from its routing of ``x``
    [B, S, D]."""
    tokens = torch.from_numpy(x.reshape(-1, D))
    logits = tokens @ torch.from_numpy(params["router"]["kernel"])
    _, _, idx, pos, kept, C = moe.route(logits, K, cf, group,
                                        rows=x.shape[0])
    T = tokens.shape[0]
    out = np.zeros((T, E, C), np.int64)
    for t in range(T):
        for k in range(K):
            if kept[t, k]:
                out[t, idx[t, k], pos[t, k]] += 1
    return out


@pytest.mark.parametrize("cap", ["cf1.25", "tight0.5"])
def test_kept_pairs_and_slots_equal_the_jax_dispatch(cap, monkeypatch):
    cf, params = CAPACITIES[cap], _params("gelu")
    x = _x(seed=4, shape=(4, 16))
    cap_ = _Capture()
    monkeypatch.setattr(jmoe, "jnp", cap_)
    with use_policy(F32):
        _jax_moe(cf, "gelu").apply({"params": params}, jnp.asarray(x),
                                   mutable=["intermediates"])
    want = cap_.dispatch.astype(np.int64)
    got = _port_dispatch(params, x, cf)
    assert_equal(got, want, "dispatch")
    # a tight capacity drops pairs; 1.25 keeps some overflow too at T=64
    assert want.sum() < x.shape[0] * x.shape[1] * K or cap == "cf1.25"


@pytest.mark.parametrize("n", [2, 4])
def test_routing_over_data_ranks_places_every_pair_as_one_process(
        monkeypatch, n):
    """Rank ``r`` of ``n`` routes its strided share of the rows (the
    loader's ``rank_slice``) with the others' per-row counts (the
    all-gather played in one process): every kept pair takes the
    ``(expert, slot)`` the whole batch's routing gives it."""
    params, cf = _params("gelu"), 0.5
    x = _x(seed=5, shape=(8, 6))
    whole = _port_dispatch(params, x, cf)
    shares = [x[r::n] for r in range(n)]
    counts = []
    for share in shares:
        lg = torch.from_numpy(share.reshape(-1, D)) @ torch.from_numpy(
            params["router"]["kernel"])
        _, idx = moe.top_k(torch.softmax(lg, -1), K)
        counts.append(torch.nn.functional.one_hot(idx.t().reshape(-1), E)
                      .view(K, share.shape[0], -1, E).sum(2))
    monkeypatch.setattr(
        torch.distributed, "all_gather",
        lambda every, c, group=None: [e.copy_(v) for e, v in
                                      zip(every, counts)])
    got = np.zeros_like(whole).reshape(8, 6, E, -1)
    for me in range(n):
        monkeypatch.setattr(moe, "_group_size_rank", lambda g, me=me: (n, me))
        got[me::n] = _port_dispatch(params, shares[me], cf,
                                    group=types.SimpleNamespace()).reshape(
            -1, 6, E, got.shape[-1])
    assert_equal(got.reshape(whole.shape), whole, f"dispatch over {n} ranks")


def test_top_k_breaks_ties_to_the_lower_index():
    rng = np.random.default_rng(3)
    probs = rng.integers(0, 3, size=(64, 8)).astype(np.float32) / 4
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 3)
    got_v, got_i = moe.top_k(torch.from_numpy(probs), 3)
    assert_equal(got_i, np.asarray(want_i), "indices")
    assert_close(got_v, np.asarray(want_v), 0.0, "values")


def test_refusals_and_rules():
    with pytest.raises(ValueError, match="activation"):
        moe.MoEMLP(D, E, FF, activation="relu", device="cpu")
    assert [r[0] for r in moe.moe_partition_rules()] == [
        r[0] for r in jmoe.moe_partition_rules()]
    for (_, got), (_, want) in zip(moe.moe_partition_rules(),
                                   jmoe.moe_partition_rules()):
        assert tuple(got) == tuple(want)
    assert float(moe.collect_aux_loss([])) == 0.0
    assert moe.capacity(2, 64, 1.25, 4) == jmoe.MoEMLP.__dataclass_fields__[
        "k"].default * 64 * 1.25 / 4


# -- GPT-2 with expert FFNs (tests/test_moe_gpt2.py's config) --------------

JCFG = jgpt2.GPT2Config(vocab_size=128, n_positions=32, hidden_size=32,
                        num_layers=2, num_heads=2, dropout_rate=0.0,
                        moe_experts=4, moe_k=2)
CFG = GPT2Config(vocab_size=128, n_positions=32, hidden_size=32,
                 num_layers=2, num_heads=2, dropout_rate=0.0, moe_experts=4,
                 moe_k=2)


@pytest.fixture(scope="module")
def gpt2_pair():
    jmodel = jgpt2.GPT2LMHead(JCFG)
    with use_policy(F32):
        params = jmodel.init(jax.random.key(0),
                             jnp.zeros((1, 8), jnp.int32))["params"]
    return jmodel, jax.device_get(params)


def _port_gpt2(params, **kw):
    cfg = dataclasses.replace(CFG, **kw)
    model = GPT2LMHead(cfg, device="cpu", policy=Policy.full())
    model.load_state_dict(gpt2_params_from_jax(params, cfg))
    return model


def _ids(seed=0, B=8, S=16):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (B, S)).astype(np.int32)


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v)


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return np.asarray(tree)


def test_gpt2_moe_logits_and_params_round_trip(gpt2_pair):
    jmodel, params = gpt2_pair
    model = _port_gpt2(params)
    assert "mlp_up.weight" not in dict(model.blocks[0].named_parameters())
    assert tuple(model.blocks[0].moe.w_in.shape) == (4, 32, 128)
    ids = _ids()
    with use_policy(F32):
        ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long())
    assert_close(out, ref, OUT_RTOL, "logits")
    back = gpt2_params_to_jax(model.state_dict(), CFG)
    for path, arr in _flat(back):
        np.testing.assert_array_equal(arr, _get(params, path), err_msg=path)


@pytest.mark.parametrize("chunk", [None, 48], ids=["full", "chunked"])
def test_gpt2_moe_loss_with_aux_and_grads_match_jax(gpt2_pair, chunk):
    jmodel, params = gpt2_pair
    batch = {"input_ids": _ids(seed=1)}
    jfn = jax_loss_fn(jmodel, moe_aux_weight=0.01, vocab_chunk_size=chunk)
    with use_policy(F32):
        (want, jaux), grads = jax.value_and_grad(
            lambda p: jfn(p, None, {"input_ids": jnp.asarray(
                batch["input_ids"])}, jax.random.key(0)),
            has_aux=True)(params)
    model = _port_gpt2(params)
    loss, aux = causal_lm_loss_fn(model, moe_aux_weight=0.01,
                                  vocab_chunk_size=chunk)(
        {"input_ids": torch.from_numpy(batch["input_ids"])}, None)
    loss.backward()
    assert_close(loss.item(), float(want), 1e-5, "loss")
    assert_close(aux["metrics"]["moe_aux_loss"].item(),
                 float(jaux["metrics"]["moe_aux_loss"]), AUX_RTOL, "aux")
    assert_close(aux["metrics"]["loss"].item(),
                 float(jaux["metrics"]["loss"]), 1e-5, "ce")
    port = gpt2_params_to_jax({n: p.grad for n, p in
                               model.named_parameters()}, CFG)
    jgrads = jax.device_get(grads)
    for path, got in _flat(port):
        if path.endswith("attn_qkv/bias"):
            continue   # the key bias's gradient is exactly zero
        assert_close(got, _get(jgrads, path), GRAD_RTOL, path)


def test_gpt2_moe_decode_matches_a_full_forward_drop_free(gpt2_pair):
    """Decode through the experts, drop-free (with a finite capacity the
    routing depends on how many tokens share the call, as the JAX
    config's note says)."""
    from pytorch_distributed_tpu_torch.generation import generate

    _, params = gpt2_pair
    model = _port_gpt2(params, moe_capacity_factor=None)
    prompt = torch.from_numpy(_ids(seed=2, B=2, S=5)).long()
    out = generate(model, prompt, max_new_tokens=6, device="cpu")
    with torch.no_grad():
        logits = model(out[:, :-1])
    assert_equal(logits[:, 4:].argmax(-1), out[:, 5:].numpy(),
                 "greedy = argmax of the full forward")


def test_distillation_takes_the_students_load_loss(gpt2_pair):
    """``distillation_loss_fn(moe_aux_weight=...)`` adds the student's
    weighted load loss (the teacher's routing is its own): the loss and
    its metrics against the JAX function, the student an expert GPT-2
    and the teacher the same model's weights."""
    from pytorch_distributed_tpu.train import (
        distillation_loss_fn as jax_distill,
    )
    from pytorch_distributed_tpu_torch.train.losses import (
        distillation_loss_fn,
    )

    jmodel, params = gpt2_pair
    ids = _ids(seed=4)
    jfn = jax_distill(jmodel, jmodel, params, temperature=2.0, alpha=0.5,
                      moe_aux_weight=0.01)
    with use_policy(F32):
        want, jaux = jfn(params, None, {"input_ids": jnp.asarray(ids)},
                         jax.random.key(0))
    student, teacher = _port_gpt2(params), _port_gpt2(params)
    loss, aux = distillation_loss_fn(student, teacher, temperature=2.0,
                                     alpha=0.5, moe_aux_weight=0.01)(
        {"input_ids": torch.from_numpy(ids).long()}, None)
    assert_close(loss.item(), float(want), 1e-5, "loss")
    for key in ("ce", "kl", "moe_aux_loss"):
        assert_close(aux["metrics"][key].item(),
                     float(jaux["metrics"][key]), 1e-5, key)
