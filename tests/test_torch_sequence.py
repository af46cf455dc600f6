"""Sequence parallelism in the port (``parallel/sequence.py``, the
attention dispatch, the losses' sequence shards) against the JAX
package's ``parallel/sequence.py`` on the same inputs (mirroring
tests/test_sequence.py). The port runs in one gloo world of 4
(``tests/torch_tp_workers.sp_world``), each rank on its own part of the
global q/k/v; the JAX functions run on the whole arrays over 8 virtual
CPU devices. Outputs within 2e-5 and q/k/v gradients (of ``sum(out *
w)``) within 1e-4 of the reference's largest magnitude, f32:

* ring at sp 4, causal and not; Ulysses at sp 4, causal and not; ring
  at sp 2 x tp 2 (heads split over tp); MQA under ring; Mistral's window
  under both; Ulysses' indivisible-heads error;
* Llama-tiny's logits under ring (sp 4) and Ulysses (dp 2 x sp 2)
  against the JAX model's plain forward, within ``1e-5 x max|ref|``;
* the Llama recipe (products in f32) at ``--sp 2`` (ring and
  Ulysses) and ``--tp 2`` in a gloo world of 2, and at ``--dp 2 --tp
  2``, ``--sp 2 --tp 2`` and ``--fsdp 2 --tp 2`` in one of 4: its losses
  equal the world of one's within 1e-5 relative;
* the dispatcher's refusals under a sequence-parallel mode: KV-cache
  decode, ``segment_ids``, a materialized bias, dropout, and ``bias_fn``
  under Ulysses (naming ring, which takes it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models import llama as jax_llama
from pytorch_distributed_tpu.parallel.sequence import (
    ring_attention as jax_ring,
    ulysses_attention as jax_ulysses,
)
from pytorch_distributed_tpu.runtime.mesh import MeshSpec as JaxMeshSpec
from pytorch_distributed_tpu.runtime.mesh import make_mesh as jax_make_mesh
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu_torch.models.llama import LlamaConfig
from pytorch_distributed_tpu_torch.ops.attention import (
    attention,
    dot_product_attention,
)
from pytorch_distributed_tpu_torch.parallel import sequence
from pytorch_distributed_tpu_torch.recipes import llama_fsdp
from tests import torch_dp_workers
from tests import torch_tp_workers as workers
from tests.torch_parity import assert_close

OUT_RTOL, GRAD_RTOL, LOGIT_RTOL, LOSS_RTOL = 2e-5, 1e-4, 1e-5, 1e-5
WORLD = 4


def _qkv(seed, B=2, S=32, Hq=4, Hkv=2, D=8):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(q=f(B, S, Hq, D), k=f(B, S, Hkv, D), v=f(B, S, Hkv, D),
                w=f(B, S, Hq, D))


# name: (impl, port mesh, JAX mesh, causal, window, qkv kwargs)
ATTN = {
    "ring_sp4": ("ring", dict(dp=1, sp=4), dict(dp=2, sp=4), False, None, {}),
    "ring_sp4_causal": ("ring", dict(dp=1, sp=4), dict(dp=2, sp=4), True,
                        None, {}),
    "ulysses_sp4": ("ulysses", dict(dp=1, sp=4), dict(dp=2, sp=4), False,
                    None, dict(Hq=8, Hkv=4)),
    "ulysses_sp4_causal": ("ulysses", dict(dp=1, sp=4), dict(dp=2, sp=4),
                           True, None, dict(Hq=8, Hkv=4)),
    "ring_sp2_tp2": ("ring", dict(dp=1, sp=2, tp=2),
                     dict(dp=2, sp=2, tp=2), True, None, {}),
    "ring_mqa": ("ring", dict(dp=1, sp=4), dict(dp=2, sp=4), True, None,
                 dict(Hkv=1)),
    "ring_window": ("ring", dict(dp=1, sp=4), dict(dp=2, sp=4), True, 5, {}),
    "ulysses_window": ("ulysses", dict(dp=1, sp=4), dict(dp=2, sp=4), True,
                       5, dict(Hq=8, Hkv=4)),
}
# name: (impl, port mesh)
LLAMA = {"llama_ring": ("ring", dict(dp=1, sp=4)),
         "llama_ulysses": ("ulysses", dict(dp=2, sp=2))}


def _jax_attn(name, data):
    impl, _, jmesh, causal, window, _ = ATTN[name]
    mesh = jax_make_mesh(JaxMeshSpec(**jmesh))
    fn = jax_ring if impl == "ring" else jax_ulysses

    def loss(q, k, v):
        out = fn(q, k, v, causal=causal, window=window, mesh=mesh)
        return (out * data["w"]).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                 has_aux=True))(
        jnp.asarray(data["q"]), jnp.asarray(data["k"]),
        jnp.asarray(data["v"]))
    return {"out": np.asarray(out),
            **{k: np.asarray(g) for k, g in zip(("dq", "dk", "dv"), grads)}}


@pytest.fixture(scope="module")
def llama_ref():
    jmodel = jax_llama.LlamaForCausalLM(jax_llama.LlamaConfig.tiny())
    with use_policy(JaxPolicy(compute_dtype=jnp.float32)):
        params = jax.device_get(jmodel.init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
        ids = np.random.default_rng(5).integers(0, 512, (2, 32))
        logits = np.asarray(jmodel.apply({"params": params},
                                         jnp.asarray(ids, jnp.int32)))
    return params, ids, logits


@pytest.fixture(scope="module")
def ranks(llama_ref):
    params, ids, _ = llama_ref
    attn = {}
    for i, (name, (impl, mesh, _, causal, window, kw)) in enumerate(
            sorted(ATTN.items())):
        attn[name] = dict(_qkv(i, **kw), impl=impl, mesh=mesh,
                          causal=causal, window=window)
    llama = {name: dict(impl=impl, mesh=mesh, cfg=LlamaConfig.tiny(),
                        params=params, ids=ids)
             for name, (impl, mesh) in LLAMA.items()}
    refusals = {"indivisible": dict(mesh=dict(dp=1, sp=4),
                                    q_shape=(1, 4, 4, 8),
                                    kv_shape=(1, 4, 2, 8))}
    return attn, torch_dp_workers.spawn(
        workers.sp_world, WORLD,
        {"attn": attn, "llama": llama, "refusals": refusals})


@pytest.mark.parametrize("name", sorted(ATTN))
def test_attention_and_gradients_match_jax(ranks, name):
    attn, results = ranks
    want = _jax_attn(name, attn[name])
    for res in results:
        got = res[name]
        for key in ("out", "dq", "dk", "dv"):
            ref = workers.local_part(want[key], got["coord"], got["sizes"])
            assert_close(got[key], ref,
                         OUT_RTOL if key == "out" else GRAD_RTOL,
                         f"{name} {key} at {got['coord']}")


def test_ulysses_refuses_indivisible_heads(ranks):
    for res in ranks[1]:
        assert "divisible" in res["indivisible"]


@pytest.mark.parametrize("name", sorted(LLAMA))
def test_llama_forward_under_each_mode_matches_the_plain_forward(
        ranks, llama_ref, name):
    _, _, logits = llama_ref
    for res in ranks[1]:
        got = res[name]
        want = workers.local_part(logits, got["coord"], got["sizes"],
                                  heads=False)
        assert_close(got["logits"], want, LOGIT_RTOL,
                     f"{name} at {got['coord']}")


RECIPE = ["--size", "tiny", "--device", "cpu", "--backend", "gloo",
          "--batch-size", "4", "--seq-len", "16", "--steps-per-epoch", "3",
          "--log-every", "1", "--vocab-chunk", "100"]


@pytest.fixture(scope="module")
def recipe_sp1():
    with workers.recipe_f32():
        want = [r["loss"] for r in llama_fsdp.main(RECIPE).history]
    assert len(want) == 3
    return want


@pytest.mark.parametrize("world, meshes", [
    (2, [["--sp", "2"], ["--sp", "2", "--sp-mode", "ulysses"],
         ["--tp", "2", "--remat"]]),
    # tp under HSDP and beside sp and fsdp, on 4 ranks
    (4, [["--dp", "2", "--tp", "2"], ["--sp", "2", "--tp", "2"],
         ["--fsdp", "2", "--tp", "2"]]),
], ids=["world2", "world4"])
def test_recipe_losses_at_sp2_and_tp2_equal_sp1(recipe_sp1, world, meshes):
    argvs = [RECIPE + m for m in meshes]
    got = torch_dp_workers.spawn(workers.recipe_runs, world, argvs)
    for res in got:
        for argv, losses in zip(argvs, res):
            assert_close(losses, recipe_sp1, LOSS_RTOL,
                         " ".join(argv[-4:]))


def test_dispatch_refuses_what_sequence_shards_cannot_do():
    q = torch.zeros(1, 4, 2, 8)
    with sequence.sequence_parallel("sp", "ring"):
        assert sequence.sequence_parallel_mode() == ("sp", "ring")
        for kw, what in (
                (dict(q_offset=torch.zeros(1, dtype=torch.long)),
                 "KV-cache decode"),
                (dict(segment_ids=torch.zeros(1, 4)), "segment_ids"),
                (dict(bias=torch.zeros(1, 2, 4, 4)), "materialized"),
                (dict(dropout_rate=0.1), "dropout")):
            with pytest.raises(NotImplementedError, match=what):
                attention(q, q, q, causal=True, **kw)
        # ring evaluates a bias_fn per block (here one rank's one block)
        bias = torch.randn(2, 4, 4, generator=torch.Generator().manual_seed(0))
        got = attention(q, q, q, causal=True, bias_fn=lambda a, b: bias)
        torch.testing.assert_close(got, dot_product_attention(
            q, q, q, causal=True, bias=bias[None]))
    with sequence.sequence_parallel("sp", "ulysses"):
        with pytest.raises(NotImplementedError, match="ring"):
            attention(q, q, q, causal=True, bias_fn=lambda a, b: bias)
    assert sequence.sequence_parallel_mode() == (None, "ring")
    with pytest.raises(ValueError, match="impl"):
        sequence.enable_sequence_parallel("sp", "stripes")
