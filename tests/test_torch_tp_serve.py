"""The port's serving engine on a tensor-parallel model, the counterpart
of the JAX ``tests/test_serve.py`` engine-vs-solo checks on sharded
params: every rank runs the same host scheduler over a page pool of its
own heads, and its tick attends its heads (on the card, the paged
kernel). Tiny configs in f32, weights from the JAX ``init`` through
``interop``, two slots for three requests (slot reuse), pages of 8:

* GPT-2-tiny at tp 2 (2 of 4 heads a rank) and Llama-tiny at tp 4 (its
  2 kv heads replicate over tp 4, and each rank's pool holds the one
  its query head reads), exact and int8 pools: the greedy streams equal
  the JAX solo ``generate``'s on the same weights and cache
  quantization;
* the pool's shape is ``[pages + 1, page size, local heads, head dim]``;
* a sampled request (temperature 0.9, top-k 20, seed 5) draws the same
  tokens on every rank (the slot generators are seeded alike and the
  logits leave the model whole), and those of the world-1 engine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.generation import generate as jax_generate
from pytorch_distributed_tpu.models import gpt2 as jax_gpt2
from pytorch_distributed_tpu.models import llama as jax_llama
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu_torch.interop import (
    gpt2_params_from_jax,
    llama_params_from_jax,
)
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config
from pytorch_distributed_tpu_torch.models.llama import LlamaConfig
from tests import torch_dp_workers
from tests import torch_gpt2_tp_workers as workers

F32 = JaxPolicy(compute_dtype=jnp.float32)
NEW, P = 6, 7
SAMPLED = dict(temperature=0.9, top_k=20, seed=5)
CASES = {
    # case: (world, mesh, JAX config, port config, converter, pool heads)
    "gpt2_tp2": (2, dict(dp=1, tp=2), dataclasses.replace(
        jax_gpt2.GPT2Config.tiny(), dropout_rate=0.0),
        dataclasses.replace(GPT2Config.tiny(), dropout_rate=0.0),
        gpt2_params_from_jax, 2),
    "llama_tp4": (4, dict(dp=1, tp=4), jax_llama.LlamaConfig.tiny(),
                  LlamaConfig.tiny(), llama_params_from_jax, 1),
}


def _jax_model(case, quant):
    cfg = dataclasses.replace(CASES[case][2], kv_cache_quantize=quant)
    return (jax_gpt2.GPT2LMHead(cfg) if case.startswith("gpt2")
            else jax_llama.LlamaForCausalLM(cfg))


@pytest.fixture(scope="module")
def run():
    prompts = np.random.default_rng(1).integers(
        2, 500, (3, P)).astype(np.int64)
    jobs, params = {2: {}, 4: {}}, {}
    for case, (world, spec, _, cfg, convert, _) in CASES.items():
        with use_policy(F32):
            params[case] = jax.device_get(jax.jit(
                _jax_model(case, None).init)(
                jax.random.key(0), jnp.asarray(prompts, jnp.int32))["params"])
        sd = {k: v.numpy() for k, v in convert(params[case], cfg).items()}
        family = case.split("_")[0]
        jobs[world][case] = dict(family=family, cfg=cfg, spec=spec, sd=sd,
                                 prompts=list(prompts), new=NEW,
                                 sampled=SAMPLED)

    def references():
        want, solo = {}, {}
        for case, (world, _, _, cfg, _, _) in CASES.items():
            job = jobs[world][case]
            for quant in (None, "int8"):
                with use_policy(F32):
                    want[(case, quant)] = np.asarray(jax_generate(
                        _jax_model(case, quant), params[case],
                        jnp.asarray(prompts, jnp.int32), max_new_tokens=NEW,
                        temperature=0.0))[:, P:]
                model, _ = workers.build(
                    job["family"],
                    dataclasses.replace(cfg, kv_cache_quantize=quant), None,
                    job["sd"])
                with torch.no_grad():
                    solo[(case, quant)] = workers.serve(
                        model, job["prompts"], NEW, SAMPLED)
        return want, solo

    w2, w4, (want, solo) = torch_dp_workers.spawn_worlds(
        (workers.serve_world, 2, jobs[2]), (workers.serve_world, 4, jobs[4]),
        timeout_s=180, meanwhile=references)
    return {"want": want, "solo": solo, 2: w2, 4: w4}


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_streams_match_jax_generate(run, case, quant):
    world, _, _, cfg, _, heads = CASES[case]
    want = run["want"][(case, quant)]
    for rank, res in enumerate(run[world]):
        got = res[(case, quant)]
        for i, stream in enumerate(got["streams"][:-1]):
            assert stream == want[i].tolist(), (case, quant, rank, i)
        pages, page_size, h, hd = got["pool"]
        # the pool holds this rank's heads only
        assert (page_size, h, hd) == (8, heads, cfg.head_dim), got["pool"]
        assert run["solo"][(case, quant)]["pool"][2] == (
            cfg.num_heads if case.startswith("gpt2") else cfg.num_kv_heads)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sampled_request_draws_the_same_tokens_on_every_rank(run, case):
    world = CASES[case][0]
    for quant in (None, "int8"):
        streams = [res[(case, quant)]["streams"][-1] for res in run[world]]
        assert len(streams[0]) == NEW
        assert all(s == streams[0] for s in streams), (case, quant)
        assert streams[0] == run["solo"][(case, quant)]["streams"][-1]
