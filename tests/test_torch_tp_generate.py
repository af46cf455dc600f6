"""``generate`` on a tensor-parallel model in the port against the JAX
package's ``generate`` on the same weights (the JAX tests
``test_generate_with_tp_sharded_params``,
``test_gemma_mqa_generate_with_tp_sharded_params`` and
``test_mixtral_generate_with_ep_tp_sharded_params``: sharded params
decode token-identically through the same call). Tiny configs in f32,
weights from the JAX ``init`` through ``interop``, greedy tokens equal:

* GPT-2 at tp 2 and at fsdp 2 x tp 2, each rank's cache its 2 of 4
  heads;
* Gemma-tiny's one kv head at tp 2 (k/v whole on every rank, the cache
  the one kv head);
* Mixtral-tiny at ep 2 x tp 2 (the experts over ep, attention and the
  experts' hidden dim over tp), each rank's cache 1 of its 2 kv heads.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytorch_distributed_tpu.generation import generate as jax_generate
from pytorch_distributed_tpu.models import gemma as jax_gemma
from pytorch_distributed_tpu.models import gpt2 as jax_gpt2
from pytorch_distributed_tpu.models import mixtral as jax_mixtral
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu_torch.interop import (
    gpt2_params_from_jax,
    llama_params_from_jax,
    mixtral_params_from_jax,
)
from pytorch_distributed_tpu_torch.models.gemma import GemmaConfig
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config
from pytorch_distributed_tpu_torch.models.mixtral import MixtralConfig
from tests import torch_dp_workers
from tests import torch_gpt2_tp_workers as workers

F32 = JaxPolicy(compute_dtype=jnp.float32)
NEW = 6
FAMILIES = {
    # family: (JAX model, port config, converter, cache heads a rank)
    "gpt2": (lambda: jax_gpt2.GPT2LMHead(dataclasses.replace(
        jax_gpt2.GPT2Config.tiny(), dropout_rate=0.0)),
        dataclasses.replace(GPT2Config.tiny(), dropout_rate=0.0),
        gpt2_params_from_jax),
    "gemma": (lambda: jax_gemma.GemmaForCausalLM(
        jax_gemma.GemmaConfig.tiny()), GemmaConfig.tiny(),
        llama_params_from_jax),
    "mixtral": (lambda: jax_mixtral.MixtralForCausalLM(
        jax_mixtral.MixtralConfig.tiny()), MixtralConfig.tiny(),
        mixtral_params_from_jax),
}
CASES = {
    # case: (family, world, mesh, heads of each rank's cache)
    "gpt2_tp2": ("gpt2", 2, dict(dp=1, tp=2), 2),
    "gemma_tp2": ("gemma", 2, dict(dp=1, tp=2), 1),
    "gpt2_fsdp2_tp2": ("gpt2", 4, dict(dp=1, fsdp=2, tp=2), 2),
    "mixtral_ep2_tp2": ("mixtral", 4, dict(dp=1, ep=2, tp=2), 1),
}


@pytest.fixture(scope="module")
def run():
    ids = np.random.default_rng(0).integers(2, 500, (2, 5)).astype(np.int64)
    refs, jobs = {}, {2: {}, 4: {}}
    for family, (make, cfg, convert) in FAMILIES.items():
        jmodel = make()
        with use_policy(F32):
            params = jax.device_get(jax.jit(jmodel.init)(
                jax.random.key(0), jnp.asarray(ids, jnp.int32))["params"])
        refs[family] = (jmodel, params)
        sd = {k: v.numpy() for k, v in convert(params, cfg).items()}
        for case, (fam, world, spec, _) in CASES.items():
            if fam == family:
                jobs[world][case] = dict(family=family, cfg=cfg, spec=spec,
                                         sd=sd, ids=ids, new=NEW)

    def references():
        want = {}
        for family, (jmodel, params) in refs.items():
            with use_policy(F32):
                want[family] = np.asarray(jax_generate(
                    jmodel, params, jnp.asarray(ids, jnp.int32),
                    max_new_tokens=NEW, temperature=0.0))
        return want

    w2, w4, want = torch_dp_workers.spawn_worlds(
        (workers.generate_world, 2, jobs[2]),
        (workers.generate_world, 4, jobs[4]), timeout_s=180,
        meanwhile=references)
    return {"want": want, 2: w2, 4: w4}


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_tokens_match_jax_generate(run, case):
    family, world, _, heads = CASES[case]
    for rank, res in enumerate(run[world]):
        got = res[case]
        np.testing.assert_array_equal(got["tokens"], run["want"][family],
                                      err_msg=f"{case} rank {rank}")
        # each rank's cache holds its own heads only
        assert got["heads"] == heads, (case, rank)
