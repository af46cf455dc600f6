"""The port's GPipe form (``parallel/pipeline.py``) against the JAX
``pipeline_forward`` on the conftest's CPU devices.

The port runs one process per stage: one gloo world of 4, spawned once,
runs ``pipeline_forward`` of a tanh-dense stage at ``pp`` 2 (as ``dp 2 x
pp 2``, stage ``rank % 2``) and at ``pp`` 4 over the same stage-stacked
weights and microbatches as the JAX function on ``MeshSpec(dp=-1,
pp=S)``. Outputs (on every stage) and every gradient of
``sum(y ** 2)`` are held to the JAX ones: a stage's row of the stacked
gradients is the JAX gradient's row, and stage 0, which takes the
microbatches in, holds their whole JAX gradient (the others zeros).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_distributed_tpu as ptd
from pytorch_distributed_tpu.parallel.pipeline import (
    merge_microbatches as jax_merge,
    pipeline_forward as jax_pipeline_forward,
    split_microbatches as jax_split,
)
from pytorch_distributed_tpu.runtime.mesh import MeshSpec as JaxMeshSpec
from pytorch_distributed_tpu_torch.parallel import (
    merge_microbatches,
    pipeline_forward,
    split_microbatches,
)
from pytorch_distributed_tpu_torch.parallel.pipeline import stage_box
from tests import torch_dp_workers
from tests import torch_pipeline_workers as workers
from tests.torch_parity import assert_close

D, M, MB = 8, 4, 4   # width, microbatches, microbatch size
# f32 sums in the same order but on other lanes: a few ulp of the largest
OUT_RTOL, GRAD_RTOL = 1e-5, 1e-4


def _inputs(S, seed=0):
    rng = np.random.default_rng(seed)
    stacked = {
        "w": rng.normal(0, 0.5, size=(S, D, D)).astype(np.float32),
        "b": rng.normal(0, 0.1, size=(S, D)).astype(np.float32),
    }
    xs = rng.normal(size=(M, MB, D)).astype(np.float32)
    return stacked, xs


def _jax_reference(S, stacked, xs):
    ptd.init_process_group(mesh_spec=JaxMeshSpec(dp=-1, pp=S))

    def stage_fn(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    def loss(p, x):
        return jnp.sum(jax_pipeline_forward(stage_fn, p, x) ** 2)

    params = {k: jnp.asarray(v) for k, v in stacked.items()}
    # jitted: eager, the shard_map'd function compiles piece by piece
    y = jax.jit(lambda p, x: jax_pipeline_forward(stage_fn, p, x))(
        params, jnp.asarray(xs))
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params,
                                                      jnp.asarray(xs))
    ptd.destroy_process_group()
    return np.asarray(y), jax.tree_util.tree_map(np.asarray, gp), \
        np.asarray(gx)


@pytest.fixture(scope="module")
def worlds():
    inputs = {S: _inputs(S, seed=S) for S in (2, 4)}
    ranks = torch_dp_workers.spawn(workers.world, 4, [
        (f"fwd{S}", "forward_grads", inputs[S] + (dict(dp=4 // S, pp=S),))
        for S in (2, 4)], timeout_s=180)
    return inputs, ranks


@pytest.mark.parametrize("S", [2, 4])
def test_pipeline_forward_and_grads_match_jax(worlds, S):
    inputs, ranks = worlds
    stacked, xs = inputs[S]
    y, gp, gx = _jax_reference(S, stacked, xs)
    for rank, res in enumerate(ranks):
        got, stage = res[f"fwd{S}"], res[f"fwd{S}"]["stage"]
        assert stage == rank % S   # the mesh's pp coordinate
        assert_close(got["y"], y, OUT_RTOL, f"rank {rank} outputs")
        for k in ("w", "b"):
            assert_close(got[k], gp[k][stage], GRAD_RTOL,
                         f"stage {stage} grad {k}")
        # the other stages' rows of the stacked gradients stay zero
        assert got["other_rows"] == 0.0
        # stage 0 takes the microbatches in: its gradient is JAX's whole
        if stage:
            assert not got["xs"].any(), "only stage 0 takes the inputs in"
        else:
            assert_close(got["xs"], gx, GRAD_RTOL, "microbatch gradients")


def test_stage_count_mismatch_raises():
    # no process group: one stage, so a stack of 3 is a mismatch
    bad = {"w": torch.zeros(3, D, D), "b": torch.zeros(3, D)}
    with pytest.raises(ValueError, match="stages"):
        pipeline_forward(lambda p, x: x, bad, torch.zeros(M, MB, D))
    with pytest.raises(ValueError, match="stages"):
        stage_box(bad)
    one = stage_box({"w": torch.arange(4.0).reshape(1, 4)})
    assert torch.equal(one["w"], torch.arange(4.0))


def test_one_stage_is_the_sequential_stage():
    stacked, xs = _inputs(1)
    params = {k: torch.from_numpy(v) for k, v in stacked.items()}
    got = pipeline_forward(lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
                           params, torch.from_numpy(xs))
    want = torch.tanh(torch.from_numpy(xs) @ params["w"][0]
                      + params["b"][0])
    assert torch.equal(got, want)


def test_split_merge_microbatches_equal_jax():
    x = np.arange(24.0, dtype=np.float32).reshape(12, 2)
    batch = {"x": torch.from_numpy(x), "ids": torch.arange(12)}
    split = split_microbatches(batch, 4)
    want = jax_split({"x": jnp.asarray(x), "ids": jnp.arange(12)}, 4)
    for k in ("x", "ids"):
        np.testing.assert_array_equal(split[k].numpy(), np.asarray(want[k]))
    merged = merge_microbatches(split)
    want = jax_merge(want)
    for k in ("x", "ids"):
        np.testing.assert_array_equal(merged[k].numpy(), np.asarray(want[k]))
    # a bare tensor too
    assert tuple(split_microbatches(torch.from_numpy(x), 3).shape) == (
        3, 4, 2)
    with pytest.raises(ValueError, match="divisible"):
        split_microbatches(batch, 5)
