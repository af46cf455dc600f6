"""The compressed sync as a DDP communication hook
(``DataParallel.wrap(grad_compress=...)``), port against port, and the
port's flat collectives against the JAX facade.

* Three steps of ResNet-18's stages (width 16) at world 2 over gloo
  through the hook equal, to the bit, three steps of the same model
  (not in DDP) whose step
  averages its gradients with ``sync_grads``, for bf16, fp16 and int8
  (per-leaf blocks and residuals keyed by parameter, whatever DDP's
  buckets); every rank ends with the same parameters.
* ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
  ``reduce_scatter`` and ``all_to_all`` (int8 and bf16 tensors among
  them) equal the JAX facade's multi-process rows.
* A world of one leaves every gradient as it is.
"""

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu_torch.parallel import overlap
from pytorch_distributed_tpu_torch.parallel.ddp import (
    compress_hook,
    sync_grads,
)
from pytorch_distributed_tpu_torch.runtime import distributed as dist
from tests import torch_compress_workers as cw
from tests import torch_dp_workers as workers


@pytest.fixture(scope="module")
def hook_runs():
    return workers.spawn(cw.hook_vs_sync, 2, cw.KINDS, timeout_s=300)


@pytest.mark.parametrize("kind", cw.KINDS)
def test_ddp_hook_equals_sync_grads(hook_runs, kind):
    for res in hook_runs:
        (h_losses, hooked), (s_losses, synced) = (res[(kind, True)],
                                                  res[(kind, False)])
        assert h_losses == s_losses
        assert all(np.isfinite(h_losses))
        for name, p in synced.items():
            np.testing.assert_array_equal(hooked[name], p, err_msg=name)
    # the ranks agree to the bit
    for name, p in hook_runs[0][(kind, True)][1].items():
        np.testing.assert_array_equal(hook_runs[1][(kind, True)][1][name], p)


def test_world_of_one_is_the_identity():
    x = torch.randn(5000)
    dist.init_process_group(device="cpu")
    try:
        for q8 in (False, True):
            assert torch.equal(overlap.ring_all_reduce(x, q8=q8), x)
        grads = {"w": torch.randn(3, 4)}
        assert sync_grads(grads, "int8") is grads
        assert compress_hook("bf16").kind == "bf16"
        with pytest.raises(ValueError, match="grad_compress"):
            compress_hook("fp8")
        with pytest.raises(ValueError, match="unknown grad compression"):
            sync_grads(grads, "fp8")
    finally:
        dist.destroy_process_group()


def test_flat_collectives_equal_the_jax_facade():
    from pytorch_distributed_tpu.runtime import distributed as jax_dist

    world = 2
    rows = workers.numpy_rows(4, world, (world * 4,))
    got = workers.spawn(cw.facade_flat, world, rows)
    jax_dist.init_process_group("cpu", world_size=world)
    try:
        gather = np.asarray(jax_dist.all_gather_into_tensor(rows))
        reduced = np.asarray(jax_dist.reduce_scatter(rows))
        a2a = np.asarray(jax_dist.all_to_all(rows))
    finally:
        jax_dist.destroy_process_group()
    for r, res in enumerate(got):
        np.testing.assert_array_equal(res["gather"], gather.reshape(-1))
        chunk = reduced.reshape(world, -1)[r]
        np.testing.assert_allclose(res["rs_tensor"], chunk, rtol=1e-6)
        np.testing.assert_allclose(res["rs_rows"], chunk, rtol=1e-6)
        np.testing.assert_allclose(res["rs_avg"], chunk / world, rtol=1e-6)
        np.testing.assert_array_equal(res["a2a"], a2a[r])
        blocks = [rows[j].reshape(world, -1)[r] for j in range(world)]
        np.testing.assert_array_equal(
            res["a2a_int8"], np.concatenate(blocks).astype(np.int8))
        np.testing.assert_array_equal(
            res["a2a_bf16"], torch.from_numpy(np.concatenate(blocks)).to(
                torch.bfloat16).float().numpy())
        offs = np.cumsum([0] + [j + 1 for j in range(world)])
        np.testing.assert_array_equal(res["a2a_split"], np.concatenate(
            [rows[j][offs[r]:offs[r + 1]] for j in range(world)]))
