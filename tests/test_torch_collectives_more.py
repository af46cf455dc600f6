"""The rest of the port's process-group facade (``runtime/
distributed.py``) in a gloo world of 4, held against the JAX facade on
the same rows (its single-controller form over 4 CPU devices: row ``r``
of a JAX result is rank ``r``'s result in the port):

* ``permute`` over a ring, and over one pair, where the ranks no pair
  names receive zeros; ``permute_grad``'s gradient is the cotangent sent
  back along the inverse pairs (zeros on a rank that sent nothing);
* ``gather`` to rank 2 and ``reduce`` (sum, max) to rank 1 hold the JAX
  value there and None elsewhere; ``scatter`` from rank 0;
* ``all_to_all_grad``'s output and gradient (an equal-block all-to-all is
  its own inverse);
* ``monitored_barrier``, ``all_gather_object``, ``scatter_object_list``
  and ``broadcast_object_list``;
* a ``new_group`` of ranks 1 and 3: ``all_reduce``, ``all_gather`` and
  ``broadcast`` against the JAX subgroup collectives, ``permute`` inside
  it over point-to-point, and a bystander's collective refused.
"""

import numpy as np
import pytest

import pytorch_distributed_tpu as jax_ptd
from tests import torch_dp_workers
from tests import torch_tp_workers as workers

WORLD = 4


@pytest.fixture(scope="module")
def rows():
    return np.random.default_rng(0).normal(size=(WORLD, 2, 3)).astype(
        np.float32)


@pytest.fixture(scope="module")
def ranks(rows):
    return torch_dp_workers.spawn(workers.collectives, WORLD, rows)


@pytest.fixture
def jax_world():
    jax_ptd.init_process_group("cpu", world_size=WORLD)
    yield jax_ptd
    jax_ptd.destroy_process_group()


def test_permute_and_its_zero_fill_equal_the_jax_facade(ranks, rows,
                                                         jax_world):
    ring = [(i, (i + 1) % WORLD) for i in range(WORLD)]
    want_ring = np.asarray(jax_world.permute(rows, ring))
    want_pair = np.asarray(jax_world.permute(rows, [(0, 3)]))
    assert not want_pair[[0, 1, 2]].any()
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["ring"], want_ring[r])
        np.testing.assert_array_equal(res["pair"], want_pair[r])


def test_permute_gradient_goes_back_along_the_inverse_pairs(ranks, rows):
    w = [np.arange(6, dtype=np.float32).reshape(2, 3) * (r + 1)
         for r in range(WORLD)]
    for r, res in enumerate(ranks):
        # rank r sent to r + 1, whose cotangent comes back
        np.testing.assert_array_equal(res["ring_grad"], w[(r + 1) % WORLD])
        want = w[3] if r == 0 else np.zeros_like(w[0])
        np.testing.assert_array_equal(res["pair_grad"], want)


def test_gather_reduce_scatter_hold_the_jax_value_on_their_rank(
        ranks, rows, jax_world):
    gathered = np.asarray(jax_world.gather(rows, dst=2))
    summed = np.asarray(jax_world.reduce(rows, dst=1))
    maxed = np.asarray(jax_world.reduce(rows, dst=1,
                                        op=jax_world.ReduceOp.MAX))
    scattered = np.asarray(jax_world.scatter(rows, src=0))
    for r, res in enumerate(ranks):
        if r == 2:
            np.testing.assert_array_equal(res["gather"], gathered)
        else:
            assert res["gather"] is None
        if r == 1:
            np.testing.assert_allclose(res["reduce"], summed, rtol=1e-6)
            np.testing.assert_array_equal(res["reduce_max"], maxed)
        else:
            assert res["reduce"] is None and res["reduce_max"] is None
        np.testing.assert_array_equal(res["scatter"], scattered[r])


def test_all_to_all_grad_is_its_own_inverse(ranks, rows):
    # rank j's input is its row tiled WORLD times: block r goes to rank r
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["a2a"], np.concatenate(rows))
        wb = np.arange(res["a2a"].size, dtype=np.float32).reshape(
            res["a2a"].shape)
        step = wb.shape[0] // WORLD
        # rank r's block j reached rank j as its block r, whose cotangent
        # is wb's block r there
        np.testing.assert_array_equal(
            res["a2a_grad"], np.tile(wb[r * step:(r + 1) * step],
                                     (WORLD, 1)))


def test_object_collectives(ranks):
    for r, res in enumerate(ranks):
        assert res["objects"] == [{"rank": j, "pad": "x" * j}
                                  for j in range(WORLD)]
        assert res["scattered"] == f"to {r}"
        assert res["broadcast_objects"] == [3, "from me"]


def test_subgroup_collectives_equal_the_jax_subgroup(ranks, rows,
                                                     jax_world):
    sub = jax_world.new_group([1, 3])
    want_sum = np.asarray(jax_world.all_reduce(rows, group=sub))
    want_gather = np.asarray(jax_world.all_gather(rows, group=sub))
    want_bcast = np.asarray(jax_world.broadcast(rows, src=3, group=sub))
    for r, res in enumerate(ranks):
        assert res["sub_member"] == (r in (1, 3))
        if r in (1, 3):
            np.testing.assert_allclose(res["sub_sum"], want_sum, rtol=1e-6)
            np.testing.assert_array_equal(res["sub_gather"], want_gather)
            np.testing.assert_array_equal(res["sub_bcast"], want_bcast)
        else:
            assert res["refused"]
    # member 0 (rank 1) sent to member 1 (rank 3) point-to-point
    np.testing.assert_array_equal(ranks[3]["sub_perm"], rows[1])
    np.testing.assert_array_equal(ranks[1]["sub_perm"],
                                  np.zeros_like(rows[1]))
