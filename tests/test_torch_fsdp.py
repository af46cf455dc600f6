"""FSDP in the port (``parallel.FSDP``: FSDP2's ``fully_shard`` on each
Llama block and the root, full shard) in gloo worlds of 2 (``fsdp`` 2)
and 4 (HSDP: ``MeshSpec(dp=2, fsdp=2)``, the shards replicated over
``dp``), held against one process on the same seeded weights and batches
(``tests/torch_fsdp_workers.py``; f32 products, ``Policy.full()``, the
chunked-vocab loss, clip(1.0) then AdamW(1e-2, decay 1e-4)).

* The seeded init is the same at worlds 1, 2 and 4, to the bit: each
  rank keeps its rows of one whole draw per tensor.
* One chunked-loss backward: the head's gradient, reduce-scattered from
  the gathered head the loss multiplied by, and the global norm the clip
  takes (under HSDP summed over the shards of one replica, never over
  the replicas), equal the single process's. Limits relative to the
  reference's largest magnitude: 1e-5 for gradients (each rank sums its
  share of the tokens, then the ranks' shares are averaged), 1e-6 for
  the norm.
* One step, then three of two microbatches: losses (each rank's over
  its share, averaged over the ranks as the Trainer logs them) within
  1e-5; each
  leaf's update within 1e-3 of its norm (Adam turns a gradient near its
  1e-8 epsilon into an lr-sized step set by rounding noise, so single
  entries are not held; a wrong update moves the whole leaf).
* The mesh, the mesh specs against the JAX ``MeshSpec``, and each rank's
  batch rows against the JAX loader's rank slice, integer-equal.
"""

import numpy as np
import pytest

from pytorch_distributed_tpu.data.loader import DataLoader as JaxDataLoader
from pytorch_distributed_tpu.runtime.mesh import MeshSpec as JaxMeshSpec
from pytorch_distributed_tpu_torch import parallel
from pytorch_distributed_tpu_torch.runtime.mesh import MeshSpec
from tests import torch_dp_workers
from tests import torch_fsdp_workers as workers
from tests.torch_parity import assert_close, assert_equal

GRAD_RTOL, NORM_RTOL, LOSS_RTOL, UPDATE_RTOL = 1e-5, 1e-6, 1e-5, 1e-3


MESHES = {"fsdp2": (2, dict(dp=1, fsdp=-1)),
          "hsdp2x2": (4, dict(dp=2, fsdp=2))}


@pytest.fixture(scope="module", params=sorted(MESHES))
def ranks(request):
    """The ranks' results, by rank, on one of ``MESHES``."""
    world, spec = MESHES[request.param]
    return torch_dp_workers.spawn(workers.fsdp_steps, world, spec)


@pytest.fixture(scope="module")
def single():
    model, state = workers.build(None)
    res = {"init": workers.snapshot(model, state)["params"]}
    res["head_grad"], res["norm"] = workers.head_grad_and_norm(
        model, None, workers.batches(seed=7, n=1)[0])
    res["losses1"] = workers.run_steps(model, state, None,
                                       workers.batches()[:1], 1)
    res["after1"] = workers.snapshot(model, state)["params"]
    res["losses3"] = workers.run_steps(model, state, None,
                                       workers.batches()[1:], workers.ACCUM)
    res["after3"] = workers.snapshot(model, state)
    return res


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v)


def test_seeded_init_is_the_same_at_every_world(ranks, single):
    want = dict(_flat(single["init"]))
    for res in ranks:
        got = dict(_flat(res["init"]))
        assert sorted(got) == sorted(want)
        for path, arr in got.items():
            np.testing.assert_array_equal(arr, want[path], err_msg=path)
    # each rank held only its rows: uneven dims split 255 + 254, 49 + 48
    # (under HSDP, ranks 0, 1 are replica 0's shards and 2, 3 replica 1's)
    rows = [r["local_rows"] for r in ranks]
    for r0, r1 in zip(rows[0::2], rows[1::2]):
        assert (r0["embed.weight"][0], r1["embed.weight"][0]) == (255, 254)
        assert (r0["layers.0.gate.weight"][0],
                r1["layers.0.gate.weight"][0]) == (49, 48)
        assert r1["layers.1.k.weight"] == (8, 64)   # half of the kv head


def test_chunked_loss_head_gradient_equals_unsharded(ranks, single):
    for res in ranks:
        assert_close(res["head_grad"], single["head_grad"], GRAD_RTOL,
                     "d(lm_head)")


def test_clip_norm_is_the_unsharded_norm(ranks, single):
    for res in ranks:
        assert_close(res["norm"], single["norm"], NORM_RTOL, "global norm")
    assert len({r["norm"] for r in ranks}) == 1


def _updates_close(got, before, want, what):
    before = dict(_flat(before))
    want = dict(_flat(want))
    for path, arr in _flat(got):
        ref = want[path].astype(np.float64) - before[path]
        err = np.linalg.norm(arr.astype(np.float64) - want[path])
        assert err <= UPDATE_RTOL * np.linalg.norm(ref), (what, path, err)


@pytest.mark.parametrize("steps", [1, 3], ids=["one_step",
                                               "three_steps_accum2"])
def test_fsdp_steps_equal_the_single_process(ranks, single, steps):
    key = "losses1" if steps == 1 else "losses3"
    mean = np.mean([r[key] for r in ranks], axis=0)
    assert_close(mean, single[key], LOSS_RTOL, key)
    for res in ranks:
        if steps == 1:
            _updates_close(res["after1"], single["init"], single["after1"],
                           "step 1")
        else:
            _updates_close(res["after3"]["params"], single["after1"],
                           single["after3"]["params"], "steps 2-3")
            assert res["after3"]["step"] == single["after3"]["step"] == 3
            for key in ("exp_avg", "exp_avg_sq"):
                for path, arr in _flat(res["after3"][key]):
                    want = dict(_flat(single["after3"][key]))[path]
                    assert_close(arr, want, 1e-3, f"{key} {path}")


def test_mesh_and_specs_resolve_as_the_jax_mesh(ranks):
    for spec in (dict(fsdp=2), dict(dp=-1), dict(dp=2, fsdp=2),
                 dict(dp=1, fsdp=-1), dict(dp=-1, fsdp=2)):
        want = JaxMeshSpec(**spec).resolve(4)
        got = MeshSpec(**spec).resolve(4)
        assert got.sizes() == want.sizes(), spec
    assert MeshSpec(dp=2, fsdp=2).resolve(4).mesh_shape() == (
        (2, 2), ("dp", "fsdp"))
    # dp > 1 alone: FSDP replicates over dp on a (dp, 1) mesh
    assert MeshSpec().resolve(2).mesh_shape() == ((2, 1), ("dp", "fsdp"))
    assert MeshSpec(fsdp=-1, dp=1).resolve(2).mesh_shape() == (
        (2,), ("fsdp",))
    assert MeshSpec().resolve(1).mesh_shape() == ((1,), ("dp",))
    want = {2: (("fsdp",), (2,)), 4: (("dp", "fsdp"), (2, 2))}[len(ranks)]
    for res in ranks:
        assert res["mesh"] == want
    with pytest.raises(ValueError):
        MeshSpec(dp=2, fsdp=2).resolve(2)
    with pytest.raises(NotImplementedError, match="A10"):
        MeshSpec(fsdp=2, tp=2)


def test_batch_rows_equal_the_jax_loaders_rank_slice(ranks, monkeypatch):
    from pytorch_distributed_tpu.runtime import distributed as jax_dist

    world = len(ranks)
    loader = JaxDataLoader(list(range(4)), 2, shuffle=False)
    for rank, res in enumerate(ranks):
        ring = type("Ring", (), {"world_size": world, "rank": rank})()
        monkeypatch.setattr(jax_dist, "multiprocess_ring", lambda r=ring: r)
        for n, rows in res["rows"].items():
            assert_equal(rows, loader._rank_slice(np.arange(n)),
                         f"rank {rank} of {n}")


def test_global_norm_sums_f64_in_f64():
    """An f64 model's clip takes its norm in f64 (as optax does in the
    gradients' dtype), and lower precisions in f32."""
    import torch

    from pytorch_distributed_tpu_torch import optim

    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=s) * 10 for s in ((300, 7), (1000,), (3,))]
    want = np.sqrt(sum((a ** 2).sum() for a in arrays))
    got = optim.global_norm([torch.from_numpy(a) for a in arrays])
    assert got.dtype == torch.float64
    assert abs(got.item() - want) <= 1e-14 * want
    got32 = optim.global_norm([torch.from_numpy(a).bfloat16()
                               for a in arrays])
    assert got32.dtype == torch.float32


def test_fsdp_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        parallel.FSDP("cpu")
