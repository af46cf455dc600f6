"""Data parallelism in the port, over gloo process groups on the CPU.

* The process-group facade: each rank's ``all_reduce`` (every
  ``ReduceOp``) and ``broadcast`` of its row equal the JAX facade's
  single-controller result for the same rows (leading participant dim),
  within 1 f32 ulp of the largest magnitude (sums in another order);
  ``all_gather`` gives every row, exactly.
* ``DataParallel`` at world size 2 equals the port's single-process
  step on the same global batch: three SGD steps of a tiny ResNet whose
  BatchNorm statistics are the global batch's, compared in the loss of
  every step (averaged over the ranks) to 1e-5, in every parameter to
  1e-4 and in the running statistics to 1e-5, relative to the largest
  magnitude (the ranks' gradients are averaged by DDP and the global
  statistics summed as sum / sum of squares, in another order than one
  process's).
* The GPT-2 recipe's ``--strategy dp`` under torchrun's environment
  equals ``--strategy single`` on the same global batches, at 1 and 2
  microbatches a step, both in f32
  without dropout (``torch_dp_workers.f32_gpt2_recipe``): the logged
  losses to 1e-5 and the parameters after clip + AdamW steps to 3e-6
  absolute (1% of lr), the key bias left out as in
  tests/test_torch_train.py.
* With gradient accumulation, DDP's allreduce runs once a step.
* The ResNet-50 recipe trains alone (a world of one, gloo) on the CPU,
  also with each flag ported since it first refused (``--strategy
  zero1``, ``--data-dir``, ``--ema-decay``, ``--tensorboard-dir``), and
  the unported strategies and mesh axes refuse by name.

Every world is joined under a timeout that fails the test.
"""

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.runtime import distributed as jax_dist
from pytorch_distributed_tpu_torch import parallel
from pytorch_distributed_tpu_torch.recipes import gpt2 as gpt2_recipe
from pytorch_distributed_tpu_torch.recipes import resnet50_imagenet
from pytorch_distributed_tpu_torch.runtime import distributed as dist
from pytorch_distributed_tpu_torch.runtime.mesh import (
    MeshSpec,
    data_axes,
    make_mesh,
)
from tests import torch_dp_workers as workers
from tests.torch_image_files import write_image_folder
from tests.torch_parity import assert_close, assert_close_ulps

LOSS_RTOL, PARAM_RTOL, STATS_RTOL = 1e-5, 1e-4, 1e-5


def test_facade_collectives_equal_the_jax_facade():
    world = 2
    rows = workers.numpy_rows(0, world, (3, 5))
    got = workers.spawn(workers.facade, world, rows)
    jax_dist.init_process_group("cpu", world_size=world)
    try:
        want = {op.name: np.asarray(jax_dist.all_reduce(
                    rows, getattr(jax_dist.ReduceOp, op.name)))
                for op in dist.ReduceOp}
        want["broadcast1"] = np.asarray(jax_dist.broadcast(rows, src=1))
        gather = np.asarray(jax_dist.all_gather(rows))
    finally:
        jax_dist.destroy_process_group()
    for rank, res in enumerate(got):
        assert (res["world"], res["rank"]) == (world, rank)
        for key, ref in want.items():
            assert_close_ulps(res[key], ref, 1, what=f"rank {rank} {key}")
        np.testing.assert_array_equal(res["gather"], gather)


def test_data_parallel_equals_the_single_process_step():
    (losses, state), (losses1, state1) = workers.spawn(
        workers.resnet_steps, 2)
    assert losses == losses1
    for k in state:
        np.testing.assert_array_equal(state[k], state1[k], err_msg=k)
    model, step, st, batches = workers.build_resnet_step(parallel=False)
    for i, batch in enumerate(batches):
        st, metrics = step(st, batch)
        assert_close(losses[i], metrics["loss"], LOSS_RTOL, f"loss {i}")
    for name, t in model.state_dict().items():
        rtol = STATS_RTOL if "running" in name else PARAM_RTOL
        assert_close(state[name], t, rtol, name)


@pytest.mark.parametrize("accum", [1, 2])
def test_gpt2_recipe_dp_equals_single(accum):
    argv = ["--size", "tiny", "--device", "cpu", "--batch-size", "4",
            "--accum-steps", str(accum), "--seq-len", "16",
            "--steps-per-epoch", "3", "--log-every", "1"]
    (losses, state), _ = workers.spawn(workers.gpt2_recipe, 2, argv)
    recipe, undo = workers.f32_gpt2_recipe()
    try:
        trainer = recipe.main(argv + ["--strategy", "single"])
    finally:
        undo()
    want = [r["loss"] for r in trainer.history]
    assert len(losses) == len(want) == 3
    assert_close(losses, want, LOSS_RTOL, "losses")
    D = trainer.state.model.config.hidden_size
    for name, t in trainer.state.model.state_dict().items():
        got, ref = state[name], t.numpy()
        if name.endswith("attn_qkv.bias"):   # the key bias: see docstring
            got, ref = np.delete(got, np.s_[D:2 * D]), np.delete(
                ref, np.s_[D:2 * D])
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * 3e-4,
                                   err_msg=name)


def test_accumulation_syncs_gradients_once_a_step():
    """DDP's allreduce runs on the last microbatch only (``no_sync()``
    before it): one hook call per bucket a step, whatever accum_steps."""
    from pytorch_distributed_tpu_torch.train import (
        TrainState,
        build_train_step,
    )

    dist.init_process_group(device="cpu")   # a world of one
    try:
        model = torch.nn.Linear(4, 3)
        ddp = parallel.DataParallel("cpu").wrap(model)
        calls = []

        def hook(state, bucket):
            calls.append(bucket.index())
            fut = torch.futures.Future()
            fut.set_result(bucket.buffer())
            return fut

        ddp.register_comm_hook(None, hook)

        def loss_fn(mb, gen):
            return ddp(mb["x"]).square().mean(), {}

        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        batch = {"x": torch.arange(24.0).reshape(6, 4)}
        for accum in (1, 3):
            calls.clear()
            build_train_step(loss_fn, accum_steps=accum)(
                TrainState(ddp, opt), batch)
            assert calls == [0], (accum, calls)
    finally:
        dist.destroy_process_group()


def test_resnet_recipe_trains_alone_and_refuses_the_unported(tmp_path):
    # the ranks' two intra-op threads here too: the test workers share
    # the host's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(workers.RANK_THREADS)
    try:
        _recipe_runs(tmp_path)
    finally:
        torch.set_num_threads(threads)


def _recipe_runs(tmp_path):
    def argv(steps):
        return ["--device", "cpu", "--image-size", "32", "--batch-size",
                "4", "--steps-per-epoch", str(steps), "--log-every", "1",
                "--epochs", "1"]

    base = argv(2)
    trainer = resnet50_imagenet.main(base)
    assert trainer.state.step == 2 and len(trainer.history) == 2
    assert all(np.isfinite(r["loss"]) for r in trainer.history)
    assert set(trainer.last_eval_metrics) == {"loss", "accuracy",
                                              "top5_accuracy"}
    assert not dist.is_initialized()   # its own world, torn down
    # the flags this refused until they were ported (ROADMAP A6, A2, A5)
    # now train: one step each
    folders = str(tmp_path / "imagenet")
    for split, n in (("train", 2), ("val", 1)):
        write_image_folder(f"{folders}/{split}", classes=2, per_class=n,
                           size=(40, 36))
    for extra in (["--strategy", "zero1"], ["--data-dir", folders],
                  ["--ema-decay", "0.999"],
                  ["--tensorboard-dir", str(tmp_path / "tb")]):
        trainer = resnet50_imagenet.main(argv(1) + extra)
        assert trainer.state.step == 1, extra
        assert np.isfinite(trainer.history[0]["loss"]), extra
        assert not dist.is_initialized()
    with pytest.raises(NotImplementedError, match="A10"):
        resnet50_imagenet.main(base + ["--strategy", "auto"])
    with pytest.raises(NotImplementedError, match="A10"):
        gpt2_recipe.main(["--device", "cpu", "--strategy", "auto"])


def test_unported_strategies_and_axes_refuse():
    for cls in (parallel.DataParallel, parallel.ZeRO1, parallel.FSDP):
        with pytest.raises(RuntimeError, match="process group"):
            cls("cpu")
    # tp and sp (tests/test_torch_tp.py) and pp
    # (tests/test_torch_pipeline_lm.py) are ported
    assert MeshSpec(pp=2).resolve(4) == MeshSpec(dp=2, pp=2)
    assert MeshSpec(dp=2, pp=2).resolve(4).mesh_shape() == (
        (2, 1, 2, 1, 1, 1), ("dp", "fsdp", "pp", "ep", "sp", "tp"))
    assert MeshSpec().resolve(4) == MeshSpec(dp=4)
    assert data_axes() == ("dp", "fsdp")
    with pytest.raises(ValueError):
        MeshSpec(dp=2).resolve(4)
    dist.init_process_group(device="cpu")   # a world of one
    try:
        assert (dist.get_world_size(), dist.get_rank(),
                dist.get_backend()) == (1, 0, "gloo")
        x = torch.arange(3.0)
        assert torch.equal(dist.all_reduce(x, dist.ReduceOp.AVG), x)
        with pytest.raises(ValueError, match="out of range"):
            dist.broadcast(x, src=1)
        with pytest.raises(RuntimeError, match="already exists"):
            dist.init_process_group(device="cpu")
        mesh = make_mesh(MeshSpec(), device_type="cpu")
        assert mesh.mesh_dim_names == ("dp",) and mesh.size() == 1
        strategy = parallel.DataParallel("cpu")
        batch = strategy.shard_batch({"x": np.arange(6)})
        assert torch.equal(batch["x"], torch.arange(6))
    finally:
        dist.destroy_process_group()
