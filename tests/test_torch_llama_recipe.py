"""The port's Llama recipe (``recipes/llama_fsdp.py``) with the JAX
recipe's flags, at ``--device cpu --size tiny``:

* ``--strategy fsdp`` alone (a world of one), with ``--remat``, the
  chunked loss, accumulation and ``--ckpt-dir``: a second run with one
  more epoch restores the first run's checkpoint and goes on from its
  step;
* ``--strategy fsdp`` in a gloo world of 2 under torchrun's
  environment, at ``--fsdp 2 --dp 1`` (each rank holds half the head)
  and at the recipe's default ``--dp -1 --fsdp 1`` (a ``(dp, fsdp)``
  mesh of ``(2, 1)``: every rank holds the whole head): both ranks log
  the losses the world of one logs on the same seed, within 1e-5 (f32
  sums over other shares of the batch);
* ``--strategy dp`` and ``zero1`` train 2 steps;
* the optimizer decays by 1e-4 (optax.adamw's default) in every group;
* the flags the port does not have raise naming their ROADMAP item.
"""

import numpy as np
import pytest

from pytorch_distributed_tpu_torch.recipes import llama_fsdp as recipe
from pytorch_distributed_tpu_torch.train import verify_checkpoint
from pytorch_distributed_tpu_torch.train.ckpt_io import checkpoint_step
from tests import torch_dp_workers
from tests import torch_fsdp_workers as workers
from tests.torch_parity import assert_close

BASE = ["--size", "tiny", "--device", "cpu", "--batch-size", "4",
        "--seq-len", "16", "--log-every", "1", "--steps-per-epoch", "2"]


def test_fsdp_alone_remat_chunked_run_resumes(tmp_path):
    argv = BASE + ["--remat", "--vocab-chunk", "100", "--accum-steps", "2",
                   "--ckpt-dir", str(tmp_path)]
    first = recipe.main(argv)
    assert first.state.step == 2
    assert all(np.isfinite(r["loss"]) for r in first.history)
    assert {g["weight_decay"] for g in
            first.state.optimizer.param_groups} == {1e-4}
    assert verify_checkpoint(str(tmp_path)) == []
    second = recipe.main(argv + ["--epochs", "2"])
    assert [r["step"] for r in second.history] == [3, 4]
    assert checkpoint_step(str(tmp_path)) == 4


@pytest.mark.parametrize("flags, mesh, rows", [
    (["--fsdp", "2", "--dp", "1"], (("fsdp",), (2,)), 256),
    ([], (("dp", "fsdp"), (2, 1)), 512)], ids=["fsdp2", "default_dp2"])
def test_fsdp_world2_logs_the_world1_losses(flags, mesh, rows):
    argv = BASE + flags + ["--vocab-chunk", "100"]
    ranks = torch_dp_workers.spawn(workers.llama_recipe, 2, argv)
    alone = recipe.main(BASE + ["--vocab-chunk", "100"])
    want = [r["loss"] for r in alone.history]
    for res in ranks:
        assert res["step"] == 2 and res["decay"] == {1e-4}
        assert res["mesh"] == mesh
        assert res["local_rows"] == (rows, 64)   # of the 512-row head
        assert_close(res["losses"], want, 1e-5, "losses")


@pytest.mark.parametrize("strategy", ["dp", "zero1"])
def test_other_strategies_train(strategy):
    trainer = recipe.main(BASE + ["--strategy", strategy])
    assert trainer.state.step == 2
    assert all(np.isfinite(r["loss"]) for r in trainer.history)


@pytest.mark.parametrize("flags, item", [
    (["--tp", "2"], "A10"), (["--sp", "2"], "A10"),
    (["--sp-mode", "ulysses"], "A10"), (["--strategy", "auto"], "A10"),
    (["--optimizer", "adafactor"], "A4")])
def test_unported_flags_raise_naming_their_item(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        recipe.main(BASE + flags)
