"""The port's GPT-2 recipe with the JAX recipe's flags, at ``--device cpu
--size tiny``:

* ``--strategy zero1 --remat --vocab-chunk 64 --ckpt-dir``: a second run
  with one more epoch restores the first run's checkpoint and goes on
  from its step and its batch.
* SIGTERM in the middle of a run: the recipe writes a committed
  checkpoint and exits ``EX_TEMPFAIL`` (75).
* ``--text-file`` (windows) and ``--text-file --pack`` train on a local
  corpus, the model's vocabulary shrunk to the tokenizer's.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from pytorch_distributed_tpu_torch.recipes import gpt2 as recipe
from pytorch_distributed_tpu_torch.train import EX_TEMPFAIL, verify_checkpoint
from pytorch_distributed_tpu_torch.train.checkpoint import load_sampler_cursor
from pytorch_distributed_tpu_torch.train.ckpt_io import checkpoint_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--size", "tiny", "--device", "cpu", "--batch-size", "4",
        "--seq-len", "16", "--log-every", "1"]


def test_zero1_remat_chunked_run_resumes_from_its_checkpoint(tmp_path):
    argv = BASE + ["--strategy", "zero1", "--remat", "--vocab-chunk", "64",
                   "--accum-steps", "2", "--steps-per-epoch", "2",
                   "--ckpt-dir", str(tmp_path)]
    first = recipe.main(argv + ["--epochs", "1"])
    assert first.state.step == 2 and first.last_eval_metrics
    assert verify_checkpoint(str(tmp_path)) == []
    assert load_sampler_cursor(str(tmp_path)) == {"step": 2, "epoch": 1,
                                                  "offset": 0}
    second = recipe.main(argv + ["--epochs", "2"])
    assert [r["step"] for r in second.history] == [3, 4]
    assert [r["epoch"] for r in second.history] == [1, 1]
    assert all(np.isfinite(r["loss"]) for r in second.history)
    assert checkpoint_step(str(tmp_path)) == 4


def test_sigterm_checkpoints_and_exits_tempfail(tmp_path):
    cmd = [sys.executable, "-m", "pytorch_distributed_tpu_torch.recipes.gpt2",
           *BASE, "--accum-steps", "1", "--steps-per-epoch", "100000",
           "--ckpt-dir", str(tmp_path)]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=dict(os.environ,
                            PYTHONPATH=ROOT), stderr=subprocess.PIPE,
                            stdout=subprocess.DEVNULL, text=True)
    try:
        deadline = time.time() + 240
        for line in proc.stderr:
            if " step 3 " in line:
                break
            assert time.time() < deadline, "the recipe never reached step 3"
        proc.send_signal(signal.SIGTERM)
        proc.stderr.read()
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == EX_TEMPFAIL
    step = checkpoint_step(str(tmp_path))
    assert step is not None and step >= 3
    assert verify_checkpoint(str(tmp_path)) == []
    assert load_sampler_cursor(str(tmp_path))["step"] == step


def _corpus(path, seed=0, paragraphs=60):
    rng = np.random.default_rng(seed)
    words = ["".join(rng.choice(list("abcdefgh"), rng.integers(2, 6)))
             for _ in range(40)]
    text = "\n\n".join(" ".join(rng.choice(words, rng.integers(10, 60)))
                       for _ in range(paragraphs))
    path.write_text(text, encoding="utf-8")
    return str(path)


@pytest.mark.parametrize("pack", [False, True], ids=["windows", "packed"])
def test_text_file_trains(tmp_path, pack):
    corpus = _corpus(tmp_path / "corpus.txt")
    argv = ["--size", "tiny", "--device", "cpu", "--batch-size", "4",
            "--seq-len", "64", "--steps-per-epoch", "2", "--log-every", "1",
            "--accum-steps", "2", "--text-file", corpus]
    trainer = recipe.main(argv + (["--pack"] if pack else []))
    assert trainer.state.step == 2
    assert all(np.isfinite(r["loss"]) for r in trainer.history)
    model = trainer.state.model.module
    assert 256 < model.config.vocab_size <= 512
    # the recipe's tokenizer set the vocabulary and round-trips the corpus
    text = open(corpus, encoding="utf-8").read()
    assert trainer.tokenizer.vocab_size == model.config.vocab_size
    assert trainer.tokenizer.decode(trainer.tokenizer.encode(text)) == text
    if pack:
        with pytest.raises(SystemExit, match="--text-file"):
            recipe.main(["--size", "tiny", "--device", "cpu", "--pack"])


def test_tp_flag_refuses_naming_a10_1():
    """The JAX recipe's ``--tp`` (``recipes/gpt2_zero1.py``) is taken; it
    trains under ``zero1`` and ``dp`` on a ``dp x tp x pp`` world
    (tests/test_torch_gpt2_tp.py), so what it refuses now is a world
    that cannot hold the mesh and ``--strategy single``, which has no
    process group."""
    args = recipe.parse_args(["--tp", "1"])
    assert args.tp == 1
    with pytest.raises(ValueError, match="not divisible"):
        recipe.main(["--device", "cpu", "--size", "tiny", "--tp", "2"])
    with pytest.raises(SystemExit, match="process group"):
        recipe.main(["--device", "cpu", "--size", "tiny", "--tp", "2",
                     "--strategy", "single"])
