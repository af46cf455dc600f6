"""The PyTorch port stands alone and runs on the card unless told not to.

* ``pytorch_distributed_tpu_torch`` imports, and serves a tiny model on
  the CPU, in a fresh interpreter where ``jax``, ``flax`` and the JAX
  package ``pytorch_distributed_tpu`` cannot be imported at all (the
  meta-path blocker idiom of tests/test_ckpt_shard.py).
* Its entry points default to the CUDA card and raise without one,
  instead of carrying on quietly on the CPU.
* ``chip_smoke.py`` fails, and prints no result, without a card or
  without the rest of the repo beside it.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu_torch import (
    EngineConfig,
    LlamaConfig,
    LlamaForCausalLM,
    ServeEngine,
    generate,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_RUN = """
import importlib, pkgutil, sys
BLOCKED = ("jax", "flax", "pytorch_distributed_tpu")
class _Block:
    def find_spec(self, name, *a, **k):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(name + " is blocked")
        return None
sys.meta_path.insert(0, _Block())
import numpy as np, torch
import pytorch_distributed_tpu_torch as ptt
for m in pkgutil.walk_packages(ptt.__path__, ptt.__name__ + "."):
    importlib.import_module(m.name)
model = ptt.LlamaForCausalLM(ptt.LlamaConfig.tiny(), device="cpu")
model.init_weights(torch.Generator().manual_seed(0))
engine = ptt.ServeEngine(model, ptt.EngineConfig(num_slots=2, max_len=32,
                         prefill_chunk=8), device="cpu")
h = engine.submit(ptt.Request(np.arange(1, 11), 4))
engine.run_until_drained()
assert len(h.tokens) == 4, h
bad = [m for m in sys.modules
       if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
assert not bad, bad
print("PORT-OK")
"""


def test_port_imports_and_serves_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "PORT-OK" in res.stdout


def test_entry_points_default_to_cuda(monkeypatch):
    cpu_model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cpu_model, EngineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(cpu_model, np.ones((1, 4), np.int64), max_new_tokens=2)


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """Alone in a directory (and, here, without a card) the smoke script
    exits non-zero and prints no result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
