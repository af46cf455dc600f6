"""The PyTorch port stands alone and runs on the card unless told not to.

* ``pytorch_distributed_tpu_torch`` imports (every module of it,
  the training slices' included), serves a tiny model, trains a tiny
  GPT-2, runs the ResNet-50 recipe, the Llama FSDP recipe and the BERT
  recipe (fp16 with loss scaling, and with LoRA) and generates (beam,
  speculative, an int4 model) on the CPU, in a fresh
  interpreter where ``jax``, ``flax`` and
  the JAX package ``pytorch_distributed_tpu`` cannot be imported at all
  (the meta-path blocker idiom of tests/test_ckpt_shard.py).
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
    BertConfig,
    BertForSequenceClassification,
    EngineConfig,
    ResNet50,
    GPT2Config,
    GPT2LMHead,
    LlamaConfig,
    LlamaForCausalLM,
    ServeEngine,
    generate,
    generator_for,
    init_process_group,
)
from pytorch_distributed_tpu_torch.recipes import gpt2 as gpt2_recipe
from pytorch_distributed_tpu_torch.recipes import (
    bert_finetune,
    llama_fsdp,
    resnet50_imagenet,
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
names = set()
for m in pkgutil.walk_packages(ptt.__path__, ptt.__name__ + "."):
    importlib.import_module(m.name)
    names.add(m.name)
for mod in ("ops.flash_attention", "ops.kernel_build", "models.gpt2",
            "data.packing", "data.datasets", "data.sampler", "data.loader",
            "optim", "runtime.prng", "train.train_state", "train.losses",
            "train.trainer", "recipes.gpt2", "runtime.distributed",
            "runtime.mesh", "data.native_pipeline", "models.resnet",
            "parallel.strategies", "recipes.resnet50_imagenet",
            "ops.lm_loss", "models.scan", "train.ckpt_io",
            "train.checkpoint", "train.elastic", "utils.integrity",
            "utils.native_build", "data.tokenizer", "recipes.llama_fsdp",
            "interop", "models.bert", "recipes.bert_finetune",
            "runtime.precision", "generation", "speculative", "ops.quant",
            "lora"):
    assert ptt.__name__ + "." + mod in names, mod
model = ptt.LlamaForCausalLM(ptt.LlamaConfig.tiny(), device="cpu")
model.init_weights(torch.Generator().manual_seed(0))
engine = ptt.ServeEngine(model, ptt.EngineConfig(num_slots=2, max_len=32,
                         prefill_chunk=8), device="cpu")
h = engine.submit(ptt.Request(np.arange(1, 11), 4))
engine.run_until_drained()
assert len(h.tokens) == 4, h
from pytorch_distributed_tpu_torch.recipes import gpt2
trainer = gpt2.main(["--size", "tiny", "--device", "cpu", "--batch-size", "2",
                     "--accum-steps", "2", "--seq-len", "16",
                     "--steps-per-epoch", "1", "--log-every", "1"])
assert trainer.state.step == 1, trainer.state.step
from pytorch_distributed_tpu_torch.recipes import resnet50_imagenet
trainer = resnet50_imagenet.main(["--device", "cpu", "--image-size", "32",
                                  "--batch-size", "2", "--steps-per-epoch",
                                  "1", "--epochs", "1"])
assert trainer.state.step == 1 and trainer.last_eval_metrics
from pytorch_distributed_tpu_torch.recipes import llama_fsdp
trainer = llama_fsdp.main(["--size", "tiny", "--device", "cpu",
                           "--batch-size", "2", "--seq-len", "16",
                           "--steps-per-epoch", "1", "--log-every", "1",
                           "--remat", "--vocab-chunk", "100"])
assert trainer.state.step == 1, trainer.state.step
from pytorch_distributed_tpu_torch.recipes import bert_finetune
trainer = bert_finetune.main(["--tiny", "--device", "cpu", "--fp16",
                              "--batch-size", "2", "--seq-len", "16",
                              "--steps-per-epoch", "1", "--log-every", "1"])
assert trainer.state.step == 1 and trainer.state.scaler_state is not None
trainer = bert_finetune.main(["--tiny", "--device", "cpu", "--lora", "2",
                              "--batch-size", "2", "--seq-len", "16",
                              "--steps-per-epoch", "1", "--log-every", "1"])
assert trainer.state.step == 1
g = ptt.GPT2LMHead(ptt.GPT2Config.tiny(), device="cpu")
g.init_weights(torch.Generator().manual_seed(0))
ids = torch.arange(1, 9).view(2, 4)
assert ptt.generate_beam(g, ids, max_new_tokens=3, num_beams=2,
                         device="cpu").shape == (2, 7)
assert ptt.generate_speculative(g, g, ids, max_new_tokens=3,
                                device="cpu").shape == (2, 7)
from pytorch_distributed_tpu_torch import ops
q = ops.QuantizedModel(g, ops.quantize_for_scan_dequant(g, "int4"))
assert ptt.generate(q, ids, max_new_tokens=2, device="cpu").shape == (2, 6)
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
        GPT2LMHead(GPT2Config.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generator_for(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpt2_recipe.main(["--size", "tiny", "--steps-per-epoch", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cpu_model, EngineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(cpu_model, np.ones((1, 4), np.int64), max_new_tokens=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResNet50()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet50_imagenet.main(["--steps-per-epoch", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_process_group()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama_fsdp.main(["--steps-per-epoch", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BertForSequenceClassification(BertConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bert_finetune.main(["--tiny", "--steps-per-epoch", "1"])


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
