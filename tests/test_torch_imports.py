"""The PyTorch port stands alone and runs on the card unless told not to.

* ``pytorch_distributed_tpu_torch`` imports (every module of it,
  the training slices' included), serves a tiny model (Llama; GPT-2
  with int8 pools, speculative decoding, and a prefill/decode fleet
  with a prefix store behind the router, also through
  ``scripts/port_serve_loadgen.py``, which serves Qwen2 too), trains a
  tiny
  GPT-2, runs the ResNet-50 recipe (with ZeRO-1, EMA and TensorBoard),
  the ResNet-18/CIFAR-10 recipe (through the native pipeline, with
  int8 gradient compression), the Llama FSDP recipe and the BERT
  recipe (fp16 with loss scaling, and with LoRA), the Llama recipe
  with Adafactor and the ResNet-50 recipe with the checkpoint lifecycle,
  MFU and the profiler, runs the host pipeline executor on one stage,
  and generates (beam,
  speculative, an int4 model) on the CPU, in a fresh
  interpreter where ``jax``, ``flax``, ``optax`` and
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
    resnet18_cifar10,
    resnet50_imagenet,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_RUN = """
import importlib, os, pkgutil, sys
BLOCKED = ("jax", "flax", "optax", "pytorch_distributed_tpu")
class _Block:
    def find_spec(self, name, *a, **k):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(name + " is blocked")
        return None
sys.meta_path.insert(0, _Block())
import numpy as np, torch
torch.set_num_threads(2)   # the test workers share the host's cores
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
            "lora", "serve.disagg", "serve.prefix_store", "serve.router",
            "serve.loadgen", "runtime.flightrec", "parallel.overlap",
            "parallel.ddp", "data.image_folder", "train.metrics",
            "utils.tensorboard", "recipes.resnet18_cifar10",
            "utils.config", "utils.profiler", "runtime.tracing",
            "runtime.device", "models.gemma", "models.mistral",
            "models.qwen2", "models.qwen3", "models.phi3", "models.neox",
            "parallel.sequence", "parallel.sharding", "parallel.rules",
            "ops.moe", "models.mixtral", "models.vit",
            "recipes.mixtral_moe", "recipes.vit_imagenet", "models.t5",
            "recipes.t5_seq2seq", "parallel.pipeline",
            "parallel.pipeline_lm", "parallel.pipeline_schedule"):
    assert ptt.__name__ + "." + mod in names, mod
assert ptt.StageLink is ptt.runtime.distributed.StageLink
from pytorch_distributed_tpu_torch.parallel import pipeline_lm
g = ptt.GPT2LMHead(ptt.GPT2Config.tiny(), device="cpu")
g.init_weights(torch.Generator().manual_seed(0))
stage, _ = pipeline_lm.host_stage_params(g, stage=0, num_stages=1)
host = ptt.HostPipelineStep(
    pipeline_lm.GPT2HostStagePrograms(stage, stage=0, num_stages=1),
    stage=0, num_stages=1, num_microbatches=2,
    optimizer=ptt.optim.SGD(stage, lr=0.1))
assert host.step({"input_ids": np.ones((2, 8), np.int32)})["loss"] > 0
model = ptt.LlamaForCausalLM(ptt.LlamaConfig.tiny(), device="cpu")
model.init_weights(torch.Generator().manual_seed(0))
engine = ptt.ServeEngine(model, ptt.EngineConfig(num_slots=2, max_len=32,
                         prefill_chunk=8), device="cpu")
h = engine.submit(ptt.Request(np.arange(1, 11), 4))
engine.run_until_drained()
assert len(h.tokens) == 4, h
import dataclasses
from pytorch_distributed_tpu_torch import serve
g8 = ptt.GPT2LMHead(dataclasses.replace(ptt.GPT2Config.tiny(),
                                        kv_cache_quantize="int8"),
                    device="cpu")
g8.init_weights(torch.Generator().manual_seed(0))
cfg = ptt.EngineConfig(num_slots=2, max_len=32, prefill_chunk=8, page_size=8)
engine = ptt.ServeEngine(g8, cfg, device="cpu", spec=ptt.SpecConfig(g8, 2))
h = engine.submit(ptt.Request(np.arange(1, 11), 5))
engine.run_until_drained()
assert len(h.tokens) == 5 and engine.spec_verifies, h
store = ptt.InProcPrefixStore()
router = ptt.Router(
    prefill=[ptt.ServeEngine(g8, dataclasses.replace(cfg, role="prefill"),
                             device="cpu", prefix_store=store)],
    decode=[ptt.ServeEngine(g8, dataclasses.replace(cfg, role="decode"),
                            device="cpu")], store=store)
rh = router.submit(ptt.Request(np.arange(1, 19), 3))
router.run_until_drained()
assert len(rh.tokens) == 3 and router.migration_frames == 1
assert store.stats()["puts"] == 2
sys.path.insert(0, "scripts")
import port_serve_loadgen
assert port_serve_loadgen.main(["--device", "cpu", "--requests", "4",
                                "--engines", "2", "--disagg", "--store",
                                "--prefix-share", "1", "--prefix-len", "8",
                                "--page-size", "8", "--new-tokens", "3"]) == 0
assert port_serve_loadgen.main(["--device", "cpu", "--model", "qwen2-tiny",
                                "--requests", "2", "--new-tokens", "3"]) == 0
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
import tempfile
tmp = tempfile.mkdtemp()
trainer = resnet50_imagenet.main(["--device", "cpu", "--image-size", "32",
                                  "--batch-size", "2", "--steps-per-epoch",
                                  "1", "--epochs", "1", "--strategy", "zero1",
                                  "--ema-decay", "0.9", "--tensorboard-dir",
                                  tmp + "/tb"])
assert trainer.state.step == 1 and trainer.state.ema_params
import pickle
os.makedirs(tmp + "/cifar-10-batches-py")
rng = np.random.default_rng(0)
for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
    with open(tmp + "/cifar-10-batches-py/" + name, "wb") as f:
        pickle.dump({b"data": rng.integers(0, 256, (4, 3072), np.uint8),
                     b"labels": [1, 2, 3, 4]}, f)
from pytorch_distributed_tpu_torch.recipes import resnet18_cifar10
trainer = resnet18_cifar10.main(["--device", "cpu", "--data-dir", tmp,
                                 "--batch-size", "4", "--steps-per-epoch",
                                 "1", "--epochs", "1", "--grad-compress",
                                 "int8"])
assert trainer.state.step == 1 and trainer.train_loader.fetch is not None
from pytorch_distributed_tpu_torch.recipes import llama_fsdp
trainer = llama_fsdp.main(["--size", "tiny", "--device", "cpu",
                           "--batch-size", "2", "--seq-len", "16",
                           "--steps-per-epoch", "1", "--log-every", "1",
                           "--remat", "--vocab-chunk", "100"])
assert trainer.state.step == 1, trainer.state.step
trainer = llama_fsdp.main(["--size", "tiny", "--device", "cpu",
                           "--batch-size", "2", "--seq-len", "16",
                           "--steps-per-epoch", "1", "--log-every", "1",
                           "--optimizer", "adafactor", "--backend", "gloo"])
assert type(trainer.state.optimizer).__name__ == "Adafactor"
trainer = resnet50_imagenet.main(["--device", "cpu", "--image-size", "32",
                                  "--batch-size", "2", "--steps-per-epoch",
                                  "2", "--epochs", "1", "--log-every", "1",
                                  "--ckpt-dir", tmp + "/ck",
                                  "--ckpt-every-steps", "1",
                                  "--keep-checkpoints", "1", "--keep-best",
                                  "accuracy", "--async-checkpoint",
                                  "--log-mfu", "--profile-dir",
                                  tmp + "/prof"])
assert os.path.isdir(tmp + "/ck/best") and os.listdir(tmp + "/prof")
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


_BLOCKED_SLICE14 = _BLOCKED_RUN.split("import pytorch_distributed_tpu_torch")[0] + """
import pytorch_distributed_tpu_torch as ptt
from pytorch_distributed_tpu_torch import (
    MixtralConfig, MixtralForCausalLM, MoEMLP, ViT, ViTConfig,
    current_mesh, export_bert_weights, export_mixtral_weights,
    export_vit_weights, load_bert_weights, load_mixtral_weights,
    load_vit_weights, max_memory_allocated, memory_allocated, memory_stats,
    memory_summary, mesh_axis_size, mixtral_params_from_jax,
    mixtral_params_to_jax, set_current_mesh, vit_params_from_jax,
    vit_params_to_jax,
)
assert memory_stats() == {} and memory_allocated() == 0
assert max_memory_allocated() == 0 and memory_summary() == "no CUDA device"
assert current_mesh() is None and mesh_axis_size("dp") == 1
from pytorch_distributed_tpu_torch.recipes import mixtral_moe, vit_imagenet
trainer = mixtral_moe.main(["--device", "cpu", "--steps-per-epoch", "2",
                            "--batch-size", "8", "--log-every", "1",
                            "--eval-rows", "2"])
assert trainer.state.step == 2 and trainer.successor is not None
assert "moe_aux_loss" in trainer.history[-1]
trainer = vit_imagenet.main(["--device", "cpu", "--variant", "tiny",
                             "--synthetic", "--batch-size", "4",
                             "--steps-per-epoch", "1", "--epochs", "1"])
assert trainer.state.step == 1 and trainer.last_eval_metrics
bad = [m for m in sys.modules
       if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
assert not bad, bad
print("SLICE14-OK")
"""


def test_slice14_exports_and_recipes_run_with_jax_blocked():
    """The names this slice exports (Mixtral, ``MoEMLP``, ViT, their and
    BERT's converters, the memory functions, ``current_mesh``,
    ``set_current_mesh``, ``mesh_axis_size``) import from the package
    root, and the Mixtral and ViT recipes train on the CPU, with the JAX
    side blocked."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED_SLICE14], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "SLICE14-OK" in res.stdout


_BLOCKED_T5 = _BLOCKED_RUN.split("import pytorch_distributed_tpu_torch")[0] + """
from pytorch_distributed_tpu_torch import (
    T5Config, T5ForConditionalGeneration, export_t5_weights,
    generate_encdec, load_t5_weights, seq2seq_eval_step, seq2seq_lm_loss_fn,
    shift_right, t5_params_from_jax, t5_params_to_jax, t5_partition_rules,
)
from pytorch_distributed_tpu_torch.recipes import t5_seq2seq
trainer = t5_seq2seq.main(["--device", "cpu", "--steps-per-epoch", "2",
                           "--batch-size", "8", "--eval-rows", "4",
                           "--log-every", "1"])
assert trainer.state.step == 2 and trainer.seq2seq["rows"] == 4
assert sorted(trainer.last_eval_metrics) == ["loss", "perplexity",
                                             "token_accuracy"]
cfg = T5Config.tiny()
model = T5ForConditionalGeneration(cfg, device="cpu")
model.init_weights(torch.Generator().manual_seed(0))
sd = load_t5_weights(export_t5_weights(model.state_dict(), cfg), cfg)
assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
tree = t5_params_to_jax(model.state_dict(), cfg)
assert sorted(t5_params_from_jax(tree, cfg)) == sorted(sd)
ids = torch.randint(2, cfg.vocab_size, (2, 5))
assert generate_encdec(model, ids, max_new_tokens=3).shape == (2, 3)
bad = [m for m in sys.modules
       if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
assert not bad, bad
print("T5-OK")
"""


def test_t5_exports_and_recipe_run_with_jax_blocked():
    """The T5 names (the model, ``generate_encdec``, the seq2seq losses,
    the JAX and HF converters, the partition rules) import from the
    package root, the recipe trains and generates on the CPU, and the
    converters round-trip, with the JAX side blocked."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED_T5], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "T5-OK" in res.stdout


def test_t5_entry_points_default_to_cuda(monkeypatch):
    from pytorch_distributed_tpu_torch import (
        T5Config,
        T5ForConditionalGeneration,
    )
    from pytorch_distributed_tpu_torch.recipes import t5_seq2seq

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T5ForConditionalGeneration(T5Config.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t5_seq2seq.main(["--steps-per-epoch", "1"])


def test_mesh_helpers_follow_the_current_mesh():
    """``set_current_mesh``/``current_mesh``/``mesh_axis_size`` on a gloo
    world of one: the JAX defaults without a mesh (``dp`` the world,
    every other axis 1), the spec's sizes with one."""
    from pytorch_distributed_tpu_torch import (
        current_mesh,
        destroy_process_group,
        make_mesh,
        mesh_axis_size,
        set_current_mesh,
    )
    from pytorch_distributed_tpu_torch.runtime.mesh import AXES, MeshSpec

    init_process_group("gloo", device="cpu")
    try:
        set_current_mesh(None)
        assert current_mesh() is None
        assert [mesh_axis_size(a) for a in AXES] == [1] * 6
        mesh = make_mesh(MeshSpec(dp=1, ep=1), "cpu")
        assert current_mesh()[0] is mesh
        set_current_mesh(None)
        assert current_mesh() is None
        set_current_mesh(mesh)
        assert current_mesh()[1] == MeshSpec(dp=1)
        assert mesh_axis_size("ep") == 1
        with pytest.raises(KeyError):
            mesh_axis_size("zz")
    finally:
        destroy_process_group()


def test_slice14_entry_points_default_to_cuda(monkeypatch):
    from pytorch_distributed_tpu_torch import (
        MixtralConfig,
        MixtralForCausalLM,
        ViT,
        ViTConfig,
    )
    from pytorch_distributed_tpu_torch.recipes import (
        mixtral_moe,
        vit_imagenet,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MixtralForCausalLM(MixtralConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ViT(ViTConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mixtral_moe.main(["--steps-per-epoch", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vit_imagenet.main(["--variant", "tiny", "--steps-per-epoch", "1"])


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
        resnet18_cifar10.main(["--synthetic", "--steps-per-epoch", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_process_group()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama_fsdp.main(["--steps-per-epoch", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BertForSequenceClassification(BertConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bert_finetune.main(["--tiny", "--steps-per-epoch", "1"])
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import port_serve_loadgen

    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve_loadgen.main(["--requests", "2"])


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
