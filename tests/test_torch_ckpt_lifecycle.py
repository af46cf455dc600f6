"""The checkpoint lifecycle of the port against the JAX package's.

* ``AsyncCheckpointer``: the files of an async save of a state equal a
  sync save's of the same state byte for byte (every shard, the
  manifest, the COMMIT), though the state changes while the files are
  written.
* ``prune_checkpoints`` and ``load_best_checkpoint`` on the same
  directory tree (step tags, a damaged one, a stranded ``.tmp``,
  ``latest`` and ``best``) remove and pick the same directories as the
  JAX functions.
* ``average_checkpoints`` over three JAX-written tags equals the JAX
  function's average, to the bit (both a running f32 mean on the host).
* The optimizer layouts of Adafactor, Adam, LARS and LAMB on a 2-layer
  Llama-tiny, both ways: a port checkpoint restores in the JAX package
  and a JAX one in the port, every leaf matched by name; the next step
  from the restored state then equals on both sides within 1e-6 of the
  largest parameter (f32 sums in another order), and a JAX checkpoint
  written back by the port is the JAX one, to the bit.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_tpu import optim as jopt
from pytorch_distributed_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlama,
)
from pytorch_distributed_tpu.train import TrainState as JaxTrainState
from pytorch_distributed_tpu.train import ckpt_io as jax_ckpt_io
from pytorch_distributed_tpu.train.checkpoint import (
    _leaf_files,
    average_checkpoints as jax_average_checkpoints,
    restore_checkpoint as jax_restore_checkpoint,
    save_checkpoint as jax_save_checkpoint,
)
from pytorch_distributed_tpu_torch import optim
from pytorch_distributed_tpu_torch.interop import (
    llama_params_from_jax,
    llama_params_to_jax,
)
from pytorch_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
)
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.train import (
    TrainState,
    restore_checkpoint,
    save_checkpoint,
)
from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
from pytorch_distributed_tpu_torch.train import ckpt_io
from tests.torch_dp_workers import RANK_THREADS
from tests.torch_parity import assert_close


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads, as the spawned ranks take
    (``torch_dp_workers.RANK_THREADS``): the test workers share the
    host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(RANK_THREADS)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_llama():
    jmodel = JaxLlama(JaxLlamaConfig.tiny())
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    return jmodel, jax.device_get(params)


def _port(params):
    cfg = LlamaConfig.tiny()
    model = LlamaForCausalLM(cfg, device="cpu", policy=Policy.full())
    model.load_state_dict(llama_params_from_jax(params, cfg))
    return model


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), params)


def _port_step(model, opt, grads):
    pg = llama_params_from_jax(grads, model.config)
    for n, p in model.named_parameters():
        p.grad = pg[n].clone()
    opt.step()


def _jax_step(jstate, tx, grads):
    upd, opt_state = tx.update(grads, jstate.opt_state, jstate.params)
    return jstate.replace(step=jstate.step + 1,
                          params=optax.apply_updates(jstate.params, upd),
                          opt_state=opt_state)


# -- async bytes ------------------------------------------------------------

def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_async_save_writes_the_sync_bytes(jax_llama, tmp_path):
    _, params = jax_llama
    model = _port(params)
    opt = optim.clip_grad_norm(optim.AdamW(model, lr=1e-3), 1.0)
    state = TrainState(model, opt, policy=Policy.full())
    _port_step(model, opt, _grads(params, 1))
    state.step = 1
    save_checkpoint(str(tmp_path / "sync"), state, tag="step-1")
    saver = ckpt.AsyncCheckpointer()
    saver.save(str(tmp_path / "async"), state, tag="step-1")
    _port_step(model, opt, _grads(params, 2))   # the state moves on
    saver.wait()
    a = _tree_bytes(tmp_path / "sync" / "step-1")
    b = _tree_bytes(tmp_path / "async" / "step-1")
    assert sorted(a) == sorted(b) and len(a) > 10
    for name in a:
        assert a[name] == b[name], name


def test_async_save_error_surfaces_on_wait(jax_llama, tmp_path):
    _, params = jax_llama
    model = _port(params)
    state = TrainState(model, optim.AdamW(model, lr=1e-3),
                       policy=Policy.full())
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver = ckpt.AsyncCheckpointer()
    with pytest.raises(Exception):
        saver.save(str(blocker), state)
        saver.wait()


# -- prune and pick, on the same tree ----------------------------------------

def _tree(root, steps, damaged=(), stranded=(), latest=None, best=None):
    leaves = {"w": np.arange(6, dtype=np.float32)}
    for s in steps:
        ckpt_io.save_single_checkpoint(root, leaves, s, tag=f"step-{s}")
    for s in damaged:   # a shard cut short after its commit
        d = os.path.join(root, f"step-{s}")
        shard = next(f for f in os.listdir(d) if f.endswith(".npy"))
        with open(os.path.join(d, shard), "r+b") as f:
            f.truncate(10)
    for s in stranded:
        os.makedirs(os.path.join(root, f"step-{s}.tmp"))
    if latest is not None:
        ckpt_io.save_single_checkpoint(root, leaves, latest)
    if best is not None:
        ckpt_io.save_single_checkpoint(root, leaves, best, tag="best")


TREES = {
    "plain": dict(steps=[2, 4, 6, 8], latest=8, best=4),
    "damaged_and_stranded": dict(steps=[2, 4, 6], damaged=[6],
                                 stranded=[5, 10], latest=6),
    "only_restorable_in_window": dict(steps=[2, 4, 6]),
}


@pytest.mark.parametrize("keep", [0, 1, 2])
@pytest.mark.parametrize("tree", sorted(TREES))
def test_prune_removes_what_the_jax_prune_removes(tmp_path, tree, keep):
    port, jax_root = str(tmp_path / "p"), str(tmp_path / "j")
    _tree(port, **TREES[tree])
    shutil.copytree(port, jax_root)
    got = ckpt_io.prune_checkpoints(port, keep=keep)
    want = jax_ckpt_io.prune_checkpoints(jax_root, keep=keep)
    # the same set (the JAX function lists orphans in directory order)
    assert sorted(os.path.basename(p) for p in got) == sorted(
        os.path.basename(p) for p in want)
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_root))


@pytest.mark.parametrize("tag, corrupt", [
    ("latest", []), ("latest", ["latest"]), ("best", []),
    ("latest", ["latest", "step-3"])])
def test_load_best_picks_what_the_jax_loader_picks(tmp_path, tag, corrupt):
    root = str(tmp_path / "c")
    leaves = {"w": np.arange(6, dtype=np.float32)}
    ckpt_io.save_single_checkpoint(root, leaves, 3, tag="step-3")
    ckpt_io.save_single_checkpoint(root, leaves, 5)
    ckpt_io.save_single_checkpoint(root, leaves, 4, tag="best")
    for name in corrupt:
        d = os.path.join(root, name)
        shard = next(f for f in os.listdir(d) if f.endswith(".npy"))
        with open(os.path.join(d, shard), "r+b") as f:
            f.truncate(10)
    if len(corrupt) == 2:
        for loader in (ckpt_io.load_best_checkpoint,
                       jax_ckpt_io.load_best_checkpoint):
            with pytest.raises(Exception, match="none"):
                loader(root, tag)
        return
    got = ckpt_io.load_best_checkpoint(root, tag)
    want = jax_ckpt_io.load_best_checkpoint(root, tag)
    assert (got.tag, got.step, got.walked_back) == (
        want.tag, want.step, want.walked_back)
    np.testing.assert_array_equal(got.leaves["w"], want.leaves["w"])
    assert ckpt_io.load_best_checkpoint(str(tmp_path / "none")) is None


# -- average ---------------------------------------------------------------

def test_average_equals_the_jax_average(jax_llama, tmp_path):
    jmodel, params = jax_llama
    tx = jopt.AdamW(1e-3)
    template = JaxTrainState.create(apply_fn=jmodel.apply, params=params,
                                    tx=tx)
    tags = []
    for i, step in enumerate((3, 7, 5)):
        rng = np.random.default_rng(i)
        st = template.replace(
            step=step, params=jax.tree_util.tree_map(
                lambda x: rng.standard_normal(x.shape).astype(np.float32),
                params))
        jax_save_checkpoint(str(tmp_path), st, tag=f"step-{step}")
        tags.append(f"step-{step}")
    want = jax_average_checkpoints(str(tmp_path), template, tags)
    model = _port(params)
    state = TrainState(model, optim.AdamW(model, lr=1e-3, weight_decay=1e-4),
                       policy=Policy.full())
    ckpt.average_checkpoints(str(tmp_path), state, tags)
    assert state.step == 7
    got = llama_params_to_jax(model.state_dict(), model.config)
    for (name, w), (_, g) in zip(
            _leaf_files(jax.device_get(want.params)), _leaf_files(got)):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


# -- the optimizer layouts, both ways --------------------------------------

KINDS = {
    "adafactor": (lambda m: optim.Adafactor(m, 1e-2, min_dim_size_to_factor=8),
                  lambda: jopt.Adafactor(1e-2, min_dim_size_to_factor=8)),
    "adam": (lambda m: optim.Adam(m, 1e-3, weight_decay=1e-2),
             lambda: jopt.Adam(1e-3, weight_decay=1e-2)),
    "lars": (lambda m: optim.LARS(m, 0.1, weight_decay=1e-4),
             lambda: jopt.LARS(0.1, weight_decay=1e-4)),
    "lamb": (lambda m: optim.LAMB(m, 1e-3, weight_decay=1e-2),
             lambda: jopt.LAMB(1e-3, weight_decay=1e-2)),
}


def _assert_params_close(model, jparams):
    got = dict(_leaf_files(llama_params_to_jax(model.state_dict(),
                                               model.config)))
    for name, want in _leaf_files(jax.device_get(jparams)):
        assert_close(got[name], np.asarray(want), 1e-6, name)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_port_optimizer_checkpoint_restores_in_jax(jax_llama, tmp_path,
                                                   kind):
    jmodel, params = jax_llama
    make, jmake = KINDS[kind]
    model = _port(params)
    opt = make(model)
    state = TrainState(model, opt, policy=Policy.full())
    for seed in (1, 2):
        _port_step(model, opt, _grads(params, seed))
    state.step = 2
    save_checkpoint(str(tmp_path), state)
    tx = jmake()
    template = JaxTrainState.create(apply_fn=jmodel.apply, params=params,
                                    tx=tx)
    jstate = jax_restore_checkpoint(str(tmp_path), template)
    assert int(jstate.step) == 2
    grads = _grads(params, 3)
    jstate = _jax_step(jstate, tx, grads)
    _port_step(model, opt, grads)
    _assert_params_close(model, jstate.params)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_jax_optimizer_checkpoint_restores_in_port(jax_llama, tmp_path,
                                                   kind):
    jmodel, params = jax_llama
    make, jmake = KINDS[kind]
    tx = jmake()
    jstate = JaxTrainState.create(apply_fn=jmodel.apply, params=params,
                                  tx=tx)
    for seed in (1, 2):
        jstate = _jax_step(jstate, tx, _grads(params, seed))
    jax_save_checkpoint(str(tmp_path / "jax"), jstate)
    rng = np.random.default_rng(9)   # a fresh port model, other weights
    model = _port(jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), params))
    opt = make(model)
    state = TrainState(model, opt, policy=Policy.full())
    restore_checkpoint(str(tmp_path / "jax"), state)
    assert state.step == 2
    save_checkpoint(str(tmp_path / "port"), state)
    back = ckpt_io.load_checkpoint(str(tmp_path / "port" / "latest")).leaves
    want = {k: np.asarray(v) for k, v in _leaf_files(jax.device_get(jstate))}
    assert sorted(back) == sorted(want)
    for name, w in want.items():
        assert back[name].dtype == w.dtype, name
        np.testing.assert_array_equal(back[name], w, err_msg=name)
    grads = _grads(params, 3)
    jstate = _jax_step(jstate, tx, grads)
    _port_step(model, opt, grads)
    _assert_params_close(model, jstate.params)
