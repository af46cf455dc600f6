"""The port's ViT (``models/vit.py``) and its recipe held against the JAX
package's tiny ViT in f32, on the same numpy-seeded images and weights
(every JAX leaf redrawn from a seed and carried over by
``interop.vit_params_from_jax``):

* logits with the attention on the flash kernels' plain version
  (``attn_impl="flash"``, the path the card's kernels replace) and on the
  einsum path (``"xla"``), ``cls`` and ``mean`` pooling, to 1e-5 of their
  largest magnitude (f32 sums in another order);
* the gradients of the label-smoothed cross-entropy with respect to the
  images and every weight, both attention paths, to 1e-4 of their
  largest magnitude (the key bias's aside: exactly zero in theory, so
  both frameworks' values are rounding noise near 1e-8);
* ``vit_params_to_jax`` returns the JAX tree bit for bit, and a port
  checkpoint restores in the JAX package;
* a 197-token image (ViT-B/16's count: the flash tiles end in a ragged
  tail) takes the plain flash path to the einsum path's logits;
* the recipe at smoke size on the CPU: the u8 device ingest, dropout from
  the step's generator, AdamW with warmup-cosine, one eval, a checkpoint
  and its resume.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_tpu.models import vit as jvit
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu.train import TrainState as JaxTrainState
from pytorch_distributed_tpu.train.checkpoint import (
    _leaf_files,
    restore_checkpoint as jax_restore_checkpoint,
)
from pytorch_distributed_tpu_torch import optim
from pytorch_distributed_tpu_torch.interop import (
    vit_params_from_jax,
    vit_params_to_jax,
)
from pytorch_distributed_tpu_torch.models.vit import ViT, ViTConfig
from pytorch_distributed_tpu_torch.recipes import vit_imagenet
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.train import TrainState, save_checkpoint
from pytorch_distributed_tpu_torch.train.losses import cross_entropy
from tests.torch_parity import assert_close

F32 = JaxPolicy(compute_dtype=jnp.float32)
RTOL, GRAD_RTOL = 1e-5, 1e-4
POOLING = ("cls", "mean")


def _cfgs(pooling, **kw):
    return (dataclasses.replace(jvit.ViTConfig.tiny(), pooling=pooling,
                                **kw),
            dataclasses.replace(ViTConfig.tiny(), pooling=pooling, **kw))


def _params(jcfg, seed):
    jmodel = jvit.ViT(jcfg)
    size = jcfg.image_size
    with use_policy(F32):
        shapes = jax.eval_shape(lambda: jmodel.init(
            jax.random.key(0), jnp.zeros((1, size, size, 3)),
            train=False))["params"]
    rng = np.random.default_rng(seed)

    def one(path, x):
        draw = rng.normal(size=x.shape) * 0.1
        if path[-1].key == "scale":
            draw = 1.0 + draw
        return draw.astype(np.float32)

    return jmodel, jax.tree_util.tree_map_with_path(one, shapes)


def _port(params, cfg):
    model = ViT(cfg, device="cpu", policy=Policy.full())
    model.load_state_dict(vit_params_from_jax(params, cfg))
    return model


def _images(size, seed=1, B=3):
    return np.random.default_rng(seed).normal(
        size=(B, size, size, 3)).astype(np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat(v, key) if isinstance(v, dict) else
                   {key: np.asarray(v)})
    return out


@pytest.fixture(scope="module", params=POOLING)
def pair(request):
    jcfg, cfg = _cfgs(request.param)
    jmodel, params = _params(jcfg, seed=3)
    return request.param, jmodel, params, cfg


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_logits_match_jax(pair, impl):
    pooling, jmodel, params, cfg = pair
    x = _images(cfg.image_size)
    with use_policy(F32):
        ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    model = _port(params, cfg)
    with torch.no_grad():
        out = model(torch.from_numpy(x), attn_impl=impl)
    assert out.dtype == torch.float32 and out.shape == (3, cfg.num_classes)
    assert_close(out, ref, RTOL, f"{pooling} {impl} logits")


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_gradients_match_jax(pair, impl):
    pooling, jmodel, params, cfg = pair
    x = _images(cfg.image_size, seed=4)
    labels = np.random.default_rng(5).integers(0, cfg.num_classes, 3)

    def f(p, xx):
        logits = jmodel.apply({"params": p}, xx)
        onehot = optax.smooth_labels(jax.nn.one_hot(labels, cfg.num_classes),
                                     0.1)
        return optax.softmax_cross_entropy(logits, onehot).mean()

    with use_policy(F32):
        want, (gp, gx) = jax.value_and_grad(f, argnums=(0, 1))(
            params, jnp.asarray(x))
    model = _port(params, cfg)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = cross_entropy(model(xt, attn_impl=impl),
                         torch.from_numpy(labels), 0.1)
    loss.backward()
    assert_close(loss.item(), float(want), RTOL, "loss")
    assert_close(xt.grad, np.asarray(gx), GRAD_RTOL, "d images")
    got = _flat(vit_params_to_jax({n: p.grad for n, p in
                                   model.named_parameters()}, cfg))
    jgrads = _flat(jax.device_get(gp))
    assert sorted(got) == sorted(jgrads)
    for k, v in got.items():
        if k.endswith("key/bias"):
            continue   # exactly zero in theory (softmax's shift): noise
        assert_close(v, jgrads[k], GRAD_RTOL, f"{pooling} {impl} {k}")


def test_tree_round_trips_and_a_port_checkpoint_restores_in_jax(pair,
                                                                tmp_path):
    pooling, jmodel, params, cfg = pair
    model = _port(params, cfg)
    back = _flat(vit_params_to_jax(model.state_dict(), cfg))
    want = _flat(params)
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    opt = optim.AdamW(model, lr=1e-3, weight_decay=0.3)
    x = torch.from_numpy(_images(cfg.image_size, seed=6))
    cross_entropy(model(x), torch.tensor([1, 2, 3])).backward()
    opt.step()
    state = TrainState(model, opt, policy=Policy.full())
    state.step = 1
    save_checkpoint(str(tmp_path), state)
    template = JaxTrainState.create(apply_fn=jmodel.apply, params=params,
                                    tx=optax.adamw(1e-3))
    got = {k: np.asarray(v) for k, v in _leaf_files(
        jax_restore_checkpoint(str(tmp_path), template))}
    want = {"step": 1, "opt_state_0_count": 1}
    moments = {key: {n: opt.state[p][key] for n, p in
                     model.named_parameters()}
               for key in ("exp_avg", "exp_avg_sq")}
    for prefix, sd in (("params", model.state_dict()),
                       ("opt_state_0_mu", moments["exp_avg"]),
                       ("opt_state_0_nu", moments["exp_avg_sq"])):
        for k, v in _flat(vit_params_to_jax(sd, cfg)).items():
            want[f"{prefix}_{k.replace('/', '_')}"] = v
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def test_vit_b16_token_count_takes_the_ragged_flash_tail():
    """196 patches and the cls token (ViT-B/16's 197) at a narrow width:
    the plain flash path equals the einsum path, the JAX model's too."""
    jcfg, cfg = _cfgs("cls", image_size=56, patch_size=4)
    jmodel, params = _params(jcfg, seed=8)
    assert cfg.num_patches + 1 == 197
    x = _images(56, seed=9, B=2)
    with use_policy(F32):
        ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    model = _port(params, cfg)
    with torch.no_grad():
        for impl in ("flash", "xla"):
            assert_close(model(torch.from_numpy(x), attn_impl=impl), ref,
                         RTOL, impl)


def test_recipe_trains_evals_and_resumes_on_the_cpu(tmp_path):
    argv = ["--device", "cpu", "--variant", "tiny", "--synthetic",
            "--batch-size", "8", "--steps-per-epoch", "3", "--epochs", "1",
            "--warmup-epochs", "0", "--log-every", "1", "--ckpt-dir",
            str(tmp_path)]
    trainer = vit_imagenet.main(argv)
    assert trainer.state.step == 3
    assert all(np.isfinite(r["loss"]) for r in trainer.history)
    assert set(trainer.last_eval_metrics) >= {"loss", "accuracy",
                                              "top5_accuracy"}
    resumed = vit_imagenet.main(argv[:-4] + ["--epochs", "2", "--ckpt-dir",
                                             str(tmp_path)])
    assert resumed.state.step == 6
    with pytest.raises(NotImplementedError, match="A10.1"):
        vit_imagenet.main(["--device", "cpu", "--tp", "2"])
