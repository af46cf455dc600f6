"""Weights carried across from the JAX package.

:func:`llama_params_from_jax`, :func:`gpt2_params_from_jax` and
:func:`resnet_params_from_jax` turn a JAX ``LlamaForCausalLM``,
``GPT2LMHead`` or ``ResNet`` variable tree (nested dicts of numpy arrays;
convert with ``jax.device_get``) into the port's ``state_dict``, so the
JAX model and the port can run on the same weights. The port is its own
layout: ``nn.Linear`` weights are ``[out, in]`` and conv weights
``[O, I, kh, kw]``, where the JAX kernels are ``[in, out]`` (heads kept
as their own axes) and ``[kh, kw, I, O]``.

Every converter accounts for every leaf of the tree it is given
(:class:`_Leaves`): a leaf it does not map, such as the q/k/v biases of
an ``attention_bias`` Llama, the ``q_norm``/``k_norm`` scales of a
``qk_norm`` one or the experts of a mixture-of-experts GPT-2, is an error
that names the leaf and the ROADMAP item that would port it, never a
weight silently left behind.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class _Leaves:
    """The leaves of a JAX variable tree by path (``"layer0/q/kernel"``).
    A converter takes each leaf it maps; :meth:`finish` refuses the tree
    when any leaf was not taken."""

    def __init__(self, tree, what: str, item: str):
        self.what, self.item = what, item
        self.arrays: Dict[str, np.ndarray] = {}
        self.taken = set()

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, f"{path}/{k}" if path else str(k))
            else:
                self.arrays[path] = np.asarray(node)

        walk(tree, "")

    def has(self, prefix: str) -> bool:
        return any(p == prefix or p.startswith(prefix + "/")
                   for p in self.arrays)

    def _left(self):
        return sorted(set(self.arrays) - self.taken)

    def take(self, path: str) -> np.ndarray:
        if path not in self.arrays:
            raise NotImplementedError(
                f"{self.what}: the port maps leaf {path!r}, which this tree "
                f"lacks; leaves not taken so far: {self._left()} — a layout "
                f"the port does not have (ROADMAP {self.item})"
            )
        self.taken.add(path)
        return self.arrays[path]

    def finish(self) -> None:
        left = self._left()
        if left:
            raise NotImplementedError(
                f"{self.what}: leaves the port does not map: {left} "
                f"(ROADMAP {self.item})"
            )


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _layer_getter(leaves: _Leaves, stack: str, prefix: str):
    """``get(i, sub)``: layer ``i``'s leaf ``sub`` from either JAX layout,
    the scan-stacked one (``{stack}/block/{sub}`` with a leading ``[L]``)
    or the unrolled one (``{prefix}{i}/{sub}``)."""
    if leaves.has(f"{stack}/block"):
        return lambda i, sub: leaves.take(f"{stack}/block/{sub}")[i]
    return lambda i, sub: leaves.take(f"{prefix}{i}/{sub}")


def llama_params_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    """JAX Llama params -> the port's ``LlamaForCausalLM`` state_dict.

    Kernel layouts on the JAX side: q/k/v ``[D, H, hd]``, o
    ``[H, hd, D]``, gate/up ``[D, I]``, down ``[I, D]``,
    ``embed/embedding [V, D]``, ``lm_head/kernel [D, V]``. Returned
    tensors are f32 CPU tensors; ``load_state_dict`` casts and moves
    them to the module's dtype and device. A tied tree (no ``lm_head``)
    and leaves the port's Llama has no place for (q/k/v biases,
    ``q_norm``/``k_norm``) raise ``NotImplementedError`` naming A7.
    """
    leaves = _Leaves(params, "llama_params_from_jax", "A7")
    if not leaves.has("lm_head"):
        raise NotImplementedError(
            "llama_params_from_jax: the tree has no lm_head — tied word "
            "embeddings (the head is embed/embedding) are not ported "
            "(ROADMAP A7)"
        )
    D = cfg.hidden_size
    sd = {
        "embed.weight": _t(leaves.take("embed/embedding")),
        "final_norm.weight": _t(leaves.take("final_norm/scale")),
        "lm_head.weight": _t(leaves.take("lm_head/kernel").T),
    }
    get = _layer_getter(leaves, "layers", "layer")
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        sd[p + "attn_norm.weight"] = _t(get(i, "attn_norm/scale"))
        sd[p + "mlp_norm.weight"] = _t(get(i, "mlp_norm/scale"))
        for name in ("q", "k", "v"):
            kern = get(i, f"{name}/kernel")                 # [D, H, hd]
            sd[p + f"{name}.weight"] = _t(kern.reshape(D, -1).T)
        o = get(i, "o/kernel")                               # [H, hd, D]
        sd[p + "o.weight"] = _t(o.reshape(-1, D).T)
        for name in ("gate", "up", "down"):
            sd[p + f"{name}.weight"] = _t(get(i, f"{name}/kernel").T)
    leaves.finish()
    return sd


def gpt2_params_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    """JAX GPT-2 params -> the port's ``GPT2LMHead`` state_dict.

    Reads both JAX layouts: scan-stacked (``blocks/block``, a leading
    ``[L]`` on every leaf) and unrolled (``block{i}``). Kernel layouts on
    the JAX side: ``attn_qkv`` ``[D, 3, H, hd]`` (bias ``[3, H, hd]``),
    ``attn_out`` ``[H, hd, D]``, ``mlp_up``/``mlp_down`` ``[in, out]``,
    ``wte`` ``[V, D]``, ``wpe`` ``[P, D]``, LayerNorm ``scale``/``bias``.
    Returned tensors are f32 CPU tensors; ``load_state_dict`` casts and
    moves them to the module's dtype and device. Mixture-of-experts
    blocks (``moe/...``) raise ``NotImplementedError`` naming A7.
    """
    leaves = _Leaves(params, "gpt2_params_from_jax", "A7")
    D = cfg.hidden_size
    sd = {
        "wte.weight": _t(leaves.take("wte/embedding")),
        "wpe.weight": _t(leaves.take("wpe/embedding")),
        "ln_f.weight": _t(leaves.take("ln_f/scale")),
        "ln_f.bias": _t(leaves.take("ln_f/bias")),
    }
    get = _layer_getter(leaves, "blocks", "block")
    for i in range(cfg.num_layers):
        p = f"blocks.{i}."
        for ln in ("ln1", "ln2"):
            sd[p + f"{ln}.weight"] = _t(get(i, f"{ln}/scale"))
            sd[p + f"{ln}.bias"] = _t(get(i, f"{ln}/bias"))
        qkv = get(i, "attn_qkv/kernel")                      # [D, 3, H, hd]
        sd[p + "attn_qkv.weight"] = _t(qkv.reshape(D, -1).T)
        sd[p + "attn_qkv.bias"] = _t(get(i, "attn_qkv/bias").ravel())
        out = get(i, "attn_out/kernel")                       # [H, hd, D]
        sd[p + "attn_out.weight"] = _t(out.reshape(-1, D).T)
        sd[p + "attn_out.bias"] = _t(get(i, "attn_out/bias"))
        for name in ("mlp_up", "mlp_down"):
            sd[p + f"{name}.weight"] = _t(get(i, f"{name}/kernel").T)
            sd[p + f"{name}.bias"] = _t(get(i, f"{name}/bias"))
    leaves.finish()
    return sd


def resnet_params_from_jax(params, batch_stats) -> Dict[str, torch.Tensor]:
    """JAX ResNet ``params`` and ``batch_stats`` -> the port's ``ResNet``
    state_dict (``models/resnet.py`` keeps the JAX module names).

    Conv kernels ``[kh, kw, I, O]`` become ``[O, I, kh, kw]``; the head's
    ``[in, out]`` kernel becomes ``[out, in]``; each BatchNorm's
    ``scale``/``bias`` become its ``weight``/``bias`` and its
    ``batch_stats`` ``mean``/``var`` its ``running_mean``/``running_var``.
    Every leaf of both trees is mapped, or the call raises naming it.
    """
    leaves = _Leaves({"params": params, "batch_stats": batch_stats},
                     "resnet_params_from_jax", "A3")
    sd = {}
    for path in sorted(leaves.arrays):
        tree, *mods, leaf = path.split("/")
        kind = _resnet_kind(mods[-1]) if tree == "params" else None
        if kind is None:   # a statistic (taken with its norm) or unknown
            continue
        key = ".".join(_RESNET_NAMES.get(m, m) for m in mods)
        if kind == "head":
            a = leaves.take(path)
            sd[f"head.{'weight' if leaf == 'kernel' else 'bias'}"] = _t(
                a.T if leaf == "kernel" else a)
        elif kind == "conv":
            sd[f"{key}.weight"] = _t(leaves.take(path).transpose(3, 2, 0, 1))
        elif leaf == "scale":
            stats = "/".join(["batch_stats", *mods])
            sd[f"{key}.weight"] = _t(leaves.take(path))
            sd[f"{key}.running_mean"] = _t(leaves.take(f"{stats}/mean"))
            sd[f"{key}.running_var"] = _t(leaves.take(f"{stats}/var"))
        else:
            sd[f"{key}.bias"] = _t(leaves.take(path))
    leaves.finish()
    return sd


def _resnet_kind(module: str):
    """"conv", "bn", "head" or None for a JAX ResNet module name."""
    if module == "head":
        return "head"
    if module in ("stem", "proj") or module.startswith("Conv_"):
        return "conv"
    if module in ("stem_bn", "proj_bn") or module.startswith("BatchNorm_"):
        return "bn"
    return None


# flax's auto-names inside a block -> the port's attribute names
_RESNET_NAMES = {f"{kind}_{i}": f"{short}{i}" for i in range(3)
                 for kind, short in (("Conv", "conv"), ("BatchNorm", "bn"))}
