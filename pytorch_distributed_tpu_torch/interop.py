"""Weights carried across from the JAX package.

:func:`llama_params_from_jax` turns a JAX ``LlamaForCausalLM`` param tree
(nested dicts of numpy arrays; convert with ``jax.device_get``) into the
port's ``state_dict``, so the JAX model and the port can run on the same
weights. The port is its own layout: ``nn.Linear`` weights are
``[out, in]``, where the JAX kernels are ``[in, out]`` with heads kept as
their own axes.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def _layers(params, num_layers: int) -> List[dict]:
    """Per-layer trees from either JAX layout: the scan-stacked one
    (``params["layers"]["block"]`` with a leading ``[L]`` on every leaf)
    or the unrolled one (``params["layer{i}"]``)."""
    if "layers" in params:
        stacked = params["layers"]["block"]

        def take(tree, i):
            if isinstance(tree, dict):
                return {k: take(v, i) for k, v in tree.items()}
            return np.asarray(tree)[i]

        return [take(stacked, i) for i in range(num_layers)]
    return [params[f"layer{i}"] for i in range(num_layers)]


def llama_params_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    """JAX Llama params -> the port's ``LlamaForCausalLM`` state_dict.

    Kernel layouts on the JAX side: q/k/v ``[D, H, hd]``, o
    ``[H, hd, D]``, gate/up ``[D, I]``, down ``[I, D]``,
    ``embed/embedding [V, D]``, ``lm_head/kernel [D, V]``. Returned
    tensors are f32 CPU tensors; ``load_state_dict`` casts and moves
    them to the module's dtype and device.
    """
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    D = cfg.hidden_size
    sd = {
        "embed.weight": t(params["embed"]["embedding"]),
        "final_norm.weight": t(params["final_norm"]["scale"]),
        "lm_head.weight": t(np.asarray(params["lm_head"]["kernel"]).T),
    }
    for i, lyr in enumerate(_layers(params, cfg.num_layers)):
        p = f"layers.{i}."
        sd[p + "attn_norm.weight"] = t(lyr["attn_norm"]["scale"])
        sd[p + "mlp_norm.weight"] = t(lyr["mlp_norm"]["scale"])
        for name in ("q", "k", "v"):
            kern = np.asarray(lyr[name]["kernel"])       # [D, H, hd]
            sd[p + f"{name}.weight"] = t(kern.reshape(D, -1).T)
        o = np.asarray(lyr["o"]["kernel"])                # [H, hd, D]
        sd[p + "o.weight"] = t(o.reshape(-1, D).T)
        for name in ("gate", "up", "down"):
            sd[p + f"{name}.weight"] = t(np.asarray(lyr[name]["kernel"]).T)
    return sd
