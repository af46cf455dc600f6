"""LoRA fine-tuning: the port of ``pytorch_distributed_tpu/lora.py``.

Low-rank adapters on a frozen base: every matched Dense kernel ``W``
becomes ``W + (alpha/r) * A @ B``, and only ``A`` and ``B`` train, so the
gradients, the optimizer's moments and the checkpoint are the adapter
tree alone. The JAX package merges inside its jitted step; the port puts
the same sum on the weight with ``torch.nn.utils.parametrize``: each
adapted weight is recomputed at every access from its frozen original
and its two adapter parameters, inside its own layer.

The adapters keep the JAX geometry. A kernel's JAX shape is ``[*in,
*out]`` (GPT-2's fused qkv ``[D, 3, H, hd]``, Llama's q ``[D, H, hd]``,
BERT's attention out ``[H, hd, D]``; :data:`DEFAULT_TARGETS` names how
many trailing axes are OUT), ``a`` is ``[prod(in), r]`` (fan-in-scaled
normal) and ``b`` ``[r, prod(out)]`` (zeros: the model starts exactly
at its base). The JAX scan-stacked kernels (``.../block/...``) carry a
leading layer axis on their adapters; the port holds one adapter per
layer, and ``interop.lora_params_to_jax``/``lora_params_from_jax``
stack and split them. An adapter tree is ``{port weight name: {"a",
"b"}}``.

QLoRA composes: wrap a ``ops.quant.QuantizedModel`` and each adapted
weight dequantizes, then adds its delta, in one chain of
parametrizations.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional

import torch
from torch import nn
from torch.nn.utils import parametrize

from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.ops.quant import (
    QuantizedTree,
    _owner,
    dequantize_tree,
    module_device,
)

# pattern (over the '/'-prefixed JAX path) -> trailing OUT axes of the
# matched kernel. GPT-2: fused qkv [D, 3, H, hd] (3), attn_out [H, hd, D]
# (1), mlp_{up,down} [in, out] (1). Llama: q/k/v [D, H, hd] (2), o
# [H, hd, D] (1), gate/up/down (1). BERT: query/key/value [D, H, hd] (2),
# attn/out [H, hd, D] (1).
DEFAULT_TARGETS: Dict[str, int] = {
    r"attn_qkv/kernel$": 3,
    r"attn_out/kernel$": 1,
    r"mlp_(up|down)/kernel$": 1,
    r"/(q|k|v)/kernel$": 2,
    r"/o/kernel$": 1,
    r"/(gate|up|down)/kernel$": 1,
    r"/(query|key|value)/kernel$": 2,
    r"/out/kernel$": 1,
}


def _base(model):
    model = getattr(model, "module", model)
    return getattr(model, "wrapped_model", model)


def lora_sites(model, targets: Optional[Dict[str, int]] = None):
    """``{port weight name: (geometry, fan_in, fan_out)}`` for every
    kernel a target pattern matches, in JAX path order."""
    targets = DEFAULT_TARGETS if targets is None else targets
    sites = {}
    geoms = interop.geometries(_base(model))
    for name, g in sorted(geoms.items(),
                          key=lambda kv: (kv[1].path, kv[1].layer or 0)):
        p = "/" + "/".join(g.path)
        hits = [n for pat, n in targets.items() if re.search(pat, p)]
        if len(hits) > 1:
            raise ValueError(
                f"kernel {p} matched {len(hits)} LoRA target patterns — "
                "make the patterns disjoint")
        if not hits:
            continue
        n_out = hits[0]
        if len(g.jshape) < 1 + n_out:
            raise ValueError(
                f"kernel {p} has shape {g.jshape} — too few axes for >= 1 "
                f"in + {n_out} out")
        fan_in = math.prod(g.jshape[:len(g.jshape) - n_out])
        sites[name] = (g, fan_in, math.prod(g.jshape[len(g.jshape) - n_out:]))
    if not sites:
        raise ValueError(
            f"no kernel matched any LoRA target pattern — patterns "
            f"{list(targets)} against paths like "
            f"{['/'.join(g.path) for g in list(geoms.values())[:4]]}")
    return sites


def lora_init(generator: torch.Generator, model, rank: int,
              targets: Optional[Dict[str, int]] = None):
    """The trainable adapter tree for ``model``: ``{port weight name:
    {"a": [in, r] normal / sqrt(in), "b": [r, out] zeros}}`` (f32, on the
    generator's device), one per matched kernel and layer."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    out = {}
    for name, (_, fan_in, fan_out) in lora_sites(model, targets).items():
        a = torch.randn((fan_in, rank), generator=generator,
                        device=generator.device) / math.sqrt(fan_in)
        out[name] = {"a": a, "b": torch.zeros((rank, fan_out),
                                              device=generator.device)}
    return out


def _delta(a, b, alpha, geometry):
    r = a.shape[-1]
    scale = (alpha if alpha is not None else r) / r
    return geometry.from_jax(((a @ b) * scale).reshape(geometry.jshape))


def lora_merge(base, adapters, *, alpha: Optional[float] = None, dtype=None):
    """``W + (alpha/r) * A @ B`` for every adapted weight: a ``state_dict``
    that loads into the plain model. ``base`` is the model (plain, or a
    ``QuantizedModel``) or a quantized tree, whose quantized entries are
    reconstructed in ``dtype`` (f32 by default) first, adapted or not.
    ``alpha`` defaults to the rank. Every adapter must find its weight."""
    if isinstance(base, QuantizedTree):
        merged = dequantize_tree(base, dtype)
        geoms = base.geometry
    else:
        model = _base(base)
        geoms = interop.geometries(model)
        merged = {}
        for name in interop.logical_shapes(model):
            mod, t = _owner(model, name)
            merged[name] = getattr(mod, t).detach()
    missing = sorted(set(adapters) - set(merged))
    if missing:
        raise ValueError(
            f"adapters for {missing} found no weight — the adapter and "
            "model layouts disagree; merging would silently train nothing")
    for name, ab in adapters.items():
        w = merged[name]
        merged[name] = w + _delta(ab["a"].to(w.device), ab["b"].to(w.device),
                                  alpha, geoms[name]).to(w.dtype)
    return merged


class _LoRADelta(nn.Module):
    """The parametrization of one adapted weight: ``w + (alpha/r) *
    from_jax(a @ b)``, added in ``w``'s dtype after an f32 product."""

    def __init__(self, a, b, alpha, geometry):
        super().__init__()
        self.a = nn.Parameter(a)
        self.b = nn.Parameter(b)
        self.alpha = alpha
        self.geometry = geometry
        self.pshape = geometry.pshape

    def forward(self, w):
        return w + _delta(self.a, self.b, self.alpha, self.geometry).to(
            w.dtype)


class LoRAModel(nn.Module):
    """``model`` with adapters: its own parameters frozen
    (``requires_grad=False``), the adapters (``adapters``, or fresh ones
    of ``rank`` from ``generator``) its only trainable parameters.
    ``model`` may be a ``QuantizedModel`` (QLoRA). The forward is the
    model's, so the loss functions, the Trainer, DDP and ``generate``
    take it as they take the model. ``model`` is modified in place."""

    def __init__(self, model: nn.Module, adapters=None, *,
                 rank: Optional[int] = None, alpha: Optional[float] = None,
                 generator: Optional[torch.Generator] = None,
                 targets: Optional[Dict[str, int]] = None):
        super().__init__()
        if adapters is None:
            if rank is None or generator is None:
                raise ValueError(
                    "LoRAModel needs adapters, or a rank and a generator")
            adapters = lora_init(generator, model, rank, targets)
        base = _base(model)
        for p in model.parameters():
            p.requires_grad_(False)
        geoms = interop.geometries(base)
        device = module_device(base)
        self.alpha = alpha
        self._deltas: Dict[str, _LoRADelta] = {}
        for name, ab in adapters.items():
            if name not in geoms:
                raise ValueError(f"no weight {name!r} to adapt")
            delta = _LoRADelta(
                ab["a"].detach().to(device, torch.float32).clone(),
                ab["b"].detach().to(device, torch.float32).clone(),
                alpha, geoms[name])
            mod, t = _owner(base, name)
            parametrize.register_parametrization(mod, t, delta, unsafe=True)
            self._deltas[name] = delta
        self.model = model

    @property
    def wrapped_model(self) -> nn.Module:
        return self.model

    @property
    def config(self):
        return getattr(self.model, "config", None)

    @property
    def device(self) -> torch.device:
        return module_device(self.model)

    def adapters(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The adapter tree, as live parameters."""
        return {n: {"a": d.a, "b": d.b} for n, d in self._deltas.items()}

    def adapter_slots(self) -> Dict[str, "interop.Slot"]:
        """``{state_dict name: interop.Slot}`` of every adapter parameter:
        the checkpoint's params are the adapter tree, under the JAX
        leaves ``<kernel path>/a`` and ``/b`` (one layer of a stacked
        ``[L, in, r]`` leaf for a scanned kernel)."""
        ids = {id(p): n for n, p in self.named_parameters()}
        slots = {}
        for d in self._deltas.values():
            g = d.geometry
            for leaf in ("a", "b"):
                slots[ids[id(getattr(d, leaf))]] = interop.Slot(
                    "params", g.path + (leaf,), g.layer, g.depth,
                    interop._same, interop._same)
        return slots

    def forward(self, *args, **kwargs):
        return self.model(*args, **kwargs)


def lora_param_count(adapters) -> int:
    """Trainable parameter count of an adapter tree."""
    return sum(ab["a"].numel() + ab["b"].numel() for ab in adapters.values())
