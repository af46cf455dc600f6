"""Weight-only int8/int4 quantization: the port of
``pytorch_distributed_tpu/ops/quant.py``.

The JAX package quantizes a params pytree; the port quantizes a module's
tensors, keyed by their ``state_dict`` names, and keeps the JAX package's
geometry exactly, so the payloads are integer-equal to its own:

* every quantized tensor is held as one layer of its JAX leaf
  (``interop.Geometry``): a Dense kernel ``[*in, *out]`` (GPT-2's fused
  qkv ``[D, 3, H, hd]``, Llama's q/k/v ``[D, H, hd]``), not the torch
  ``[out, in]`` weight. :func:`symmetric_int8` reduces axis -2 of that
  kernel, which for those kernels is the HEADS axis, as in JAX; the int4
  quantizer packs adjacent OUT pairs per byte and groups along the last
  INPUT axis (axis -2);
* the gates (``include``/``exclude`` regexes over the '/'-prefixed JAX
  path, ``min_size`` and the rank test) read the whole JAX leaf, a
  scan-stacked one with its layer axis;
* rounding is ``round(f / scale)`` with the division, half to even
  (``torch.round`` as ``jnp.round``).

A tree (:class:`QuantizedTree`) is ``{port name: tensor or {"q8" | "q4",
"scale"}}`` with each entry's geometry beside it; ``interop``'s
``quantized_params_to_jax``/``quantized_params_from_jax`` carry one
across in either direction.

:class:`QuantizedModel` puts a tree into a model with
``torch.nn.utils.parametrize``: each quantized weight becomes a
parametrization whose two buffers are the payload and its f32 scales,
and whose value, the weight, is dequantized at every access inside its
own layer and dropped after it. The resident weights are the quantized
tree, plus one layer's weights while that layer runs: the JAX
``scan_dequant`` residency, by construction. Nothing caches the
dequantized weights (``parametrize.cached`` would undo it).

A scan-stacked JAX leaf whose reduction axis is the layer axis (a
stacked ``[L, n]`` bias or norm: its scales span the layers) has no
per-layer form, and the port keeps per-layer tensors: quantizing one
raises, naming :func:`quantize_for_scan_dequant`, which, as in JAX,
selects the scanned kernels only.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.nn.utils import parametrize

_QKEYS = frozenset({"q8", "scale"})
_Q4KEYS = frozenset({"q4", "scale"})


def _is_qleaf(x) -> bool:
    return isinstance(x, dict) and set(x.keys()) in (_QKEYS, _Q4KEYS)


class QuantizedTree(dict):
    """``{port name: tensor or quantized leaf}`` with ``geometry``:
    ``{port name: interop.Geometry}`` for every entry."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.geometry: Dict[str, object] = {}


def symmetric_int8(x: torch.Tensor, axis: int):
    """``(q8, scale)``: symmetric int8 with ``scale = amax / 127`` reduced
    over ``axis`` (keepdims), f32. Shared by the weight quantizer (axis
    -2 of the JAX kernel) and the int8 KV cache (axis -1, per token)."""
    f = x.float()
    amax = f.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(f / scale), -127, 127).to(torch.int8)
    return q, scale


def _regs(patterns):
    return [re.compile(p) for p in patterns] if patterns is not None else None


def _skip(g, regs, excl, min_size: int) -> bool:
    """The JAX quantizer's gate, read on the whole (stacked) JAX leaf."""
    shape = g.stacked_shape
    if len(shape) < 2 or math.prod(shape) < min_size:
        return True
    p = "/" + "/".join(g.path)
    if excl is not None and any(r.search(p) for r in excl):
        return True
    return regs is not None and not any(r.search(p) for r in regs)


def _refuse_cross_layer(name: str, g) -> None:
    if g.layer is not None and len(g.jshape) < 2:
        raise NotImplementedError(
            f"{name}: the JAX leaf {'/'.join(g.path)} {g.stacked_shape} "
            "quantizes over its layer axis, and the port keeps one tensor "
            "per layer; build the tree with quantize_for_scan_dequant (the "
            "scanned kernels only) or exclude the leaf")


def _quantize(model, quant, include, exclude, min_size, extra_skip=None):
    from pytorch_distributed_tpu_torch import interop

    base = getattr(model, "wrapped_model", model)
    geoms = interop.geometries(base)
    regs, excl = _regs(include), _regs(exclude)
    named = dict(base.named_parameters())
    named.update(base.named_buffers())
    tree = QuantizedTree()
    with torch.no_grad():
        for name, g in geoms.items():
            t = named[name].detach()
            if _skip(g, regs, excl, min_size) or (
                    extra_skip is not None and extra_skip(g)):
                tree[name] = t
            else:
                _refuse_cross_layer(name, g)
                tree[name] = quant(g.to_jax(t))
            tree.geometry[name] = g
    return tree


def quantize_tree_int8(
    model,
    *,
    include: Optional[Sequence[str]] = None,
    exclude: Optional[Sequence[str]] = None,
    min_size: int = 4096,
) -> QuantizedTree:
    """Symmetric int8 with axis(-2)-reduced scales for every tensor whose
    JAX leaf passes the gate (>= 2-D, ``min_size`` elements, ``include``
    regexes matching and ``exclude`` ones not, over '/'-prefixed JAX
    paths); the others stay as they are. Each quantized entry is
    ``{"q8": int8 [jshape], "scale": f32 [..., 1, out]}``."""

    def quant(f):
        q, scale = symmetric_int8(f, f.dim() - 2)
        return {"q8": q, "scale": scale}

    return _quantize(model, quant, include, exclude, min_size)


def _quant4(f: torch.Tensor, group_size: int) -> dict:
    f = f.float()
    in_last, out = f.shape[-2], f.shape[-1]
    g = group_size if in_last % group_size == 0 else in_last
    grouped = f.reshape(*f.shape[:-2], in_last // g, g, out)
    amax = grouped.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(grouped / scale), -7, 7).to(torch.int32)
    q = q.reshape(f.shape)
    # adjacent out pairs (2j, 2j+1) -> low | high nibble of one byte
    lo = q[..., 0::2] & 0xF
    hi = q[..., 1::2] & 0xF
    return {"q4": (lo | (hi << 4)).to(torch.uint8), "scale": scale}


def quantize_tree_int4(
    model,
    *,
    group_size: int = 128,
    include: Optional[Sequence[str]] = None,
    exclude: Optional[Sequence[str]] = None,
    min_size: int = 4096,
) -> QuantizedTree:
    """Symmetric groupwise int4 (range +-7), two values a byte: ``q4``
    ``[..., in_last, out/2]`` uint8 (out pairs packed), ``scale`` ``[...,
    in_last/g, 1, out]`` f32 (``group_size`` input rows a group, or the
    whole axis when it does not divide). An odd out axis stays full
    precision, as in JAX."""
    return _quantize(model, lambda f: _quant4(f, group_size), include,
                     exclude, min_size,
                     extra_skip=lambda g: g.jshape[-1] % 2 == 1)


def _dq4(leaf: dict) -> torch.Tensor:
    packed, scale = leaf["q4"], leaf["scale"]
    if packed.dim() < 2:
        raise ValueError("1-D int4 leaf: int4 leaves are >= 2-D kernels")
    v = packed.to(torch.int16)
    # sign-extend each nibble: (x ^ 8) - 8 maps 0..15 onto 0..7, -8..-1;
    # the pairs were (2j, 2j + 1) = (low, high)
    q = torch.stack([((v & 0xF) ^ 8) - 8, (((v >> 4) & 0xF) ^ 8) - 8],
                    dim=-1).reshape(*packed.shape[:-1], 2 * packed.shape[-1])
    in_last, groups = q.shape[-2], scale.shape[-3]
    grouped = q.reshape(*q.shape[:-2], groups, in_last // groups, q.shape[-1])
    return (grouped * scale).reshape(q.shape)


def dequantize_leaf(leaf: dict, dtype=None) -> torch.Tensor:
    """One quantized leaf -> its float kernel in the JAX geometry
    (f32 unless ``dtype``): the integer payload times its f32 scales,
    in f32, then the cast."""
    out = _dq4(leaf) if "q4" in leaf else leaf["q8"] * leaf["scale"]
    return out.to(dtype or torch.float32)


def dequantize_tree(qparams: QuantizedTree,
                    dtype=None) -> Dict[str, torch.Tensor]:
    """The inverse of the quantizers, up to quantization error: a
    ``state_dict`` of port tensors (quantized ones reconstructed in
    ``dtype``, f32 by default, and mapped back to the port layout;
    the others as they are)."""
    out = {}
    for name, leaf in qparams.items():
        if _is_qleaf(leaf):
            out[name] = qparams.geometry[name].from_jax(
                dequantize_leaf(leaf, dtype))
        else:
            out[name] = leaf
    return out


def quantized_bytes(qparams) -> int:
    """Resident bytes of the (possibly partly) quantized tree."""
    total = 0
    for leaf in qparams.values():
        if _is_qleaf(leaf):
            q = leaf["q8"] if "q8" in leaf else leaf["q4"]
            total += q.numel() + leaf["scale"].numel() * 4
        else:
            total += leaf.numel() * leaf.element_size()
    return total


def quantize_for_scan_dequant(model, kind: str = "int4",
                              **kw) -> QuantizedTree:
    """Quantize the kernels of the scanned layer stack only (JAX paths
    ``.../block/.../kernel``; the mixture-of-experts weights and router of
    the JAX pattern are not in a ported model): the tree the JAX
    ``scan_dequant`` path serves. ``kind``: "int4" or "int8"; extra
    keywords go to the quantizer."""
    include = (r"/block/.*/kernel$", r"/block/.*/w_(in|gate|out)$")
    exclude = (r"/router/",)
    if kind == "int4":
        return quantize_tree_int4(model, include=include, exclude=exclude,
                                  **kw)
    if kind == "int8":
        return quantize_tree_int8(model, include=include, exclude=exclude,
                                  **kw)
    raise ValueError(f"kind must be 'int4' or 'int8', got {kind!r}")


class _Dequant(nn.Module):
    """The parametrization of one quantized weight: its originals are the
    payload and the scales (buffers); its value is the weight in the port
    layout, in ``dtype``, made anew at each access."""

    def __init__(self, leaf: dict, geometry, dtype):
        super().__init__()
        self.kind = "q4" if "q4" in leaf else "q8"
        self.geometry = geometry
        self.pshape = geometry.pshape
        self.dtype = dtype
        self._leaf = leaf

    def right_inverse(self, _weight):
        leaf, self._leaf = self._leaf, None
        return leaf[self.kind], leaf["scale"]

    def forward(self, payload, scale):
        w = dequantize_leaf({self.kind: payload, "scale": scale})
        # cast and laid out in the port's layout in one copy: the
        # products then run as on a plain weight, to the bit
        out = torch.empty(self.pshape, dtype=self.dtype or torch.float32,
                          device=w.device)
        return out.copy_(self.geometry.from_jax(w))


def module_device(model: nn.Module) -> torch.device:
    """A model's device: its ``device`` property, else its first
    tensor's."""
    dev = getattr(model, "device", None)
    if dev is not None:
        return dev
    for t in model.parameters():
        return t.device
    for t in model.buffers():
        return t.device
    raise ValueError("a model without tensors has no device")


def _owner(model: nn.Module, name: str):
    mod_name, _, tensor = name.rpartition(".")
    return (model.get_submodule(mod_name) if mod_name else model), tensor


def apply_quantized(model: nn.Module, qparams: QuantizedTree,
                    dtype=None) -> nn.Module:
    """Put ``qparams`` into ``model`` in place: each quantized weight
    becomes a :class:`_Dequant` parametrization over its payload and
    scales (moved to the model's device), the float weight dropped;
    the other entries are copied into their tensors."""
    device = module_device(model)
    with torch.no_grad():
        for name, leaf in qparams.items():
            mod, tensor = _owner(model, name)
            if not _is_qleaf(leaf):
                getattr(mod, tensor).copy_(leaf)
                continue
            if parametrize.is_parametrized(mod, tensor):
                raise ValueError(f"{name} is already parametrized")
            leaf = {k: v.to(device) for k, v in leaf.items()}
            # the weight becomes a buffer first, so the originals the
            # parametrization registers are buffers (payload, scales)
            old = getattr(mod, tensor)
            delattr(mod, tensor)
            mod.register_buffer(tensor, torch.empty(0, dtype=old.dtype,
                                                    device=device))
            del old
            parametrize.register_parametrization(
                mod, tensor, _Dequant(leaf, qparams.geometry[name], dtype),
                unsafe=True)
    return model


def quantized_apply_fn(model: nn.Module, qparams: QuantizedTree, dtype=None):
    """``model`` with ``qparams`` in it (:func:`apply_quantized`),
    returned as its forward: the JAX ``quantized_apply_fn``'s "dequantize
    inside the step", which here happens per layer at each access."""
    return apply_quantized(model, qparams, dtype).forward


class QuantizedModel(nn.Module):
    """A model over a quantized tree (int8 or int4)::

        q = quantize_for_scan_dequant(model, "int4")
        qm = QuantizedModel(model, q, dtype=torch.bfloat16)
        out = generate(qm, ids, max_new_tokens=32)

    ``model`` is modified in place (:func:`apply_quantized`); the
    float weights of the quantized entries are freed. ``dtype`` is the
    reconstruction dtype (the compute dtype halves the transient against
    the f32 default). It slots into ``generate``, ``generate_beam``,
    ``generate_speculative`` and the LoRA wrapper (QLoRA)."""

    def __init__(self, model: nn.Module, qparams: QuantizedTree, dtype=None):
        super().__init__()
        self.model = apply_quantized(model, qparams, dtype)

    @property
    def wrapped_model(self) -> nn.Module:
        return self.model

    @property
    def config(self):
        return getattr(self.model, "config", None)

    @property
    def device(self) -> torch.device:
        return module_device(self.model)

    def forward(self, *args, **kwargs):
        return self.model(*args, **kwargs)
