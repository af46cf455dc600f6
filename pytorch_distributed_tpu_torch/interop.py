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
(:class:`_Leaves`): a leaf it does not map, such as the experts of a
mixture-of-experts GPT-2 or a leaf the config does not enable (q/k/v
biases without ``attention_bias``), is an error that names the leaf and
the ROADMAP item, never a weight silently left behind. The Llama
converters carry every Llama-body family (the q/k/v biases, the
``q_norm``/``k_norm`` scales, a tied tree without ``lm_head``), and
:func:`neox_params_from_jax`/:func:`neox_params_to_jax`/
:func:`neox_slots` carry GPT-NeoX.

:func:`bert_params_from_jax` does the same for a JAX
``BertForSequenceClassification`` or ``BertForMaskedLM`` tree (its
unscanned ``layer{i}`` layout), through the same slots as the
checkpoints below.

The other direction serves the checkpoints both packages read:
:func:`gpt2_slots`, :func:`llama_slots`, :func:`neox_slots`,
:func:`bert_slots`, :func:`resnet_slots` and
:func:`model_slots` place every port tensor at its JAX ``TrainState``
leaf (path, layer of a scan-stacked leaf, layout map; a Llama or GPT-2
slot also maps any box of the port tensor, an FSDP or TP shard, to
boxes of the JAX leaf: a TP GPT-2's fused qkv rows, grouped by rank,
are head ranges of its ``[D, 3, H, hd]`` kernel),
:func:`gpt2_params_to_jax`, :func:`llama_params_to_jax`,
:func:`bert_params_to_jax` and
:func:`resnet_params_to_jax` are the inverses of the converters above,
and :func:`optimizer_layout` names the optax state (``mu``, ``nu``,
``count``, ``trace``, Adafactor's ``v_row``/``v_col``/``v``, LARS's
``v``) that a port optimizer's state stands for.

Hugging Face layouts (the JAX package's ``load_*``/``export_*``): the
``load_*`` functions take an HF-named state_dict (numpy arrays or
tensors, e.g. ``torch.load("model.pt")``) and return the port model's
state_dict, each tensor in the dtype it came in; the ``export_*``
functions take the port's state_dict and return the HF-named one as
numpy arrays (f32 for floating tensors). GPT-2, the Llama body (with
its Mistral, Qwen2, Qwen3 and Gemma aliases), Phi-3 (fused ``qkv_proj``
and ``gate_up_proj``), GPT-NeoX, and T5 (each stack's relative-bias
table, which HF hangs on block 0, on the stack). The port's layouts are
HF's own ``[out, in]`` ones, so the maps are renames (GPT-2's ``Conv1D``
weights transposed, Phi-3's fused ones split).

T5 (:func:`t5_slots`, :func:`t5_params_from_jax`,
:func:`t5_params_to_jax`) carries the JAX tree in either layout of its
layers, scan-stacked or unrolled (``T5Config.scan_layers``).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import re
from typing import Callable, Dict, List, Optional, Tuple, Union

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


def _params_from_slots(params, slots, what: str, stack: str,
                       prefix: str) -> Dict[str, torch.Tensor]:
    """A JAX variable tree (scan-stacked ``{stack}/block/...`` or unrolled
    ``{prefix}{i}/...``) -> the port's state_dict through ``slots``, every
    leaf accounted for."""
    leaves = _Leaves(params, what, "A7")
    get = _layer_getter(leaves, stack, prefix)
    sd = {}
    for name, slot in slots.items():
        if slot.layer is None:
            arr = leaves.take("/".join(slot.path))
        else:   # ("layers", "block", module, leaf)
            arr = get(slot.layer, "/".join(slot.path[2:]))
        sd[name] = _t(slot.from_jax(arr))
    leaves.finish()
    return sd


def llama_params_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    """JAX Llama-body params (Llama, Gemma, Mistral, Qwen2, Qwen3, Phi-3)
    -> the port's ``LlamaForCausalLM`` state_dict.

    Kernel layouts on the JAX side: q/k/v ``[D, H, hd]`` (biases
    ``[H, hd]`` with ``attention_bias``), o ``[H, hd, D]``, gate/up
    ``[D, I]``, down ``[I, D]``, ``embed/embedding [V, D]``,
    ``lm_head/kernel [D, V]`` (none when ``tie_word_embeddings``: the
    head is the embedding), ``q_norm``/``k_norm`` ``[hd]`` scales with
    ``qk_norm``. Either layout of the layers (scan-stacked or unrolled).
    Returned tensors are f32 CPU tensors; ``load_state_dict`` casts and
    moves them to the module's dtype and device. A leaf the config does
    not enable, or one it needs and the tree lacks, raises
    ``NotImplementedError`` naming it.
    """
    return _params_from_slots(params, llama_slots(cfg),
                              "llama_params_from_jax", "layers", "layer")


def neox_params_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``NeoXForCausalLM`` params -> the port's state_dict: ``qkv``
    ``[D, H, 3, hd]`` (bias ``[H, 3, hd]``), ``attn_out`` ``[H, hd, D]``,
    ``mlp_up``/``mlp_down``/``embed_out`` ``[in, out]``, LayerNorm
    ``scale``/``bias``; f32 CPU tensors, either layout of the layers."""
    return _params_from_slots(params, neox_slots(cfg),
                              "neox_params_from_jax", "layers", "layer")


def gpt2_params_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    """JAX GPT-2 params -> the port's ``GPT2LMHead`` state_dict.

    Reads both JAX layouts: scan-stacked (``blocks/block``, a leading
    ``[L]`` on every leaf) and unrolled (``block{i}``). Kernel layouts on
    the JAX side: ``attn_qkv`` ``[D, 3, H, hd]`` (bias ``[3, H, hd]``),
    ``attn_out`` ``[H, hd, D]``, ``mlp_up``/``mlp_down`` ``[in, out]``,
    ``wte`` ``[V, D]``, ``wpe`` ``[P, D]``, LayerNorm ``scale``/``bias``.
    Returned tensors are f32 CPU tensors; ``load_state_dict`` casts and
    moves them to the module's dtype and device. With ``moe_experts``
    each block's FFN is ``moe/router/kernel`` ``[D, E]`` (the port's
    ``[E, D]``) and the stacked ``moe/w_in`` ``[E, D, F]`` and
    ``moe/w_out`` ``[E, F, D]``; expert leaves given to a dense config
    (or dense leaves to an expert one) raise ``NotImplementedError``
    naming A7.
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
        if cfg.moe_experts > 0:
            sd[p + "moe.router.weight"] = _t(get(i, "moe/router/kernel").T)
            for name in ("w_in", "w_out"):
                sd[p + f"moe.{name}"] = _t(get(i, f"moe/{name}"))
            continue
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


# --------------------------------------------------------------------------
# The other direction: the port's state under the JAX TrainState's leaves.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Slot:
    """Where one port tensor lives in the JAX ``TrainState``: the tree
    (``"params"`` or ``"batch_stats"``), the path inside it, the layer
    it fills of a scan-stacked leaf (``None``: the whole leaf), the
    stack's depth, and the two layout maps (port -> JAX, JAX -> port)
    for one layer's array."""

    tree: str
    path: Tuple[str, ...]
    layer: Optional[int]
    depth: int
    to_jax: Callable[[np.ndarray], np.ndarray]
    from_jax: Callable[[np.ndarray], np.ndarray]
    # a permuted slot (llama_slots): the port tensor is the JAX array of
    # one layer, shape ``jshape``, transposed by ``perm`` and reshaped so
    # that its first ``rows`` axes make the port's dim 0 and the rest
    # its dim 1; ``rows`` a tuple gives the count of axes of every port
    # dim (the 3-D expert tensors: ``(1, 1, 1)``)
    perm: Optional[Tuple[int, ...]] = None
    jshape: Optional[Tuple[int, ...]] = None
    rows: Union[int, Tuple[int, ...]] = 1
    # the JAX leaf's one-layer shape when ``jshape`` splits its axes
    # (consecutive axes of ``jshape`` make one of it: GPT-2's heads as
    # ``(ways, H / ways)``); None when ``jshape`` is the leaf's own
    leaf: Optional[Tuple[int, ...]] = None

    def groups(self) -> List[Tuple[int, ...]]:
        """The JAX axes (of ``perm``'s order) that fold into each port
        dim, outermost first; a 1-D tensor's second group is empty."""
        perm = self.perm
        if isinstance(self.rows, int):
            return [perm[:self.rows], perm[self.rows:]]
        out, i = [], 0
        for n in self.rows:
            out.append(perm[i:i + n])
            i += n
        return out

    def leaf_shape(self, port_shape) -> Tuple[int, ...]:
        """The JAX leaf's full shape, from the port tensor's shape."""
        one = self.to_jax(np.empty(port_shape, np.float32)).shape
        return one if self.layer is None else (self.depth,) + one

    def boxes(self, starts, sizes):
        """The port tensor's box at ``starts`` with ``sizes`` (one entry
        per port dim: an FSDP shard's rows, a TP shard's rows or
        columns, or both) as boxes of the JAX leaf: ``[(ranges, start,
        stop, to_jax, from_jax)]``, where the port sub-block ``ranges``
        (a ``(lo, hi)`` per port dim) fills the box ``[start, stop)``
        (the layer axis of a stacked leaf included) and the two maps turn
        that sub-block into the box's array and back. A range that cuts a
        head (q's ``[H * hd, D]`` rows against the JAX ``[D, H, hd]``)
        becomes a partial-head box, whole heads and another partial
        one."""
        if self.perm is None:
            raise NotImplementedError(
                f"{'/'.join(self.path)}: boxes of this slot have no JAX box "
                "(sharded checkpoints cover Llama; ROADMAP A6)")
        perm, js = self.perm, self.jshape
        inv = tuple(int(i) for i in np.argsort(perm))
        groups = self.groups()[:len(starts)]
        per_dim = [_flat_segments(lo, lo + n, [js[i] for i in g])
                   for lo, n, g in zip(starts, sizes, groups)]
        lead = () if self.layer is None else (self.layer,)
        merged = self._leaf_axes()
        out = []
        for combo in itertools.product(*per_dim):
            start, stop = [0] * len(js), list(js)
            ranges, shape = [], []
            for g, (lo, hi, axis_ranges) in zip(groups, combo):
                ranges.append((lo, hi))
                for axis, (alo, ahi) in zip(g, axis_ranges):
                    start[axis], stop[axis] = alo, ahi
                    shape.append(ahi - alo)
            pshape = tuple(hi - lo for lo, hi in ranges)
            fine = tuple(b - a for a, b in zip(start, stop))
            start, stop = _merge_box(start, stop, js, merged)
            box = tuple(b - a for a, b in zip(start, stop))
            out.append((
                tuple(ranges), lead + tuple(start),
                tuple(x + 1 for x in lead) + tuple(stop),
                lambda x, shape=tuple(shape), box=box:
                    x.reshape(shape).transpose(inv).reshape(box),
                lambda y, pshape=pshape, fine=fine:
                    y.reshape(fine).transpose(perm).reshape(pshape),
            ))
        return out

    def _leaf_axes(self) -> List[Tuple[int, ...]]:
        """The axes of ``jshape`` that make each axis of the leaf (one
        each unless ``leaf`` splits them)."""
        js = self.jshape
        if self.leaf is None:
            return [(i,) for i in range(len(js))]
        out, i = [], 0
        for n in self.leaf:
            group, size = [], 1
            while i < len(js) and (not group or size < n):
                group.append(i)
                size *= js[i]
                i += 1
            if size != n:
                raise ValueError(f"{js} does not split {self.leaf}")
            out.append(tuple(group))
        if i != len(js):
            raise ValueError(f"{js} does not split {self.leaf}")
        return out


def _merge_box(start, stop, js, merged):
    """A box of the split axes ``js`` as a box of the leaf's axes
    (``merged``: the split axes of each): each leaf axis's range runs
    from the flat index of its split axes' starts to that of their last
    entries, which is a box when the split ranges are whole inside a
    partial one (as :func:`_flat_segments` cuts them)."""
    out_start, out_stop = [], []
    for group in merged:
        lo = hi = 0
        for i in group:
            lo = lo * js[i] + start[i]
            hi = hi * js[i] + stop[i] - 1
        n = math.prod(stop[i] - start[i] for i in group)
        if hi + 1 - lo != n:
            raise ValueError(f"a box {start}..{stop} of {js} cuts across "
                             f"the merged axes {group}")
        out_start.append(lo)
        out_stop.append(hi + 1)
    return out_start, out_stop


def _flat_segments(a: int, b: int, dims):
    """``[a, b)`` of a dim that folds the axes ``dims`` (outermost first)
    as ``[(lo, hi, per-axis (lo, hi))]`` pieces, each a box of the axes:
    whole runs of the outer axis, and partial ones at the ends (split
    the same way over the inner axes)."""
    if len(dims) == 1:
        return [(a, b, [(a, b)])]
    inner = math.prod(dims[1:])
    out = []
    while a < b:
        h, r = divmod(a, inner)
        if r or b - a < inner:
            end = min(b, (h + 1) * inner)
            for lo, hi, rs in _flat_segments(r, r + end - a, dims[1:]):
                out.append((h * inner + lo, h * inner + hi,
                            [(h, h + 1)] + rs))
        else:
            end = (b // inner) * inner
            out.append((a, end, [(h, end // inner)]
                        + [(0, n) for n in dims[1:]]))
        a = end
    return out


def _permuted(tree, path, layer, depth, jshape, perm, rows=1,
              leaf=None) -> Slot:
    """A :class:`Slot` whose maps are a transpose by ``perm`` and a
    reshape: port ``[prod(row axes), prod(the rest)]`` (or, ``rows`` a
    tuple, one port dim per group of axes). ``leaf``: the leaf's own
    one-layer shape when ``jshape`` splits its axes."""
    inv = tuple(int(i) for i in np.argsort(perm))
    probe = Slot(tree, path, layer, depth, _same, _same, perm=tuple(perm),
                 jshape=tuple(jshape), rows=rows)
    pshape = tuple(int(np.prod([jshape[i] for i in g]))
                   for g in probe.groups() if len(g))
    out_shape = tuple(jshape) if leaf is None else tuple(leaf)
    return Slot(
        tree, path, layer, depth,
        lambda w: w.reshape([jshape[i] for i in perm]).transpose(
            inv).reshape(out_shape),
        lambda k: k.reshape(jshape).transpose(perm).reshape(pshape),
        perm=tuple(perm), jshape=tuple(jshape), rows=rows,
        leaf=None if leaf is None else tuple(leaf))


def _same(a):
    return a


def gpt2_slots(cfg, layers: Optional[Tuple[int, int]] = None,
               qkv_ways: int = 1) -> Dict[str, Slot]:
    """``{port name: Slot}`` for ``GPT2LMHead``: the scan-stacked JAX
    layout (``blocks/block/...`` with a leading ``[L]``), the one the
    JAX recipe trains. ``layers=(start, stop)`` gives a pipeline stage's:
    its ``blocks.{i}`` are layers ``start + i`` of the stack.
    ``qkv_ways``: the model's grouping of the fused qkv rows
    (``GPT2LMHead.qkv_ways``): ``attn_qkv.weight`` ``[3 * H * hd, D]``
    in the ``(ways, 3, H / ways, hd)`` order is the ``[D, 3, H, hd]``
    kernel with its heads split ``(ways, H / ways)``, so a rank's rows
    are a head range of it. Every slot maps any box of its tensor (a TP
    shard's rows or columns) to boxes of the leaf."""
    D, H, V = cfg.hidden_size, cfg.num_heads, cfg.vocab_size
    L, hd, I = cfg.num_layers, cfg.head_dim, cfg.intermediate_size
    t = qkv_ways
    slots = {
        "wte.weight": _permuted("params", ("wte", "embedding"), None, 0,
                                (V, D), (0, 1)),
        "wpe.weight": _permuted("params", ("wpe", "embedding"), None, 0,
                                (cfg.n_positions, D), (0, 1)),
        "ln_f.weight": _permuted("params", ("ln_f", "scale"), None, 0,
                                 (D,), (0,)),
        "ln_f.bias": _permuted("params", ("ln_f", "bias"), None, 0, (D,),
                               (0,)),
    }
    # (module, leaf, jshape, perm, rows, leaf shape when split)
    per_layer = {
        "ln1.weight": ("ln1", "scale", (D,), (0,), 1, None),
        "ln1.bias": ("ln1", "bias", (D,), (0,), 1, None),
        "ln2.weight": ("ln2", "scale", (D,), (0,), 1, None),
        "ln2.bias": ("ln2", "bias", (D,), (0,), 1, None),
        "attn_qkv.weight": ("attn_qkv", "kernel", (D, 3, t, H // t, hd),
                            (2, 1, 3, 4, 0), 4, (D, 3, H, hd)),
        "attn_qkv.bias": ("attn_qkv", "bias", (3, t, H // t, hd),
                          (1, 0, 2, 3), 4, (3, H, hd)),
        "attn_out.weight": ("attn_out", "kernel", (H, hd, D), (2, 0, 1), 1,
                            None),
        "attn_out.bias": ("attn_out", "bias", (D,), (0,), 1, None),
        "mlp_up.weight": ("mlp_up", "kernel", (D, I), (1, 0), 1, None),
        "mlp_up.bias": ("mlp_up", "bias", (I,), (0,), 1, None),
        "mlp_down.weight": ("mlp_down", "kernel", (I, D), (1, 0), 1, None),
        "mlp_down.bias": ("mlp_down", "bias", (D,), (0,), 1, None),
    }
    if cfg.moe_experts > 0:   # every block's FFN a mixture of experts
        for name in ("mlp_up", "mlp_down"):
            del per_layer[f"{name}.weight"], per_layer[f"{name}.bias"]
        per_layer.update({k: v + (None,) for k, v in _moe_per_layer(
            D, cfg.moe_experts, I, swiglu=False).items()})
    start, stop = layers or (0, L)
    for i in range(start, stop):
        for sub, (mod, leaf, js, perm, rows, whole) in per_layer.items():
            slots[f"blocks.{i - start}.{sub}"] = _permuted(
                "params", ("blocks", "block", mod, *leaf.split("/")), i, L,
                js, perm, rows, whole)
    return slots


def llama_slots(cfg) -> Dict[str, Slot]:
    """``{port name: Slot}`` for ``LlamaForCausalLM``: the scan-stacked
    JAX layout (``layers/block/...`` with a leading ``[L]``), the one the
    JAX recipe trains. q/k/v ``[H * hd, D]`` are ``[D, H, hd]`` kernels
    (their biases ``[H * hd]`` ``[H, hd]`` leaves), o ``[D, H * hd]`` an
    ``[H, hd, D]`` one, gate/up/down and the head ``[out, in]``
    ``[in, out]`` kernels, the embedding and the norms' scales
    (``q_norm``/``k_norm`` too) as they are. A tied config has no head
    slot: its head is ``embed.weight``, the JAX ``embed/embedding``."""
    D, V, I = cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size
    H, Hkv, hd, L = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        cfg.num_layers
    slots = {
        "embed.weight": _permuted("params", ("embed", "embedding"), None, 0,
                                  (V, D), (0, 1)),
        "final_norm.weight": _permuted("params", ("final_norm", "scale"),
                                       None, 0, (D,), (0,)),
    }
    if not cfg.tie_word_embeddings:
        slots["lm_head.weight"] = _permuted(
            "params", ("lm_head", "kernel"), None, 0, (D, V), (1, 0))
    per_layer = {
        "attn_norm.weight": ("attn_norm", "scale", (D,), (0,), 1),
        "mlp_norm.weight": ("mlp_norm", "scale", (D,), (0,), 1),
        "q.weight": ("q", "kernel", (D, H, hd), (1, 2, 0), 2),
        "k.weight": ("k", "kernel", (D, Hkv, hd), (1, 2, 0), 2),
        "v.weight": ("v", "kernel", (D, Hkv, hd), (1, 2, 0), 2),
        "o.weight": ("o", "kernel", (H, hd, D), (2, 0, 1), 1),
        "gate.weight": ("gate", "kernel", (D, I), (1, 0), 1),
        "up.weight": ("up", "kernel", (D, I), (1, 0), 1),
        "down.weight": ("down", "kernel", (I, D), (1, 0), 1),
    }
    if getattr(cfg, "num_experts", 0):   # Mixtral: the MoE FFN
        E = cfg.num_experts
        for name in ("gate.weight", "up.weight", "down.weight"):
            del per_layer[name]
        per_layer.update(_moe_per_layer(D, E, I, swiglu=True))
    if cfg.attention_bias:
        for name, heads in (("q", H), ("k", Hkv), ("v", Hkv)):
            per_layer[f"{name}.bias"] = (name, "bias", (heads, hd), (0, 1),
                                         2)
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            per_layer[f"{name}.weight"] = (name, "scale", (hd,), (0,), 1)
    for i in range(L):
        for sub, (mod, leaf, js, perm, rows) in per_layer.items():
            slots[f"layers.{i}.{sub}"] = _permuted(
                "params", ("layers", "block", mod, *leaf.split("/")), i, L,
                js, perm, rows)
    return slots


def _moe_per_layer(D: int, E: int, F: int, *, swiglu: bool):
    """The per-layer MoE entries of a slot table (``llama_slots``'s
    ``(module, leaf, jshape, perm, rows)`` form): the router ``[E, D]``
    is the ``[D, E]`` kernel, the stacked experts ``[E, D, F]`` /
    ``[E, F, D]`` are the JAX leaves as they are, one port dim per JAX
    axis (so an ``ep`` or ``tp`` shard is a box of the leaf)."""
    out = {
        "moe.router.weight": ("moe", "router/kernel", (D, E), (1, 0), 1),
        "moe.w_in": ("moe", "w_in", (E, D, F), (0, 1, 2), (1, 1, 1)),
        "moe.w_out": ("moe", "w_out", (E, F, D), (0, 1, 2), (1, 1, 1)),
    }
    if swiglu:
        out["moe.w_gate"] = ("moe", "w_gate", (E, D, F), (0, 1, 2),
                             (1, 1, 1))
    return out


def mixtral_slots(cfg) -> Dict[str, Slot]:
    """``{port name: Slot}`` for ``MixtralForCausalLM``: Llama's, with the
    MoE FFN's router and stacked experts in place of gate/up/down
    (``layers/block/moe/{router/kernel, w_in, w_gate, w_out}``, a leading
    ``[L]``)."""
    return llama_slots(cfg)


def mixtral_params_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``MixtralForCausalLM`` params -> the port's state_dict: the
    Llama body's leaves (:func:`llama_params_from_jax`) and each layer's
    ``moe/router/kernel [D, E]`` (the port's ``[E, D]``) and
    ``moe/w_in``, ``moe/w_gate`` ``[E, D, F]`` and ``moe/w_out``
    ``[E, F, D]`` (as they are)."""
    return _params_from_slots(params, mixtral_slots(cfg),
                              "mixtral_params_from_jax", "layers", "layer")


def mixtral_params_to_jax(state_dict, cfg) -> dict:
    """The inverse of :func:`mixtral_params_from_jax` (f32 numpy, the
    scan-stacked layout)."""
    return _params_to_jax(state_dict, mixtral_slots(cfg),
                          "mixtral_params_to_jax")


def neox_slots(cfg) -> Dict[str, Slot]:
    """``{port name: Slot}`` for ``NeoXForCausalLM``: the scan-stacked
    JAX layout (``layers/block/...``). ``qkv.weight`` ``[H * 3 * hd, D]``
    is the ``[D, H, 3, hd]`` kernel (HF's per-head q, k, v order) and its
    bias the ``[H, 3, hd]`` leaf, ``attn_out.weight`` ``[D, H * hd]`` an
    ``[H, hd, D]`` kernel, the MLP and ``embed_out`` ``[out, in]``
    ``[in, out]`` kernels, LayerNorm weights ``scale`` leaves."""
    D, H, hd, L = (cfg.hidden_size, cfg.num_heads, cfg.head_dim,
                   cfg.num_layers)
    T = (lambda a: a.T, lambda a: a.T)  # [out, in] <-> [in, out]
    same = (_same, _same)
    top = {
        "embed.weight": (("embed", "embedding"), same),
        "final_norm.weight": (("final_norm", "scale"), same),
        "final_norm.bias": (("final_norm", "bias"), same),
        "embed_out.weight": (("embed_out", "kernel"), T),
    }
    slots = {k: Slot("params", path, None, 0, *maps)
             for k, (path, maps) in top.items()}
    per_layer = {
        "ln1.weight": ("ln1", "scale", same),
        "ln1.bias": ("ln1", "bias", same),
        "ln2.weight": ("ln2", "scale", same),
        "ln2.bias": ("ln2", "bias", same),
        "qkv.weight": ("qkv", "kernel", (lambda w: w.T.reshape(D, H, 3, hd),
                                         lambda k: k.reshape(D, -1).T)),
        "qkv.bias": ("qkv", "bias", (lambda b: b.reshape(H, 3, hd),
                                     lambda b: b.reshape(-1))),
        "attn_out.weight": ("attn_out", "kernel",
                            (lambda w: w.T.reshape(H, hd, D),
                             lambda k: k.reshape(-1, D).T)),
        "attn_out.bias": ("attn_out", "bias", same),
        "mlp_up.weight": ("mlp_up", "kernel", T),
        "mlp_up.bias": ("mlp_up", "bias", same),
        "mlp_down.weight": ("mlp_down", "kernel", T),
        "mlp_down.bias": ("mlp_down", "bias", same),
    }
    for i in range(L):
        for sub, (mod, leaf, maps) in per_layer.items():
            slots[f"layers.{i}.{sub}"] = Slot(
                "params", ("layers", "block", mod, leaf), i, L, *maps)
    return slots


def bert_slots(cfg, head: str = "classifier") -> Dict[str, Slot]:
    """``{port name: Slot}`` for ``BertForSequenceClassification``
    (``head="classifier"``) or ``BertForMaskedLM`` (``head="mlm"``):
    the JAX tree's unscanned layout (``bert/layer{i}/...``). q/k/v
    ``[H, H]`` weights are ``[H, heads, hd]`` DenseGeneral kernels and
    their biases ``[heads, hd]``, the attention output ``[H, H]`` an
    ``[heads, hd, H]`` kernel, the other Dense weights ``[out, in]``
    ``[in, out]`` kernels, LayerNorm weights ``scale`` leaves; the
    embeddings and ``mlm_bias`` are as they are. The MLM decoder is the
    word-embedding table itself, no tensor of its own."""
    if head not in ("classifier", "mlm"):
        raise ValueError(f"head must be 'classifier' or 'mlm', got {head!r}")
    H, heads, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    T = (lambda a: a.T, lambda a: a.T)  # [out, in] <-> [in, out]
    same = (_same, _same)
    qkv = (lambda w: w.T.reshape(H, heads, hd), lambda k: k.reshape(H, -1).T)
    qkv_bias = (lambda b: b.reshape(heads, hd), lambda b: b.reshape(-1))
    out = (lambda w: w.T.reshape(heads, hd, H), lambda k: k.reshape(-1, H).T)

    def dense(port, path, kernel=T, bias=same):
        return {f"{port}.weight": (path + ("kernel",), kernel),
                f"{port}.bias": (path + ("bias",), bias)}

    def norm(port, path):
        return {f"{port}.weight": (path + ("scale",), same),
                f"{port}.bias": (path + ("bias",), same)}

    table = {f"bert.{e}.weight": (("bert", e, "embedding"), same)
             for e in ("word_embeddings", "position_embeddings",
                       "token_type_embeddings")}
    table.update(norm("bert.embed_ln", ("bert", "embed_ln")))
    for i in range(cfg.num_layers):
        p, jp = f"bert.layers.{i}.", ("bert", f"layer{i}")
        for name in ("query", "key", "value"):
            table.update(dense(p + f"attn.{name}", jp + ("attn", name),
                               qkv, qkv_bias))
        table.update(dense(p + "attn.out", jp + ("attn", "out"), out))
        table.update(norm(p + "attn_ln", jp + ("attn_ln",)))
        table.update(dense(p + "mlp_up", jp + ("mlp_up",)))
        table.update(dense(p + "mlp_down", jp + ("mlp_down",)))
        table.update(norm(p + "mlp_ln", jp + ("mlp_ln",)))
    table.update(dense("bert.pooler", ("bert", "pooler")))
    if head == "classifier":
        table.update(dense("classifier", ("classifier",)))
    else:
        table.update(dense("mlm_dense", ("mlm_dense",)))
        table.update(norm("mlm_ln", ("mlm_ln",)))
        table["mlm_bias"] = (("mlm_bias",), same)
    return {name: Slot("params", path, None, 0, *maps)
            for name, (path, maps) in table.items()}


def vit_slots(cfg) -> Dict[str, Slot]:
    """``{port name: Slot}`` for ``ViT``: the JAX tree's unscanned layout
    (``block_{i}/...``). The patch conv ``[D, 3, ps, ps]`` is flax's
    ``[ps, ps, 3, D]`` kernel; q/k/v ``[D, D]`` are ``[D, heads, hd]``
    DenseGeneral kernels (biases ``[heads, hd]``), the attention output
    ``[D, D]`` an ``[heads, hd, D]`` kernel, the other Dense weights
    ``[out, in]`` ``[in, out]`` kernels, LayerNorm weights ``scale``
    leaves; the cls token and the positions as they are."""
    D, H, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    T = (lambda a: a.T, lambda a: a.T)  # [out, in] <-> [in, out]
    same = (_same, _same)
    qkv = (lambda w: w.T.reshape(D, H, hd), lambda k: k.reshape(D, -1).T)
    qkv_bias = (lambda b: b.reshape(H, hd), lambda b: b.reshape(-1))
    out = (lambda w: w.T.reshape(H, hd, D), lambda k: k.reshape(-1, D).T)
    conv = (lambda w: w.transpose(2, 3, 1, 0),
            lambda k: k.transpose(3, 2, 0, 1))

    def dense(port, path, kernel=T, bias=same):
        return {f"{port}.weight": (path + ("kernel",), kernel),
                f"{port}.bias": (path + ("bias",), bias)}

    def norm(port, path):
        return {f"{port}.weight": (path + ("scale",), same),
                f"{port}.bias": (path + ("bias",), same)}

    table = dense("patch_embed", ("patch_embed",), conv)
    if cfg.pooling == "cls":
        table["cls_token"] = (("cls_token",), same)
    table["pos_embedding"] = (("pos_embedding",), same)
    for i in range(cfg.num_layers):
        p, jp = f"blocks.{i}.", (f"block_{i}",)
        table.update(norm(p + "attn_ln", jp + ("attn_ln",)))
        for name in ("query", "key", "value"):
            table.update(dense(p + name, jp + (name,), qkv, qkv_bias))
        table.update(dense(p + "out", jp + ("out",), out))
        table.update(norm(p + "mlp_ln", jp + ("mlp_ln",)))
        table.update(dense(p + "mlp_up", jp + ("mlp_up",)))
        table.update(dense(p + "mlp_down", jp + ("mlp_down",)))
    table.update(norm("final_ln", ("final_ln",)))
    table.update(dense("head", ("head",)))
    return {name: Slot("params", path, None, 0, *maps)
            for name, (path, maps) in table.items()}


def vit_params_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``ViT`` params -> the port's ``ViT`` state_dict (f32 CPU
    tensors), every leaf accounted for."""
    leaves = _Leaves(params, "vit_params_from_jax", "A10.5")
    sd = {name: _t(slot.from_jax(leaves.take("/".join(slot.path))))
          for name, slot in vit_slots(cfg).items()}
    leaves.finish()
    return sd


def vit_params_to_jax(state_dict, cfg) -> dict:
    """The inverse of :func:`vit_params_from_jax` (f32 numpy)."""
    return _params_to_jax(state_dict, vit_slots(cfg), "vit_params_to_jax")


def _t5_per_layer(cfg, cross: bool):
    """A T5 block's ``{port sub-name: (JAX module path, leaf, jshape, perm,
    rows)}``: q/k/v ``[H * d_kv, D]`` are ``[D, H, d_kv]`` kernels, o
    ``[D, H * d_kv]`` an ``[H, d_kv, D]`` one, the FFN's ``[out, in]``
    weights ``[in, out]`` kernels, the norms' weights ``scale`` leaves."""
    D, H, dkv, F = cfg.d_model, cfg.num_heads, cfg.d_kv, cfg.d_ff
    out = {}
    norms = ("attn_norm", "cross_norm", "ffn_norm") if cross else (
        "attn_norm", "ffn_norm")
    for norm in norms:
        out[f"{norm}.weight"] = (norm, "scale", (D,), (0,), 1)
    for attn in ("attn", "cross_attn") if cross else ("attn",):
        for n in ("q", "k", "v"):
            out[f"{attn}.{n}.weight"] = (f"{attn}/{n}", "kernel",
                                         (D, H, dkv), (1, 2, 0), 2)
        out[f"{attn}.o.weight"] = (f"{attn}/o", "kernel", (H, dkv, D),
                                   (2, 0, 1), 1)
    wi = ("wi_0", "wi_1") if cfg.feed_forward_proj == "gated-gelu" else (
        "wi",)
    for n in wi:
        out[f"ffn.{n}.weight"] = (f"ffn/{n}", "kernel", (D, F), (1, 0), 1)
    out["ffn.wo.weight"] = ("ffn/wo", "kernel", (F, D), (1, 0), 1)
    return out


def t5_slots(cfg, scan_layers: Optional[bool] = None) -> Dict[str, Slot]:
    """``{port name: Slot}`` for ``T5ForConditionalGeneration``: the JAX
    tree's layout, scan-stacked (``{encoder,decoder}/layers/block/...``
    with a leading ``[L]``) when ``scan_layers`` (the config's unless
    given), else unrolled (``{stack}/layers_{i}/...``). ``shared``
    ``[V, D]`` and each stack's ``rel_bias`` ``[num_buckets, H]`` are
    the ``embedding`` leaves as they are (HF hangs the tables on block 0;
    the port and the JAX model hold one a stack); an untied head
    ``[V, D]`` is the ``[D, V]`` kernel; the blocks as
    :func:`_t5_per_layer`."""
    scan = cfg.scan_layers if scan_layers is None else scan_layers
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    nb, H = cfg.relative_attention_num_buckets, cfg.num_heads
    slots = {"shared.weight": _permuted("params", ("shared", "embedding"),
                                        None, 0, (V, D), (0, 1))}
    if not cfg.tie_word_embeddings:
        slots["lm_head.weight"] = _permuted(
            "params", ("lm_head", "kernel"), None, 0, (D, V), (1, 0))
    for stack in ("encoder", "decoder"):
        slots[f"{stack}.rel_bias.weight"] = _permuted(
            "params", (stack, "rel_bias", "embedding"), None, 0, (nb, H),
            (0, 1))
        slots[f"{stack}.final_norm.weight"] = _permuted(
            "params", (stack, "final_norm", "scale"), None, 0, (D,), (0,))
        per_layer = _t5_per_layer(cfg, cross=stack == "decoder")
        for i in range(L):
            for sub, (mod, leaf, js, perm, rows) in per_layer.items():
                where = (("layers", "block"), i, L) if scan else (
                    (f"layers_{i}",), None, 0)
                slots[f"{stack}.layers.{i}.{sub}"] = _permuted(
                    "params", (stack, *where[0], *mod.split("/"), leaf),
                    where[1], where[2], js, perm, rows)
    return slots


def t5_params_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``T5ForConditionalGeneration`` params, either layout of the
    layers (read off the tree) -> the port's state_dict (f32 CPU
    tensors), every leaf accounted for."""
    leaves = _Leaves(params, "t5_params_from_jax", "A10.5")
    slots = t5_slots(cfg, scan_layers=leaves.has("encoder/layers/block"))
    sd = {}
    for name, slot in slots.items():
        arr = leaves.take("/".join(slot.path))
        sd[name] = _t(slot.from_jax(arr if slot.layer is None
                                    else arr[slot.layer]))
    leaves.finish()
    return sd


def t5_params_to_jax(state_dict, cfg) -> dict:
    """The inverse of :func:`t5_params_from_jax`: the port's T5
    state_dict as JAX params (f32 numpy) in the config's layout
    (``scan_layers``)."""
    return _params_to_jax(state_dict, t5_slots(cfg), "t5_params_to_jax")


def _bert_head(names) -> str:
    """The head whose tensors (or JAX leaves) ``names`` holds."""
    return "mlm" if any(n.startswith("mlm_") for n in names) else "classifier"


def bert_params_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``BertForSequenceClassification`` or ``BertForMaskedLM``
    params (the unscanned ``bert/layer{i}`` tree) -> the port model's
    state_dict (f32 CPU tensors), every leaf accounted for: one the port
    has no place for raises ``NotImplementedError`` naming A7."""
    leaves = _Leaves(params, "bert_params_from_jax", "A7")
    sd = {name: _t(slot.from_jax(leaves.take("/".join(slot.path))))
          for name, slot in bert_slots(cfg, _bert_head(leaves.arrays)).items()}
    leaves.finish()
    return sd


def bert_params_to_jax(state_dict, cfg) -> dict:
    """The inverse of :func:`bert_params_from_jax`: the port's BERT
    state_dict as JAX params (f32 numpy, ``bert/layer{i}``)."""
    return _params_to_jax(state_dict, bert_slots(cfg, _bert_head(state_dict)),
                          "bert_params_to_jax")


_RESNET_JAX_NAMES = {short: jax for jax, short in _RESNET_NAMES.items()}


def resnet_slots(names) -> Dict[str, Slot]:
    """``{port name: Slot}`` for a ``ResNet``'s parameters and running
    statistics, given its ``state_dict`` names: conv weights
    ``[O, I, kh, kw]`` are JAX ``[kh, kw, I, O]`` kernels, the head's
    ``[out, in]`` an ``[in, out]`` kernel, a norm's weight/bias its
    ``scale``/``bias`` and its running mean/var the ``batch_stats``
    ``mean``/``var``."""
    conv = (lambda w: w.transpose(2, 3, 1, 0),
            lambda k: k.transpose(3, 2, 0, 1))
    T = (lambda a: a.T, lambda a: a.T)
    leaf_of = {"running_mean": ("batch_stats", "mean"),
               "running_var": ("batch_stats", "var"),
               "bias": ("params", "bias")}
    slots = {}
    for name in names:
        *mods, leaf = name.split(".")
        jmods = tuple(_RESNET_JAX_NAMES.get(m, m) for m in mods)
        kind = _resnet_kind(jmods[-1])
        if kind == "bn":
            tree, jleaf = leaf_of.get(leaf, ("params", "scale"))
            maps = (_same, _same)
        elif kind == "head":
            tree, jleaf = "params", "kernel" if leaf == "weight" else "bias"
            maps = T if leaf == "weight" else (_same, _same)
        elif kind == "conv" and leaf == "weight":
            tree, jleaf, maps = "params", "kernel", conv
        else:
            raise NotImplementedError(
                f"resnet_slots: no JAX leaf for {name!r} (ROADMAP A3)")
        slots[name] = Slot(tree, jmods + (jleaf,), None, 0, *maps)
    return slots


def model_slots(model) -> Dict[str, Slot]:
    """The slots of a ``GPT2LMHead``, a ``LlamaForCausalLM`` (any
    Llama-body family, Mixtral's experts too), a ``NeoXForCausalLM``, a
    BERT (``BertForSequenceClassification``, ``BertForMaskedLM``), a
    ``ViT``, a ``T5ForConditionalGeneration`` or a ``ResNet`` (or one
    inside ``DistributedDataParallel``): every entry of its
    ``state_dict``."""
    from pytorch_distributed_tpu_torch.models.bert import (
        BertForMaskedLM,
        BertForSequenceClassification,
    )
    from pytorch_distributed_tpu_torch.models.gpt2 import GPT2LMHead
    from pytorch_distributed_tpu_torch.models.llama import LlamaForCausalLM
    from pytorch_distributed_tpu_torch.models.neox import NeoXForCausalLM
    from pytorch_distributed_tpu_torch.models.resnet import ResNet
    from pytorch_distributed_tpu_torch.models.t5 import (
        T5ForConditionalGeneration,
    )
    from pytorch_distributed_tpu_torch.models.vit import ViT

    model = getattr(model, "module", model)
    if hasattr(model, "adapter_slots"):   # a lora.LoRAModel
        return model.adapter_slots()
    model = getattr(model, "wrapped_model", model)
    if isinstance(model, GPT2LMHead):
        stage = getattr(model, "pipeline_stage", None)
        slots = gpt2_slots(model.config,
                           None if stage is None else stage.layers,
                           model.qkv_ways)
    elif isinstance(model, LlamaForCausalLM):
        slots = llama_slots(model.config)
    elif isinstance(model, NeoXForCausalLM):
        slots = neox_slots(model.config)
    elif isinstance(model, BertForSequenceClassification):
        slots = bert_slots(model.config, "classifier")
    elif isinstance(model, BertForMaskedLM):
        slots = bert_slots(model.config, "mlm")
    elif isinstance(model, ResNet):
        slots = resnet_slots(logical_shapes(model).keys())
    elif isinstance(model, ViT):
        slots = vit_slots(model.config)
    elif isinstance(model, T5ForConditionalGeneration):
        slots = t5_slots(model.config)
    else:
        raise NotImplementedError(
            f"no JAX leaf layout for {type(model).__name__}: checkpoints of "
            "the port cover GPT-2, the Llama families, NeoX, BERT, ViT, T5 "
            "and ResNet (ROADMAP A5)")
    missing = set(logical_shapes(model)) - set(slots)
    if missing:
        raise NotImplementedError(
            f"model_slots: port tensors without a JAX leaf: {sorted(missing)}"
            " (ROADMAP A5)")
    return slots


def logical_shapes(model) -> Dict[str, Tuple[int, ...]]:
    """``{state_dict name: shape}`` of a model as it was built: a tensor
    that ``torch.nn.utils.parametrize`` replaced (a quantized weight, a
    weight with LoRA adapters) keeps its own name and shape, and the
    tensors the parametrizations hold are left out."""
    from torch.nn.utils import parametrize

    out = {}
    for mod_name, mod in model.named_modules():
        if ".parametrizations." in f".{mod_name}.":
            continue
        prefix = f"{mod_name}." if mod_name else ""
        for kind in (mod._parameters, mod._buffers):
            for name, t in kind.items():
                if t is not None:
                    out[prefix + name] = tuple(t.shape)
        if parametrize.is_parametrized(mod):
            for name, plist in mod.parametrizations.items():
                first = plist[0]
                out[prefix + name] = tuple(
                    first.pshape if hasattr(first, "pshape")
                    else plist.original.shape)
    return out


def _stacked(sd, slots, tree: str) -> dict:
    """The nested JAX tree ``tree`` from a port state_dict."""
    out: dict = {}
    stacks: Dict[Tuple[str, ...], list] = {}
    for name, slot in slots.items():
        if slot.tree != tree:
            continue
        # a copy: on the CPU an f32 tensor's numpy view shares its storage
        arr = np.array(slot.to_jax(
            sd[name].detach().cpu().float().numpy()), order="C", copy=True)
        if slot.layer is None:
            node = out
            for k in slot.path[:-1]:
                node = node.setdefault(k, {})
            node[slot.path[-1]] = arr
        else:
            stacks.setdefault(slot.path, [None] * slot.depth)[slot.layer] = arr
    for path, layers in stacks.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.stack(layers)
    return out


def _params_to_jax(state_dict, slots, what: str) -> dict:
    left, missing = set(state_dict) - set(slots), set(slots) - set(state_dict)
    if left or missing:
        raise NotImplementedError(
            f"{what}: tensors the JAX model has no leaf for: "
            f"{sorted(left)}; JAX leaves without a tensor: {sorted(missing)} "
            "(ROADMAP A7)")
    return _stacked(state_dict, slots, "params")


def gpt2_params_to_jax(state_dict, cfg) -> dict:
    """The inverse of :func:`gpt2_params_from_jax`: the port's
    ``GPT2LMHead`` state_dict as JAX ``GPT2LMHead`` params (f32 numpy,
    the scan-stacked layout)."""
    return _params_to_jax(state_dict, gpt2_slots(cfg), "gpt2_params_to_jax")


def llama_params_to_jax(state_dict, cfg) -> dict:
    """The inverse of :func:`llama_params_from_jax`: the port's
    ``LlamaForCausalLM`` state_dict as JAX ``LlamaForCausalLM`` params
    (f32 numpy, the scan-stacked layout, ``scan_layers=True``; a tied
    config's tree has no ``lm_head``)."""
    return _params_to_jax(state_dict, llama_slots(cfg),
                          "llama_params_to_jax")


def neox_params_to_jax(state_dict, cfg) -> dict:
    """The inverse of :func:`neox_params_from_jax`: the port's
    ``NeoXForCausalLM`` state_dict as JAX params (f32 numpy, the
    scan-stacked layout)."""
    return _params_to_jax(state_dict, neox_slots(cfg), "neox_params_to_jax")


def resnet_params_to_jax(state_dict) -> Tuple[dict, dict]:
    """The inverse of :func:`resnet_params_from_jax`: the port's ResNet
    state_dict as JAX ``(params, batch_stats)``."""
    slots = resnet_slots(state_dict.keys())
    return (_stacked(state_dict, slots, "params"),
            _stacked(state_dict, slots, "batch_stats"))


# --------------------------------------------------------------------------
# Optimizer state and step under optax's names.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OptimizerLayout:
    """Where a port optimizer's state lives in the JAX ``opt_state``.

    ``moments`` maps the torch per-parameter state key to the JAX path
    prefix its per-parameter tree hangs under (``exp_avg`` ->
    ``opt_state/1/0/mu`` for ``chain(clip_by_global_norm, adamw)``);
    ``per_leaf`` does the same for state an optimizer keeps once per JAX
    leaf, whole, in the leaf's own layout (Adafactor's factored
    ``v_row``/``v_col``); ``count`` is the path of the optax update count
    (one scalar, where torch keeps a ``step`` per parameter),
    ``schedule_count`` that of a learning-rate schedule's own count,
    when there is one."""

    moments: Dict[str, Tuple[str, ...]]
    count: Optional[Tuple[str, ...]]
    schedule_count: Optional[Tuple[str, ...]]
    per_leaf: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=dict)


def unwrap_optimizer(optimizer):
    """(clipped?, the optimizer that holds this rank's state, the
    ``ZeroRedundancyOptimizer`` or ``parallel.ZeroShards`` around it or
    None)."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    from pytorch_distributed_tpu_torch.optim import _ClippedOptimizer
    from pytorch_distributed_tpu_torch.parallel.strategies import ZeroShards

    clipped = isinstance(optimizer, _ClippedOptimizer)
    inner = optimizer.optimizer if clipped else optimizer
    zero = inner if isinstance(inner, (ZeroRedundancyOptimizer,
                                       ZeroShards)) else None
    return clipped, (zero.optim if zero is not None else inner), zero


def optimizer_layout(optimizer) -> OptimizerLayout:
    """The optax state a port optimizer stands for (the JAX package's
    ``optim`` constructor of the same name), with ``clip_grad_norm`` or
    ``clip_grad_value`` putting it second in ``chain(clip, ...)``:

    * ``AdamW``: ``optax.adamw`` = ``chain(scale_by_adam,
      add_decayed_weights, scale_by_learning_rate)``;
    * ``Adam``: ``chain([add_decayed_weights,] optax.adam)``, the adam
      itself ``chain(scale_by_adam, scale_by_learning_rate)``;
    * ``SGD``: ``optax.sgd`` = ``chain(trace, scale_by_learning_rate)``;
    * ``Adafactor``: ``optax.adafactor`` = ``chain(scale_by_factored_rms,
      clip_by_block_rms, scale_by_learning_rate, ...)``, its
      ``FactoredState`` (``count``, ``v_row``, ``v_col``, ``v``) first;
    * ``LARS``: the JAX package's own ``{"v", "count"}`` state;
    * ``LAMB``: ``optax.lamb`` = ``chain(scale_by_adam,
      add_decayed_weights, scale_by_trust_ratio,
      scale_by_learning_rate)``.

    Any other optimizer raises, naming its class."""
    from pytorch_distributed_tpu_torch import optim

    clipped, local, _ = unwrap_optimizer(optimizer)
    base = ("opt_state", "1") if clipped else ("opt_state",)
    sched = getattr(local, "schedule", None) is not None
    if isinstance(local, torch.optim.AdamW):
        adam = base + ("0",)
        return OptimizerLayout(
            {"exp_avg": adam + ("mu",), "exp_avg_sq": adam + ("nu",)},
            adam + ("count",), base + ("2", "count") if sched else None)
    if isinstance(local, optim.Adam):
        inner = base + (("1",) if local.defaults["weight_decay"] else ("0",))
        adam = inner + ("0",)
        return OptimizerLayout(
            {"exp_avg": adam + ("mu",), "exp_avg_sq": adam + ("nu",)},
            adam + ("count",), inner + ("1", "count") if sched else None)
    if isinstance(local, torch.optim.SGD):
        momentum = local.param_groups[0]["momentum"]
        return OptimizerLayout(
            {"momentum_buffer": base + ("0", "trace")} if momentum else {},
            None, base + ("1", "count") if sched else None)
    if isinstance(local, optim.Adafactor):
        rms = base + ("0",)
        return OptimizerLayout(
            {"v": rms + ("v",)}, rms + ("count",),
            base + ("2", "count") if sched else None,
            per_leaf={"v_row": rms + ("v_row",), "v_col": rms + ("v_col",),
                      "v_leaf": rms + ("v",)})
    if isinstance(local, optim.LARS):
        return OptimizerLayout({"v": base + ("v",)}, base + ("count",), None)
    if isinstance(local, optim.LAMB):
        adam = base + ("0",)
        return OptimizerLayout(
            {"exp_avg": adam + ("mu",), "exp_avg_sq": adam + ("nu",)},
            adam + ("count",), base + ("3", "count") if sched else None)
    raise NotImplementedError(
        f"no optax layout for {type(local).__name__}: checkpoints cover "
        "AdamW, Adam, SGD, Adafactor, LARS and LAMB (ROADMAP A4)")


def leaf_name(*path: str) -> str:
    """The JAX checkpoint's leaf name for a TrainState path: its parts
    joined by ``_`` (``train/checkpoint.py``'s ``_leaf_files``)."""
    return "_".join(path)


# --------------------------------------------------------------------------
# One layer of a JAX leaf, on the device: the geometry that the weight
# quantizers (ops/quant.py) and the LoRA adapters (lora.py) work in.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Geometry:
    """A port tensor as one layer of its JAX leaf, for torch tensors on
    any device. A Dense kernel's port weight is ``[prod(out), prod(in)]``
    and the JAX kernel ``W.T`` reshaped to ``jshape`` (``transposed``);
    every other leaf (embeddings, norms, biases) is the port tensor
    reshaped. ``path`` is the JAX leaf's path, ``layer`` the layer of a
    scan-stacked leaf (None: not stacked) and ``depth`` the stack's
    depth."""

    path: Tuple[str, ...]
    layer: Optional[int]
    depth: int
    jshape: Tuple[int, ...]
    pshape: Tuple[int, ...]
    transposed: bool

    @property
    def stacked_shape(self) -> Tuple[int, ...]:
        """The whole JAX leaf's shape (the layer axis first when
        stacked)."""
        return self.jshape if self.layer is None else (
            (self.depth,) + self.jshape)

    def to_jax(self, w: torch.Tensor) -> torch.Tensor:
        return (w.t() if self.transposed else w).reshape(self.jshape)

    def from_jax(self, k: torch.Tensor) -> torch.Tensor:
        if self.transposed:
            return k.reshape(self.pshape[1], self.pshape[0]).t()
        return k.reshape(self.pshape)


def geometries(model) -> Dict[str, Geometry]:
    """``{port name: Geometry}`` for every 2-D-or-more tensor of a
    ``GPT2LMHead``, ``LlamaForCausalLM`` (any Llama-body family: the q/k/v
    biases as ``[H, hd]`` leaves, the ``q_norm``/``k_norm`` scales),
    ``NeoXForCausalLM`` or BERT that a JAX ``Dense``, ``DenseGeneral`` or
    ``Embed`` leaf holds, and for every 1-D one.
    ``Slot.to_jax`` is the same map on numpy arrays (the tests hold the
    two equal)."""
    base = getattr(model, "module", model)
    base = getattr(base, "wrapped_model", base)
    if getattr(base, "qkv_ways", 1) > 1:
        raise NotImplementedError(
            "a tensor-parallel GPT-2 (its fused qkv rows grouped by rank) "
            "is not quantized or adapted (ROADMAP A10.1)")
    slots = model_slots(base)
    shapes = logical_shapes(base)
    out = {}
    for name, slot in slots.items():
        if slot.tree != "params":
            continue
        pshape = shapes[name]
        one = slot.leaf_shape(pshape)
        jshape = one if slot.layer is None else one[1:]
        transposed = slot.path[-1] == "kernel"
        if transposed and len(pshape) != 2:
            raise NotImplementedError(
                f"{name}: a {len(pshape)}-D kernel has no Dense geometry "
                "(convolutions are not quantized or adapted; ROADMAP A8)")
        out[name] = Geometry(tuple(slot.path), slot.layer, slot.depth,
                             tuple(jshape), pshape, transposed)
    return out


def _split_layers(tree, geoms: Dict[str, Geometry], what: str, leaf_fn):
    """Port tensors (or quantized leaves) keyed by port name, from a
    nested JAX tree: ``leaf_fn(jax node, geometry)`` takes one layer.
    Every JAX leaf must be taken (``_Leaves``)."""
    leaves = _Leaves(tree, what, "A8")
    out = {}
    for name, g in geoms.items():
        prefix = "/".join(g.path)
        if not leaves.has(prefix):
            continue
        sub = {p[len(prefix) + 1:]: None for p in leaves.arrays
               if p.startswith(prefix + "/")}
        if sub:
            node = {k: leaves.take(f"{prefix}/{k}") for k in sub}
        else:
            node = leaves.take(prefix)
        out[name] = leaf_fn(node, g)
    leaves.finish()
    return out


def _stack_layers(items, geoms: Dict[str, Geometry], leaf_fn) -> dict:
    """The nested JAX tree of ``{port name: item}``, ``leaf_fn(item,
    geometry) -> {suffix path: numpy array}`` giving one layer's leaves;
    the layers of a stacked leaf are stacked on a leading axis."""
    out: dict = {}
    stacks: Dict[Tuple[str, ...], list] = {}
    for name, item in items.items():
        g = geoms[name]
        for suffix, arr in leaf_fn(item, g).items():
            path = g.path + suffix
            arr = np.array(arr, order="C", copy=True)
            if g.layer is None:
                node = out
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = arr
            else:
                stacks.setdefault(path, [None] * g.depth)[g.layer] = arr
    for path, layers in stacks.items():
        missing = [i for i, a in enumerate(layers) if a is None]
        if missing:
            raise ValueError(
                f"{'/'.join(path)}: layers {missing} have no tensor; a "
                "scan-stacked JAX leaf needs every layer")
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.stack(layers)
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def quantized_params_to_jax(qparams) -> dict:
    """A port quantized tree (``ops.quant.QuantizedTree``: ``{port name:
    tensor or {"q8"|"q4", "scale"}}`` and each entry's geometry) as the
    JAX package's quantized params tree: float leaves in their JAX
    layout, quantized leaves as they are (the port quantizes in the JAX
    geometry), scan-stacked layers stacked."""
    from pytorch_distributed_tpu_torch.ops.quant import _is_qleaf

    def leaf(item, g):
        if _is_qleaf(item):
            return {(k,): _np(v) for k, v in item.items()}
        return {(): _np(g.to_jax(item))}

    return _stack_layers(qparams, qparams.geometry, leaf)


def quantized_params_from_jax(params, model):
    """The inverse of :func:`quantized_params_to_jax`: a JAX quantized
    tree (``quantize_tree_int8``/``quantize_tree_int4``, either layout of
    its leaves) -> the port's quantized tree for ``model`` (CPU tensors;
    ``QuantizedModel`` moves them to the model's device). Every leaf is
    accounted for."""
    from pytorch_distributed_tpu_torch.ops.quant import QuantizedTree

    geoms = geometries(model)

    def leaf(node, g):
        if isinstance(node, dict):
            if set(node) not in ({"q8", "scale"}, {"q4", "scale"}):
                raise NotImplementedError(
                    f"{'/'.join(g.path)}: sub-leaves {sorted(node)} are "
                    "neither a q8 nor a q4 leaf (ROADMAP A8)")
            return {k: torch.from_numpy(np.array(
                v if g.layer is None else v[g.layer], order="C", copy=True))
                for k, v in node.items()}
        arr = node if g.layer is None else node[g.layer]
        return g.from_jax(torch.tensor(np.asarray(arr, np.float32)))

    tree = QuantizedTree(_split_layers(params, geoms,
                                       "quantized_params_from_jax", leaf))
    tree.geometry.update({k: geoms[k] for k in tree})
    return tree


def lora_params_to_jax(adapters, model) -> dict:
    """A port adapter tree (``lora``: ``{port weight name: {"a", "b"}}``)
    as the JAX package's adapter tree: each ``{"a": [in, r], "b": [r,
    out]}`` at its kernel's path, scan-stacked layers stacked to ``[L,
    in, r]`` / ``[L, r, out]``."""
    geoms = geometries(model)
    unknown = set(adapters) - set(geoms)
    if unknown:
        raise NotImplementedError(
            f"lora_params_to_jax: no JAX kernel for {sorted(unknown)} "
            "(ROADMAP A8)")
    return _stack_layers(
        adapters, geoms,
        lambda ab, g: {(k,): _np(ab[k]) for k in ("a", "b")})


def lora_params_from_jax(adapters,
                         model) -> Dict[str, Dict[str, torch.Tensor]]:
    """The inverse of :func:`lora_params_to_jax`: a JAX adapter tree ->
    ``{port weight name: {"a", "b"}}`` (f32 CPU tensors, one layer each).
    Every leaf is accounted for."""
    geoms = geometries(model)

    def leaf(node, g):
        if not isinstance(node, dict) or set(node) != {"a", "b"}:
            raise NotImplementedError(
                f"{'/'.join(g.path)}: an adapter is {{'a', 'b'}}, found "
                f"{sorted(node) if isinstance(node, dict) else 'an array'}"
                " (ROADMAP A8)")
        return {k: torch.tensor(np.asarray(
            v if g.layer is None else v[g.layer], np.float32))
            for k, v in node.items()}

    return _split_layers(adapters, geoms, "lora_params_from_jax", leaf)


# --------------------------------------------------------------------------
# Hugging Face state_dicts (the JAX package's load_*/export_*), to and
# from the port's.
# --------------------------------------------------------------------------


def _hf(sd, key: str) -> torch.Tensor:
    """``sd[key]`` as a CPU tensor of its own dtype (a copy)."""
    if key not in sd:
        raise KeyError(
            f"{key!r} missing from state_dict (have e.g. {list(sd)[:4]}...)")
    x = sd[key]
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(x, copy=True))


def load_gpt2_weights(sd, cfg) -> Dict[str, torch.Tensor]:
    """HF ``GPT2LMHeadModel`` (or bare ``GPT2Model``) state_dict -> the
    port's ``GPT2LMHead`` state_dict. HF's ``Conv1D`` weights are
    ``[in, out]``, the port's ``[out, in]``; the fused ``c_attn`` keeps
    its ``(3, H, hd)`` output order. The tied ``lm_head.weight`` and
    HF's attention-mask buffers are not read (the JAX loader's keys)."""
    pre = "transformer." if any(k.startswith("transformer.") for k in sd) \
        else ""
    out = {
        "wte.weight": _hf(sd, pre + "wte.weight"),
        "wpe.weight": _hf(sd, pre + "wpe.weight"),
        "ln_f.weight": _hf(sd, pre + "ln_f.weight"),
        "ln_f.bias": _hf(sd, pre + "ln_f.bias"),
    }
    for i in range(cfg.num_layers):
        p, q = f"{pre}h.{i}.", f"blocks.{i}."
        for hf, port in (("ln_1", "ln1"), ("ln_2", "ln2")):
            out[q + f"{port}.weight"] = _hf(sd, p + f"{hf}.weight")
            out[q + f"{port}.bias"] = _hf(sd, p + f"{hf}.bias")
        for hf, port in (("attn.c_attn", "attn_qkv"),
                         ("attn.c_proj", "attn_out"),
                         ("mlp.c_fc", "mlp_up"), ("mlp.c_proj", "mlp_down")):
            out[q + f"{port}.weight"] = _hf(sd, p + f"{hf}.weight").T \
                .contiguous()
            out[q + f"{port}.bias"] = _hf(sd, p + f"{hf}.bias")
    return out


def export_gpt2_weights(state_dict, cfg) -> Dict[str, np.ndarray]:
    """The port's ``GPT2LMHead`` state_dict -> HF ``GPT2LMHeadModel``
    state_dict arrays (numpy; the tied ``lm_head.weight`` is the token
    embedding, as HF materializes it)."""
    sd = {
        "transformer.wte.weight": _np(state_dict["wte.weight"]),
        "transformer.wpe.weight": _np(state_dict["wpe.weight"]),
        "transformer.ln_f.weight": _np(state_dict["ln_f.weight"]),
        "transformer.ln_f.bias": _np(state_dict["ln_f.bias"]),
        "lm_head.weight": _np(state_dict["wte.weight"]),
    }
    for i in range(cfg.num_layers):
        p, q = f"transformer.h.{i}.", f"blocks.{i}."
        for hf, port in (("ln_1", "ln1"), ("ln_2", "ln2")):
            sd[p + f"{hf}.weight"] = _np(state_dict[q + f"{port}.weight"])
            sd[p + f"{hf}.bias"] = _np(state_dict[q + f"{port}.bias"])
        for hf, port in (("attn.c_attn", "attn_qkv"),
                         ("attn.c_proj", "attn_out"),
                         ("mlp.c_fc", "mlp_up"), ("mlp.c_proj", "mlp_down")):
            sd[p + f"{hf}.weight"] = np.ascontiguousarray(
                _np(state_dict[q + f"{port}.weight"]).T)
            sd[p + f"{hf}.bias"] = _np(state_dict[q + f"{port}.bias"])
    return sd


# HF Llama-body names -> the port's, per layer
_LLAMA_HF = (
    ("input_layernorm.weight", "attn_norm.weight"),
    ("self_attn.q_proj.weight", "q.weight"),
    ("self_attn.k_proj.weight", "k.weight"),
    ("self_attn.v_proj.weight", "v.weight"),
    ("self_attn.o_proj.weight", "o.weight"),
    ("post_attention_layernorm.weight", "mlp_norm.weight"),
    ("mlp.gate_proj.weight", "gate.weight"),
    ("mlp.up_proj.weight", "up.weight"),
    ("mlp.down_proj.weight", "down.weight"),
)
_LLAMA_HF_BIAS = tuple((f"self_attn.{n}_proj.bias", f"{n}.bias")
                       for n in ("q", "k", "v"))
_LLAMA_HF_QK_NORM = (("self_attn.q_norm.weight", "q_norm.weight"),
                     ("self_attn.k_norm.weight", "k_norm.weight"))


def _llama_hf_names(cfg):
    names = _LLAMA_HF
    if getattr(cfg, "num_experts", 0):   # Mixtral: no dense MLP
        names = tuple(n for n in names if not n[0].startswith("mlp."))
    if cfg.attention_bias:
        names += _LLAMA_HF_BIAS
    if cfg.qk_norm:
        names += _LLAMA_HF_QK_NORM
    return names


def load_llama_weights(sd, cfg) -> Dict[str, torch.Tensor]:
    """HF ``LlamaForCausalLM`` state_dict (and Mistral's, Qwen2's,
    Qwen3's and Gemma's, which share its names) -> the port's
    ``LlamaForCausalLM`` state_dict. As the JAX loader: q/k/v biases or
    ``q_norm``/``k_norm`` weights the config does not enable raise (they
    would be dropped); a tied config refuses an ``lm_head.weight`` that
    differs from the embedding; an untied config without
    ``lm_head.weight`` takes the embedding as its head."""
    if not cfg.attention_bias:
        found = sorted(k for k in sd if re.fullmatch(
            r"model\.layers\.\d+\.self_attn\.[qkv]_proj\.bias", k))
        if found:
            raise ValueError(
                f"checkpoint has attention projection biases (e.g. "
                f"{found[0]}) but the config has attention_bias=False — a "
                "Qwen2-style checkpoint; fix the config instead of losing "
                "the biases")
    if not cfg.qk_norm:
        found = sorted(k for k in sd if re.fullmatch(
            r"model\.layers\.\d+\.self_attn\.[qk]_norm\.weight", k))
        if found:
            raise ValueError(
                f"checkpoint has q_norm/k_norm weights (e.g. {found[0]}) but "
                "the config has qk_norm=False — a Qwen3-style checkpoint; "
                "fix the config instead of losing the norms")
    emb = _hf(sd, "model.embed_tokens.weight")
    out = {"embed.weight": emb,
           "final_norm.weight": _hf(sd, "model.norm.weight")}
    if cfg.tie_word_embeddings:
        if "lm_head.weight" in sd and not torch.allclose(
                _hf(sd, "lm_head.weight").float(), emb.float()):
            raise ValueError(
                "cfg.tie_word_embeddings=True but the checkpoint's "
                "lm_head.weight differs from its embedding table — an "
                "UNTIED checkpoint; fix the config instead of losing the "
                "head weights")
    else:
        out["lm_head.weight"] = (_hf(sd, "lm_head.weight")
                                 if "lm_head.weight" in sd else emb.clone())
    names = _llama_hf_names(cfg)
    for i in range(cfg.num_layers):
        for hf, port in names:
            out[f"layers.{i}.{port}"] = _hf(sd, f"model.layers.{i}.{hf}")
    return out


def export_llama_weights(state_dict, cfg) -> Dict[str, np.ndarray]:
    """The port's ``LlamaForCausalLM`` state_dict -> HF
    ``LlamaForCausalLM`` state_dict arrays (numpy). A tied config's
    ``lm_head.weight`` is the embedding, as HF materializes the shared
    tensor under both names."""
    emb = _np(state_dict["embed.weight"])
    sd = {
        "model.embed_tokens.weight": emb,
        "model.norm.weight": _np(state_dict["final_norm.weight"]),
        "lm_head.weight": (emb if cfg.tie_word_embeddings
                           else _np(state_dict["lm_head.weight"])),
    }
    names = _llama_hf_names(cfg)
    for i in range(cfg.num_layers):
        for hf, port in names:
            sd[f"model.layers.{i}.{hf}"] = _np(
                state_dict[f"layers.{i}.{port}"])
    return sd


# HF Mixtral's per-expert Linears -> the port's stacked experts: w1 is
# the gate (w_gate), w3 the up projection (w_in), w2 the down (w_out)
_MIXTRAL_HF_EXPERTS = (("w1", "w_gate"), ("w3", "w_in"), ("w2", "w_out"))


def load_mixtral_weights(sd, cfg) -> Dict[str, torch.Tensor]:
    """HF ``MixtralForCausalLM`` state_dict -> the port's
    ``MixtralForCausalLM`` state_dict: the Llama body's names
    (:func:`load_llama_weights`) and each layer's
    ``block_sparse_moe.gate.weight`` (the router, ``[E, D]`` in both) and
    ``block_sparse_moe.experts.{e}.w1/w3/w2.weight`` (``[out, in]``)
    stacked over ``e`` and transposed into ``moe.w_gate``/``moe.w_in``
    ``[E, D, F]`` and ``moe.w_out`` ``[E, F, D]``."""
    out = load_llama_weights(sd, cfg)
    for i in range(cfg.num_layers):
        p, q = f"model.layers.{i}.block_sparse_moe.", f"layers.{i}.moe."
        out[q + "router.weight"] = _hf(sd, p + "gate.weight")
        for hf, port in _MIXTRAL_HF_EXPERTS:
            out[q + port] = torch.stack([
                _hf(sd, p + f"experts.{e}.{hf}.weight").T
                for e in range(cfg.num_experts)]).contiguous()
    return out


def export_mixtral_weights(state_dict, cfg) -> Dict[str, np.ndarray]:
    """The port's ``MixtralForCausalLM`` state_dict -> HF
    ``MixtralForCausalLM`` state_dict arrays (numpy): the inverse of
    :func:`load_mixtral_weights`."""
    sd = export_llama_weights(state_dict, cfg)
    for i in range(cfg.num_layers):
        p, q = f"model.layers.{i}.block_sparse_moe.", f"layers.{i}.moe."
        sd[p + "gate.weight"] = _np(state_dict[q + "router.weight"])
        for hf, port in _MIXTRAL_HF_EXPERTS:
            w = _np(state_dict[q + port])
            for e in range(cfg.num_experts):
                sd[p + f"experts.{e}.{hf}.weight"] = np.ascontiguousarray(
                    w[e].T)
    return sd


# HF BERT names -> the port's, per layer (Linear and LayerNorm pairs)
_BERT_HF_LAYER = (
    ("attention.self.query", "attn.query"),
    ("attention.self.key", "attn.key"),
    ("attention.self.value", "attn.value"),
    ("attention.output.dense", "attn.out"),
    ("attention.output.LayerNorm", "attn_ln"),
    ("intermediate.dense", "mlp_up"),
    ("output.dense", "mlp_down"),
    ("output.LayerNorm", "mlp_ln"),
)
_BERT_HF_TOP = (
    ("embeddings.word_embeddings", "word_embeddings", ("weight",)),
    ("embeddings.position_embeddings", "position_embeddings", ("weight",)),
    ("embeddings.token_type_embeddings", "token_type_embeddings",
     ("weight",)),
    ("embeddings.LayerNorm", "embed_ln", ("weight", "bias")),
    ("pooler.dense", "pooler", ("weight", "bias")),
)


def _bert_trunk_names(cfg):
    """``[(HF name, port name)]`` of a BERT trunk, without prefixes."""
    out = [(f"{hf}.{leaf}", f"{port}.{leaf}")
           for hf, port, leaves in _BERT_HF_TOP for leaf in leaves]
    for i in range(cfg.num_layers):
        for hf, port in _BERT_HF_LAYER:
            for leaf in ("weight", "bias"):
                out.append((f"encoder.layer.{i}.{hf}.{leaf}",
                            f"layers.{i}.{port}.{leaf}"))
    return out


def load_bert_weights(sd, cfg, *, num_labels: Optional[int] = None
                      ) -> Dict[str, torch.Tensor]:
    """HF BERT state_dict -> the port's: ``BertForSequenceClassification``'s
    with ``num_labels`` (its ``classifier.*`` read), ``BertForMaskedLM``'s
    for an HF ``BertForMaskedLM`` dict (its ``cls.predictions.transform``
    keys; the tied decoder is the word-embedding table, so only its bias
    is read, and HF's poolerless masked LM gets a zero pooler, which the
    MLM head never reads), else a bare ``BertModel``'s. The port's
    ``[out, in]`` layouts are HF's own: the map is names (the JAX
    loader's keys)."""
    pre = "bert." if any(k.startswith("bert.") for k in sd) else ""
    is_mlm = "cls.predictions.transform.dense.weight" in sd
    head = "bert." if num_labels is not None or is_mlm else ""
    H = cfg.hidden_size
    out = {}
    for hf, port in _bert_trunk_names(cfg):
        if (is_mlm and hf.startswith("pooler.")
                and pre + hf not in sd):
            out[head + port] = torch.zeros(
                (H, H) if hf.endswith("weight") else (H,))
            continue
        out[head + port] = _hf(sd, pre + hf)
    if num_labels is not None:
        out["classifier.weight"] = _hf(sd, "classifier.weight")
        out["classifier.bias"] = _hf(sd, "classifier.bias")
    elif is_mlm:
        t = "cls.predictions.transform."
        for hf, port in (("dense", "mlm_dense"), ("LayerNorm", "mlm_ln")):
            for leaf in ("weight", "bias"):
                out[f"{port}.{leaf}"] = _hf(sd, f"{t}{hf}.{leaf}")
        out["mlm_bias"] = _hf(sd, "cls.predictions.bias")
    return out


def export_bert_weights(state_dict, cfg) -> Dict[str, np.ndarray]:
    """The port's BERT state_dict -> HF state_dict arrays: the inverse of
    :func:`load_bert_weights`. A classifier or masked LM exports with
    HF's ``bert.`` prefix (the masked LM with the tied
    ``cls.predictions.decoder.weight`` and its bias alias, as HF
    materializes them, and the pooler, which HF's masked LM ignores); a
    bare ``BertModel`` without it."""
    mlm = "mlm_bias" in state_dict
    wrapped = "classifier.weight" in state_dict or mlm
    src = "bert." if wrapped else ""
    sd = {}
    for hf, port in _bert_trunk_names(cfg):
        sd[src + hf] = _np(state_dict[src + port])
    if "classifier.weight" in state_dict:
        sd["classifier.weight"] = _np(state_dict["classifier.weight"])
        sd["classifier.bias"] = _np(state_dict["classifier.bias"])
    if mlm:
        t = "cls.predictions.transform."
        for hf, port in (("dense", "mlm_dense"), ("LayerNorm", "mlm_ln")):
            for leaf in ("weight", "bias"):
                sd[f"{t}{hf}.{leaf}"] = _np(state_dict[f"{port}.{leaf}"])
        bias = _np(state_dict["mlm_bias"])
        sd["cls.predictions.bias"] = bias
        sd["cls.predictions.decoder.weight"] = _np(
            state_dict["bert.word_embeddings.weight"])
        sd["cls.predictions.decoder.bias"] = bias
    return sd


# HF ViT names -> the port's: (HF prefix, port prefix, leaves)
_VIT_HF_TOP = (
    ("vit.embeddings.patch_embeddings.projection", "patch_embed",
     ("weight", "bias")),
    ("vit.layernorm", "final_ln", ("weight", "bias")),
    ("classifier", "head", ("weight", "bias")),
)
_VIT_HF_LAYER = (
    ("layernorm_before", "attn_ln"),
    ("attention.attention.query", "query"),
    ("attention.attention.key", "key"),
    ("attention.attention.value", "value"),
    ("attention.output.dense", "out"),
    ("layernorm_after", "mlp_ln"),
    ("intermediate.dense", "mlp_up"),
    ("output.dense", "mlp_down"),
)


def _vit_names(cfg):
    if cfg.pooling != "cls":
        raise ValueError(
            "the HF ViT layout carries a cls token; convert with "
            "pooling='cls' (mean-pooling trees have no cls_token and a "
            "shorter position table)")
    out = [(f"{hf}.{leaf}", f"{port}.{leaf}")
           for hf, port, leaves in _VIT_HF_TOP for leaf in leaves]
    out += [("vit.embeddings.cls_token", "cls_token"),
            ("vit.embeddings.position_embeddings", "pos_embedding")]
    for i in range(cfg.num_layers):
        for hf, port in _VIT_HF_LAYER:
            for leaf in ("weight", "bias"):
                out.append((f"vit.encoder.layer.{i}.{hf}.{leaf}",
                            f"blocks.{i}.{port}.{leaf}"))
    return out


def load_vit_weights(sd, cfg) -> Dict[str, torch.Tensor]:
    """HF ``ViTForImageClassification`` state_dict -> the port's ``ViT``
    state_dict (cls pooling; HF ViT is pre-LN as ``ViTBlock``:
    ``layernorm_before`` is ``attn_ln``, ``layernorm_after`` ``mlp_ln``).
    The port's layouts are HF's own (the patch conv ``[D, 3, ps, ps]``,
    ``[out, in]`` Linears): the map is names."""
    return {port: _hf(sd, hf) for hf, port in _vit_names(cfg)}


def export_vit_weights(state_dict, cfg) -> Dict[str, np.ndarray]:
    """The port's ``ViT`` state_dict -> HF ``ViTForImageClassification``
    state_dict arrays: the inverse of :func:`load_vit_weights`."""
    return {hf: _np(state_dict[port]) for hf, port in _vit_names(cfg)}


def _t5_hf_names(cfg):
    """``(HF name, port name)`` of every T5 tensor but the tables, the
    embedding and the head. HF's sublayers: ``layer.0`` self-attention,
    in the decoder ``layer.1`` cross-attention (``EncDecAttention``), the
    last ``DenseReluDense``; each with its ``layer_norm``."""
    wi = ("wi_0", "wi_1") if cfg.feed_forward_proj == "gated-gelu" else (
        "wi",)
    names = [("encoder.final_layer_norm.weight", "encoder.final_norm.weight"),
             ("decoder.final_layer_norm.weight", "decoder.final_norm.weight")]
    for stack, subs in (("encoder", (("SelfAttention", "attn"),)),
                        ("decoder", (("SelfAttention", "attn"),
                                     ("EncDecAttention", "cross_attn")))):
        norms = {"attn": "attn_norm", "cross_attn": "cross_norm"}
        for i in range(cfg.num_layers):
            hp, pp = f"{stack}.block.{i}.layer.", f"{stack}.layers.{i}."
            for j, (hf_attn, attn) in enumerate(subs):
                names.append((f"{hp}{j}.layer_norm.weight",
                              f"{pp}{norms[attn]}.weight"))
                names += [(f"{hp}{j}.{hf_attn}.{n}.weight",
                           f"{pp}{attn}.{n}.weight")
                          for n in ("q", "k", "v", "o")]
            j = len(subs)
            names.append((f"{hp}{j}.layer_norm.weight",
                          f"{pp}ffn_norm.weight"))
            names += [(f"{hp}{j}.DenseReluDense.{n}.weight",
                       f"{pp}ffn.{n}.weight") for n in wi + ("wo",)]
    return names


def _t5_hf_table(stack: str) -> str:
    return (f"{stack}.block.0.layer.0.SelfAttention."
            "relative_attention_bias.weight")


def load_t5_weights(sd, cfg) -> Dict[str, torch.Tensor]:
    """HF ``T5ForConditionalGeneration`` state_dict -> the port's
    ``T5ForConditionalGeneration`` state_dict (each tensor in the dtype
    it came in). The port's layouts are HF's own ``[out, in]`` Linears;
    HF hangs each stack's relative-bias table on block 0, the port holds
    it on the stack (``{stack}.rel_bias.weight``). An untied config takes
    ``lm_head.weight``; a tied one reads the head from ``shared``."""
    out = {"shared.weight": _hf(sd, "shared.weight")}
    for stack in ("encoder", "decoder"):
        out[f"{stack}.rel_bias.weight"] = _hf(sd, _t5_hf_table(stack))
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = _hf(sd, "lm_head.weight")
    for hf, port in _t5_hf_names(cfg):
        out[port] = _hf(sd, hf)
    return out


def export_t5_weights(state_dict, cfg) -> Dict[str, np.ndarray]:
    """The port's T5 state_dict -> HF ``T5ForConditionalGeneration``
    state_dict arrays (numpy, the JAX exporter's keys): ``shared`` also
    as both stacks' ``embed_tokens`` and, tied, as ``lm_head``; the
    tables on block 0 (HF's other buffers are left out: load with
    ``strict=False``)."""
    shared = _np(state_dict["shared.weight"])
    sd = {"shared.weight": shared, "encoder.embed_tokens.weight": shared,
          "decoder.embed_tokens.weight": shared,
          "lm_head.weight": (shared if cfg.tie_word_embeddings
                             else _np(state_dict["lm_head.weight"]))}
    for stack in ("encoder", "decoder"):
        sd[_t5_hf_table(stack)] = _np(state_dict[f"{stack}.rel_bias.weight"])
    for hf, port in _t5_hf_names(cfg):
        sd[hf] = _np(state_dict[port])
    return sd


# Mistral's, Qwen2's (q/k/v biases), Qwen3's (q_norm/k_norm) and Gemma's
# (tied, the rest semantics) HF layouts are Llama's: the config says which
# leaves it carries.
load_mistral_weights = load_llama_weights
export_mistral_weights = export_llama_weights
load_qwen2_weights = load_llama_weights
export_qwen2_weights = export_llama_weights
load_qwen3_weights = load_llama_weights
export_qwen3_weights = export_llama_weights
load_gemma_weights = load_llama_weights
export_gemma_weights = export_llama_weights


def load_phi3_weights(sd, cfg) -> Dict[str, torch.Tensor]:
    """HF ``Phi3ForCausalLM`` state_dict -> the port's state_dict: the
    fused ``qkv_proj`` (``[q | k | v]`` along the out axis) and
    ``gate_up_proj`` (``[gate | up]``) split onto the Llama names."""
    qd = cfg.num_heads * cfg.head_dim
    kd = cfg.num_kv_heads * cfg.head_dim
    F = cfg.intermediate_size
    virt = dict(sd)
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        qkv = _hf(sd, p + "self_attn.qkv_proj.weight")   # [qd + 2 kd, D]
        virt[p + "self_attn.q_proj.weight"] = qkv[:qd]
        virt[p + "self_attn.k_proj.weight"] = qkv[qd:qd + kd]
        virt[p + "self_attn.v_proj.weight"] = qkv[qd + kd:]
        gu = _hf(sd, p + "mlp.gate_up_proj.weight")     # [2F, D]
        virt[p + "mlp.gate_proj.weight"] = gu[:F]
        virt[p + "mlp.up_proj.weight"] = gu[F:]
    return load_llama_weights(virt, cfg)


def export_phi3_weights(state_dict, cfg) -> Dict[str, np.ndarray]:
    """The port's state_dict -> HF ``Phi3ForCausalLM`` state_dict
    (re-fuses what :func:`load_phi3_weights` split)."""
    sd = export_llama_weights(state_dict, cfg)
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        sd[p + "self_attn.qkv_proj.weight"] = np.concatenate([
            sd.pop(p + f"self_attn.{n}_proj.weight") for n in "qkv"])
        sd[p + "mlp.gate_up_proj.weight"] = np.concatenate([
            sd.pop(p + "mlp.gate_proj.weight"),
            sd.pop(p + "mlp.up_proj.weight")])
    return sd


# HF GPT-NeoX names -> the port's, per layer (the fused query_key_value
# keeps HF's per-head (q, k, v) order in both)
_NEOX_HF = (
    ("input_layernorm", "ln1"), ("post_attention_layernorm", "ln2"),
    ("attention.query_key_value", "qkv"), ("attention.dense", "attn_out"),
    ("mlp.dense_h_to_4h", "mlp_up"), ("mlp.dense_4h_to_h", "mlp_down"),
)


def load_neox_weights(sd, cfg) -> Dict[str, torch.Tensor]:
    """HF ``GPTNeoXForCausalLM`` state_dict -> the port's
    ``NeoXForCausalLM`` state_dict (renames: the layouts agree)."""
    out = {
        "embed.weight": _hf(sd, "gpt_neox.embed_in.weight"),
        "final_norm.weight": _hf(sd, "gpt_neox.final_layer_norm.weight"),
        "final_norm.bias": _hf(sd, "gpt_neox.final_layer_norm.bias"),
        "embed_out.weight": _hf(sd, "embed_out.weight"),
    }
    for i in range(cfg.num_layers):
        for hf, port in _NEOX_HF:
            for leaf in ("weight", "bias"):
                out[f"layers.{i}.{port}.{leaf}"] = _hf(
                    sd, f"gpt_neox.layers.{i}.{hf}.{leaf}")
    return out


def export_neox_weights(state_dict, cfg) -> Dict[str, np.ndarray]:
    """The port's ``NeoXForCausalLM`` state_dict -> HF
    ``GPTNeoXForCausalLM`` state_dict arrays (numpy)."""
    sd = {
        "gpt_neox.embed_in.weight": _np(state_dict["embed.weight"]),
        "embed_out.weight": _np(state_dict["embed_out.weight"]),
        "gpt_neox.final_layer_norm.weight": _np(
            state_dict["final_norm.weight"]),
        "gpt_neox.final_layer_norm.bias": _np(state_dict["final_norm.bias"]),
    }
    for i in range(cfg.num_layers):
        for hf, port in _NEOX_HF:
            for leaf in ("weight", "bias"):
                sd[f"gpt_neox.layers.{i}.{hf}.{leaf}"] = _np(
                    state_dict[f"layers.{i}.{port}.{leaf}"])
    return sd
