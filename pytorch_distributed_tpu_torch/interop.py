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

:func:`bert_params_from_jax` does the same for a JAX
``BertForSequenceClassification`` or ``BertForMaskedLM`` tree (its
unscanned ``layer{i}`` layout), through the same slots as the
checkpoints below.

The other direction serves the checkpoints both packages read:
:func:`gpt2_slots`, :func:`llama_slots`, :func:`bert_slots`,
:func:`resnet_slots` and
:func:`model_slots` place every port tensor at its JAX ``TrainState``
leaf (path, layer of a scan-stacked leaf, layout map; a Llama slot also
maps any range of the port tensor's rows, an FSDP shard, to boxes of the
JAX leaf), :func:`gpt2_params_to_jax`, :func:`llama_params_to_jax`,
:func:`bert_params_to_jax` and
:func:`resnet_params_to_jax` are the inverses of the converters above,
and :func:`optimizer_layout` names the optax state (``mu``, ``nu``,
``count``, ``trace``) that a port optimizer's state stands for.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

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
    # its dim 1
    perm: Optional[Tuple[int, ...]] = None
    jshape: Optional[Tuple[int, ...]] = None
    rows: int = 1

    def leaf_shape(self, port_shape) -> Tuple[int, ...]:
        """The JAX leaf's full shape, from the port tensor's shape."""
        one = self.to_jax(np.empty(port_shape, np.float32)).shape
        return one if self.layer is None else (self.depth,) + one

    def row_boxes(self, a: int, b: int):
        """Rows ``[a, b)`` of the port tensor as boxes of the JAX leaf:
        ``[(ra, rb, start, stop, to_jax, from_jax)]``, where rows
        ``[ra, rb)`` fill the box ``[start, stop)`` (the layer axis of a
        stacked leaf included) and the two maps turn those rows into the
        box's array and back. A row range that cuts a head (``rows`` 2,
        e.g. q's ``[H * hd, D]`` against the JAX ``[D, H, hd]``) becomes
        a partial-head box, whole heads and another partial one."""
        if self.perm is None:
            raise NotImplementedError(
                f"{'/'.join(self.path)}: rows of this slot have no JAX box "
                "(sharded checkpoints cover Llama; ROADMAP A6)")
        perm, js = self.perm, self.jshape
        inv = tuple(int(i) for i in np.argsort(perm))
        trail = tuple(js[i] for i in perm[self.rows:])
        segments = []   # (ra, rb, per-axis (lo, hi) of the row axes)
        if self.rows == 1:
            segments.append((a, b, [(a, b)]))
        else:   # two row axes: heads x head_dim
            n1 = js[perm[1]]
            while a < b:
                h, r = divmod(a, n1)
                if r or b - a < n1:
                    end = min(b, (h + 1) * n1)
                    segments.append((a, end, [(h, h + 1), (r, r + end - a)]))
                else:
                    end = (b // n1) * n1
                    segments.append((a, end, [(h, end // n1), (0, n1)]))
                a = end
        lead = () if self.layer is None else (self.layer,)
        out = []
        for ra, rb, ranges in segments:
            start, stop = [0] * len(js), list(js)
            for axis, (lo, hi) in zip(perm, ranges):
                start[axis], stop[axis] = lo, hi
            shape = tuple(hi - lo for lo, hi in ranges) + trail
            out.append((
                ra, rb, lead + tuple(start),
                tuple(x + 1 for x in lead) + tuple(stop),
                lambda x, shape=shape: x.reshape(shape).transpose(inv),
                lambda y, n=rb - ra: y.transpose(perm).reshape(
                    (n,) + ((int(np.prod(trail)),) if trail else ())),
            ))
        return out


def _permuted(tree, path, layer, depth, jshape, perm, rows=1) -> Slot:
    """A :class:`Slot` whose maps are a transpose by ``perm`` and a
    reshape: port ``[prod(row axes), prod(the rest)]``."""
    inv = tuple(int(i) for i in np.argsort(perm))
    pshape = (int(np.prod([jshape[i] for i in perm[:rows]])),)
    if rows < len(perm):
        pshape += (int(np.prod([jshape[i] for i in perm[rows:]])),)
    return Slot(
        tree, path, layer, depth,
        lambda w: w.reshape([jshape[i] for i in perm]).transpose(inv),
        lambda k: k.transpose(perm).reshape(pshape),
        perm=tuple(perm), jshape=tuple(jshape), rows=rows)


def _same(a):
    return a


def gpt2_slots(cfg) -> Dict[str, Slot]:
    """``{port name: Slot}`` for ``GPT2LMHead``: the scan-stacked JAX
    layout (``blocks/block/...`` with a leading ``[L]``), the one the
    JAX recipe trains."""
    D, H = cfg.hidden_size, cfg.num_heads
    L, hd = cfg.num_layers, cfg.hidden_size // cfg.num_heads
    top = {
        "wte.weight": ("wte", "embedding"), "wpe.weight": ("wpe", "embedding"),
        "ln_f.weight": ("ln_f", "scale"), "ln_f.bias": ("ln_f", "bias"),
    }
    slots = {k: Slot("params", p, None, 0, _same, _same)
             for k, p in top.items()}
    T = lambda a: a.T  # noqa: E731 - [out, in] <-> [in, out]
    per_layer = {
        "ln1.weight": ("ln1", "scale", _same, _same),
        "ln1.bias": ("ln1", "bias", _same, _same),
        "ln2.weight": ("ln2", "scale", _same, _same),
        "ln2.bias": ("ln2", "bias", _same, _same),
        "attn_qkv.weight": ("attn_qkv", "kernel",
                            lambda w: w.T.reshape(D, 3, H, hd),
                            lambda k: k.reshape(D, -1).T),
        "attn_qkv.bias": ("attn_qkv", "bias",
                          lambda b: b.reshape(3, H, hd),
                          lambda b: b.reshape(-1)),
        "attn_out.weight": ("attn_out", "kernel",
                            lambda w: w.T.reshape(H, hd, D),
                            lambda k: k.reshape(-1, D).T),
        "attn_out.bias": ("attn_out", "bias", _same, _same),
        "mlp_up.weight": ("mlp_up", "kernel", T, T),
        "mlp_up.bias": ("mlp_up", "bias", _same, _same),
        "mlp_down.weight": ("mlp_down", "kernel", T, T),
        "mlp_down.bias": ("mlp_down", "bias", _same, _same),
    }
    for i in range(L):
        for sub, (mod, leaf, fwd, inv) in per_layer.items():
            slots[f"blocks.{i}.{sub}"] = Slot(
                "params", ("blocks", "block", mod, leaf), i, L, fwd, inv)
    return slots


def llama_slots(cfg) -> Dict[str, Slot]:
    """``{port name: Slot}`` for ``LlamaForCausalLM``: the scan-stacked
    JAX layout (``layers/block/...`` with a leading ``[L]``), the one the
    JAX recipe trains. q/k/v ``[H * hd, D]`` are ``[D, H, hd]`` kernels,
    o ``[D, H * hd]`` an ``[H, hd, D]`` one, gate/up/down and the head
    ``[out, in]`` ``[in, out]`` kernels, the embedding and the norms'
    scales as they are."""
    D, V, I = cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size
    H, Hkv, hd, L = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        cfg.num_layers
    slots = {
        "embed.weight": _permuted("params", ("embed", "embedding"), None, 0,
                                  (V, D), (0, 1)),
        "final_norm.weight": _permuted("params", ("final_norm", "scale"),
                                       None, 0, (D,), (0,)),
        "lm_head.weight": _permuted("params", ("lm_head", "kernel"), None, 0,
                                    (D, V), (1, 0)),
    }
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
    for i in range(L):
        for sub, (mod, leaf, js, perm, rows) in per_layer.items():
            slots[f"layers.{i}.{sub}"] = _permuted(
                "params", ("layers", "block", mod, leaf), i, L, js, perm,
                rows)
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
    slots = bert_slots(cfg, _bert_head(state_dict))
    left, missing = set(state_dict) - set(slots), set(slots) - set(state_dict)
    if left or missing:
        raise NotImplementedError(
            f"bert_params_to_jax: tensors the JAX model has no leaf for: "
            f"{sorted(left)}; JAX leaves without a tensor: {sorted(missing)} "
            "(ROADMAP A7)")
    return _stacked(state_dict, slots, "params")


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
    """The slots of a ``GPT2LMHead``, a ``LlamaForCausalLM``, a BERT
    (``BertForSequenceClassification``, ``BertForMaskedLM``) or a
    ``ResNet`` (or one inside ``DistributedDataParallel``): every entry
    of its ``state_dict``."""
    from pytorch_distributed_tpu_torch.models.bert import (
        BertForMaskedLM,
        BertForSequenceClassification,
    )
    from pytorch_distributed_tpu_torch.models.gpt2 import GPT2LMHead
    from pytorch_distributed_tpu_torch.models.llama import LlamaForCausalLM
    from pytorch_distributed_tpu_torch.models.resnet import ResNet

    model = getattr(model, "module", model)
    if hasattr(model, "adapter_slots"):   # a lora.LoRAModel
        return model.adapter_slots()
    model = getattr(model, "wrapped_model", model)
    if isinstance(model, GPT2LMHead):
        slots = gpt2_slots(model.config)
    elif isinstance(model, LlamaForCausalLM):
        slots = llama_slots(model.config)
    elif isinstance(model, BertForSequenceClassification):
        slots = bert_slots(model.config, "classifier")
    elif isinstance(model, BertForMaskedLM):
        slots = bert_slots(model.config, "mlm")
    elif isinstance(model, ResNet):
        slots = resnet_slots(logical_shapes(model).keys())
    else:
        raise NotImplementedError(
            f"no JAX leaf layout for {type(model).__name__}: checkpoints of "
            "the port cover GPT-2, Llama, BERT and ResNet (ROADMAP A5)")
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


def gpt2_params_to_jax(state_dict, cfg) -> dict:
    """The inverse of :func:`gpt2_params_from_jax`: the port's
    ``GPT2LMHead`` state_dict as JAX ``GPT2LMHead`` params (f32 numpy,
    the scan-stacked layout)."""
    slots = gpt2_slots(cfg)
    left, missing = set(state_dict) - set(slots), set(slots) - set(state_dict)
    if left or missing:
        raise NotImplementedError(
            f"gpt2_params_to_jax: tensors the JAX model has no leaf for: "
            f"{sorted(left)}; JAX leaves without a tensor: {sorted(missing)} "
            "(ROADMAP A7)")
    return _stacked(state_dict, slots, "params")


def llama_params_to_jax(state_dict, cfg) -> dict:
    """The inverse of :func:`llama_params_from_jax`: the port's
    ``LlamaForCausalLM`` state_dict as JAX ``LlamaForCausalLM`` params
    (f32 numpy, the scan-stacked layout, ``scan_layers=True``)."""
    slots = llama_slots(cfg)
    left, missing = set(state_dict) - set(slots), set(slots) - set(state_dict)
    if left or missing:
        raise NotImplementedError(
            f"llama_params_to_jax: tensors the JAX model has no leaf for: "
            f"{sorted(left)}; JAX leaves without a tensor: {sorted(missing)} "
            "(ROADMAP A7)")
    return _stacked(state_dict, slots, "params")


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
    ``count`` is the path of the optax update count (one scalar, where
    torch keeps a ``step`` per parameter), ``schedule_count`` that of a
    learning-rate schedule's own count, when there is one."""

    moments: Dict[str, Tuple[str, ...]]
    count: Optional[Tuple[str, ...]]
    schedule_count: Optional[Tuple[str, ...]]


def unwrap_optimizer(optimizer):
    """(clipped?, the optimizer that holds this rank's state, the
    ``ZeroRedundancyOptimizer`` around it or None)."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    from pytorch_distributed_tpu_torch.optim import _ClippedOptimizer

    clipped = isinstance(optimizer, _ClippedOptimizer)
    inner = optimizer.optimizer if clipped else optimizer
    zero = inner if isinstance(inner, ZeroRedundancyOptimizer) else None
    return clipped, (zero.optim if zero is not None else inner), zero


def optimizer_layout(optimizer) -> OptimizerLayout:
    """The optax state a port optimizer stands for:
    ``AdamW`` is ``optax.adamw`` (``chain(scale_by_adam,
    add_decayed_weights, scale_by_learning_rate)``), ``SGD`` is
    ``optax.sgd`` (``chain(trace, scale_by_learning_rate)``), and
    ``clip_grad_norm`` puts either second in
    ``chain(clip_by_global_norm, ...)``."""
    clipped, local, _ = unwrap_optimizer(optimizer)
    base = ("opt_state", "1") if clipped else ("opt_state",)
    sched = getattr(local, "schedule", None) is not None
    if isinstance(local, torch.optim.AdamW):
        adam = base + ("0",)
        return OptimizerLayout(
            {"exp_avg": adam + ("mu",), "exp_avg_sq": adam + ("nu",)},
            adam + ("count",), base + ("2", "count") if sched else None)
    if isinstance(local, torch.optim.SGD):
        momentum = local.param_groups[0]["momentum"]
        return OptimizerLayout(
            {"momentum_buffer": base + ("0", "trace")} if momentum else {},
            None, base + ("1", "count") if sched else None)
    raise NotImplementedError(
        f"no optax layout for {type(local).__name__}: checkpoints cover "
        "AdamW and SGD (ROADMAP A4)")


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
    ``GPT2LMHead``, ``LlamaForCausalLM`` or BERT that a JAX ``Dense``,
    ``DenseGeneral`` or ``Embed`` leaf holds, and for every 1-D one.
    ``Slot.to_jax`` is the same map on numpy arrays (the tests hold the
    two equal)."""
    base = getattr(model, "module", model)
    base = getattr(base, "wrapped_model", base)
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
