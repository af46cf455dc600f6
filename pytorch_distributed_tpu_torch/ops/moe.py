"""Mixture-of-experts MLP with expert parallelism: the port of
``pytorch_distributed_tpu/ops/moe.py``.

The router is an f32 ``[E, D]`` projection (a ``Linear`` weight, HF's
``gate`` layout), its softmax's top ``k`` gates renormalised to sum 1
per token. The experts are three stacked tensors in the JAX layout:
``w_in`` and (for ``"swiglu"``) ``w_gate`` ``[E, D, F]`` and ``w_out``
``[E, F, D]``, one tree for both dispatch modes:

* ``capacity_factor=None`` is drop-free: every token goes through every
  expert and the outputs are combined with the dense gates (zero outside
  a token's top ``k``), as the JAX package does;
* a finite factor is Switch dispatch: each expert takes at most
  ``C = int(k * T * cf / E + 0.999)`` tokens, queue positions run
  k-major (every token's first choice before any second choice, so
  primary assignments win capacity), and what overflows is dropped to
  the residual path. The JAX package forms one-hot ``[T, E, C]``
  dispatch and combine tensors for its einsums; the port gathers each
  kept ``(t, k)`` pair's token into its ``(expert, slot)`` row and
  scatters the weighted expert outputs back, with the same kept pairs,
  slots and combine weights (:func:`route`).

The expert products are plain batched matrix products (``torch.bmm`` /
``einsum`` over the expert dim), as the JAX package computes them
outside any Pallas kernel. The Switch load-balance loss,
``E * sum_e mean_t(first choice == e) * mean_t(p_e)``, is the second
return value of ``forward``: the JAX module sows it, but a block under
``torch.utils.checkpoint`` runs its forward twice, so a value stashed on
the module would count twice; the models return it through their
outputs and the loss adds it (``train/losses.py``).

Expert parallelism (the ``ep`` mesh axis): ``parallel.FSDP`` (and
``DataParallel`` on a model-parallel mesh) places the expert tensors as
``DTensor`` shards, experts over ``ep`` and their hidden dim over
``tp`` (:func:`moe_partition_rules`), and sets :attr:`MoEMLP.group`,
the ranks of this rank's ``(ep, tp)`` slice. The tokens are replicated
over those ranks; each runs its own experts (and hidden units) on all of
them, and the output is the sum over the group (``sum_outputs``,
Megatron's ``g``). The experts' input and the gates reach the loss on
every rank through its own experts only, so their gradients sum over
the group (``sum_grad``, Megatron's ``f``); the router and the load
loss see every expert on every rank. The gradients of the expert
shards are then reduced over the data axes only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_tpu_torch.runtime.distributed import (
    sum_grad,
    sum_outputs,
)
from pytorch_distributed_tpu_torch.runtime.precision import Policy

#: the stacked expert tensors, in the JAX leaf names
EXPERT_LEAVES = ("w_in", "w_gate", "w_out")


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest entries of each row, ties
    to the lower index as ``lax.top_k`` breaks them (``torch.topk`` does
    not promise an order among equal values)."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def capacity(k: int, tokens: int, capacity_factor: float,
             num_experts: int) -> int:
    """The JAX package's per-expert queue length."""
    return max(1, int(k * tokens * capacity_factor / num_experts + 0.999))


def _group_size_rank(group) -> Tuple[int, int]:
    if group is None:
        return 1, 0
    return (torch.distributed.get_world_size(group),
            torch.distributed.get_rank(group))


def route(logits: torch.Tensor, k: int, capacity_factor: Optional[float],
          group=None, rows: int = 1):
    """The routing of ``[T, E]`` f32 router logits: ``(probs, gates, idx,
    pos, kept, C)`` with the softmax ``probs`` ``[T, E]``, the renormalised
    top-``k`` ``gates`` and their experts ``idx`` ``[T, k]``, each
    ``(t, k)`` pair's position ``pos`` in its expert's k-major queue and
    whether it is ``kept`` (under the capacity ``C``; every pair drop-free,
    where ``pos`` and ``C`` are None).

    ``group``: the ranks that split the batch (the data axes), each
    holding ``rows`` rows of the tokens, its strided share (the loader's
    ``rank_slice``: rank ``r`` of ``n`` holds global rows ``r, r + n,
    ...``). The queues are then the whole batch's, as the JAX package's
    are under SPMD: ``C`` counts every rank's tokens, and a pair's
    position counts the pairs of lower ``k`` in the whole batch and those
    of its ``k`` in the global rows before its own (one all-gather of the
    ``[k, rows, E]`` counts)."""
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    T, E = logits.shape
    if capacity_factor is None:
        return (probs, gates, idx, None,
                torch.ones_like(idx, dtype=torch.bool), None)
    n, me = _group_size_rank(group)
    C = capacity(k, T * n, capacity_factor, E)
    flat = idx.t().reshape(-1)   # k-major: every first choice first
    onehot = F.one_hot(flat, E)
    pos = (onehot.cumsum(0) - 1).gather(1, flat[:, None]).view(k, T).t()
    if n > 1:
        per_row = onehot.view(k, rows, T // rows, E)
        counts = per_row.sum(2)   # [k, rows, E]
        every = [torch.empty_like(counts) for _ in range(n)]
        torch.distributed.all_gather(every, counts.contiguous(), group=group)
        # global row i * n + r is rank r's row i
        glob = torch.stack(every, 2).reshape(k, rows * n, E)
        total = glob.sum(1)
        before = ((total.cumsum(0) - total)[:, None]
                  + (glob.cumsum(1) - glob)[:, me::n])   # [k, rows, E]
        within = (per_row.cumsum(2) - 1).view(k, T, E).gather(
            2, idx.t()[:, :, None])[..., 0].t()   # [T, k]
        row = torch.arange(T, device=idx.device) // (T // rows)
        ks = torch.arange(k, device=idx.device)[None, :]
        pos = within + before[ks, row[:, None], idx]
    return probs, gates, idx, pos, pos < C, C


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                      group=None) -> torch.Tensor:
    """The Switch auxiliary loss: ``E * sum_e f_e * P_e`` with ``f_e`` the
    share of tokens whose first choice is ``e`` and ``P_e`` the mean
    router probability of ``e``, over the whole batch of the ranks of
    ``group`` (as :func:`route`). Every rank then holds the batch's value;
    its gradient is ``n`` times this rank's part, so that the data axes'
    mean of the gradients (DDP's, FSDP's) is the batch's."""
    E = probs.shape[-1]
    primary = F.one_hot(idx[:, 0], E).to(probs.dtype).sum(0)
    p_sum = probs.sum(0)
    n, _ = _group_size_rank(group)
    T = probs.shape[0] * n
    if n > 1:
        both = torch.stack([primary, p_sum.detach()])
        torch.distributed.all_reduce(both, group=group)
        primary = both[0]
        p_sum = both[1] + n * (p_sum - p_sum.detach())
    return E * (primary / T * (p_sum / T)).sum()


def _local_experts(w: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``(this rank's experts, index of the first)``: a ``DTensor``'s
    local box (differentiably), a plain tensor whole."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    if not isinstance(w, DTensor):
        return w, 0
    _, offsets = compute_local_shape_and_global_offset(
        tuple(w.shape), w.device_mesh, w.placements)
    return w.to_local(), int(offsets[0])


class MoEMLP(nn.Module):
    """A transformer FFN of ``num_experts`` experts, each token through its
    top ``k``; ``forward(x) -> (y, aux)``. ``activation="gelu"`` is the
    Switch expert (tanh-approximate gelu, flax's default), ``"swiglu"``
    Mixtral's ``w_out(silu(x w_gate) * x w_in)``."""

    def __init__(self, hidden_size: int, num_experts: int, d_ff: int, *,
                 k: int = 2, capacity_factor: Optional[float] = 1.25,
                 activation: str = "gelu", policy: Policy = Policy(),
                 device=None):
        super().__init__()
        if activation not in ("gelu", "swiglu"):
            raise ValueError(
                f"activation must be 'gelu' or 'swiglu', got {activation!r}")
        E, D, Fd = num_experts, hidden_size, d_ff
        self.num_experts, self.k = E, k
        self.capacity_factor = capacity_factor
        self.activation = activation
        self.compute_dtype = policy.compute_dtype
        kw = dict(device=device, dtype=policy.param_dtype)
        self.router = nn.Linear(D, E, bias=False, **kw)
        self.w_in = nn.Parameter(torch.empty(E, D, Fd, **kw))
        if activation == "swiglu":
            self.w_gate = nn.Parameter(torch.empty(E, D, Fd, **kw))
        self.w_out = nn.Parameter(torch.empty(E, Fd, D, **kw))
        # the (ep, tp) ranks that share the tokens and split the experts;
        # None: every expert here (parallel.FSDP sets it)
        self.group = None
        # the ranks that split the batch: the routing's queues and the
        # load loss are over all their tokens (the strategies set it)
        self.data_group = None

    def _experts(self):
        w_in, e0 = _local_experts(self.w_in)
        w_out, _ = _local_experts(self.w_out)
        w_gate = (_local_experts(self.w_gate)[0]
                  if self.activation == "swiglu" else None)
        ct = self.compute_dtype
        return (w_in.to(ct), None if w_gate is None else w_gate.to(ct),
                w_out.to(ct), e0)

    def _hidden(self, h, g):
        if g is None:
            return F.gelu(h, approximate="tanh")
        return F.silu(g) * h

    def forward(self, x: torch.Tensor):
        *lead, D = x.shape
        tokens = x.reshape(-1, D)
        T = tokens.shape[0]
        logits = F.linear(tokens.float(), self.router.weight.float())
        probs, gates, idx, pos, kept, C = route(
            logits, self.k, self.capacity_factor, self.data_group,
            rows=lead[0] if lead else 1)
        aux = load_balance_loss(probs, idx, self.data_group)
        w_in, w_gate, w_out, e0 = self._experts()
        El = w_in.shape[0]
        ct = self.compute_dtype
        xt = tokens.to(ct)
        if self.group is not None:
            xt = sum_grad(xt, self.group)
            gates = sum_grad(gates, self.group)
        if C is None:
            dense = torch.zeros(T, self.num_experts, dtype=gates.dtype,
                                device=gates.device).scatter(1, idx, gates)
            h = torch.einsum("td,edf->tef", xt, w_in)
            g = None if w_gate is None else torch.einsum(
                "td,edf->tef", xt, w_gate)
            h = self._hidden(h, g) * dense[:, e0:e0 + El, None].to(ct)
            y = torch.einsum("tef,efd->td", h, w_out)
        else:
            local = kept & (idx >= e0) & (idx < e0 + El)
            t_idx = torch.arange(T, device=idx.device)[:, None].expand_as(idx)
            slot = ((idx - e0) * C + pos)[local]
            # every (expert, slot) row's token; empty rows read a zero row
            src = torch.full((El * C,), T, dtype=torch.long,
                             device=idx.device).scatter(0, slot, t_idx[local])
            weight = torch.zeros(El * C, dtype=gates.dtype,
                                 device=gates.device).scatter(
                0, slot, gates[local])
            padded = torch.cat([xt, xt.new_zeros(1, D)])
            expert_in = padded[src].view(El, C, D)
            h = torch.bmm(expert_in, w_in)
            g = None if w_gate is None else torch.bmm(expert_in, w_gate)
            out = torch.bmm(self._hidden(h, g), w_out).view(El * C, D)
            # f32 sums, rounded once (the JAX einsum's accumulation); over
            # ep the partial sums add in f32 before that rounding too
            y = torch.zeros(T + 1, D, dtype=torch.float32,
                            device=out.device).index_add(
                0, src, out.float() * weight.to(ct).float()[:, None])[:T]
        if self.group is not None:
            y = sum_outputs(y, self.group)
        return y.to(ct).reshape(*lead, D).to(x.dtype), aux


def moe_partition_rules(ep_axis: str = "ep", tp_axis: str = "tp"):
    """Partition rules for the MoE leaves: experts over ``ep``, the FFN
    hidden dim over ``tp``, the router replicated (the JAX rules, as
    ``(regex, PartitionSpec)`` pairs for ``parallel.sharding``)."""
    from pytorch_distributed_tpu_torch.parallel.rules import PartitionSpec as P

    return [
        ("router/kernel", P(None, None)),
        ("w_in", P(ep_axis, None, tp_axis)),
        ("w_gate", P(ep_axis, None, tp_axis)),
        ("w_out", P(ep_axis, tp_axis, None)),
    ]


def collect_aux_loss(aux_losses, weight: float = 0.01):
    """``weight`` times the sum of the per-layer load losses (the tensors
    the models return), or a zero tensor when there are none."""
    aux_losses = [a for a in aux_losses if a is not None]
    if not aux_losses:
        return torch.zeros(())
    return weight * torch.stack([a.float() for a in aux_losses]).sum()
