"""ResNet-18/34/50/101/152: the port of
``pytorch_distributed_tpu/models/resnet.py``.

The model takes NHWC images, as the JAX model and the loader do, and
runs NCHW modules on ``channels_last`` tensors: ``x.permute(0, 3, 1, 2)``
of an NHWC tensor is already channels_last in memory, so the permute
moves no byte, and cuDNN picks its NHWC convolutions. Parameters live in
``policy.param_dtype`` and every product casts them to
``policy.compute_dtype``; the logits come out in ``policy.output_dtype``.

What flax does that ``torch.nn`` does not, and this module reproduces:

* **SAME padding.** A flax ``nn.Conv`` given no padding pads
  ``pad = max((out - 1) * s + k - in, 0)`` with ``lo = pad // 2`` before
  and the rest after, ``out = ceil(in / s)``. For the stride-2 3x3 convs
  of an even input that is (0, 1), where ``padding=1`` pads (1, 1) and
  computes another function; on an odd input it is (1, 1). So
  :class:`Conv` computes the pad from each call's input. The stem's
  (3, 3), the s2d stem's (2, 1) and the max-pool's (1, 1) are explicit.
* **BatchNorm** (:class:`BatchNorm`): statistics in f32 whatever the
  compute dtype; the running variance takes the *biased* batch variance
  (``torch.nn.BatchNorm2d`` takes the unbiased one, and drifts from the
  reference from the first step); flax's momentum 0.9 keeps 0.9 of the
  running value (torch's ``momentum=0.1``); eps 1e-5; the last norm of
  every block starts with scale 0. In a process group of more than one
  rank, the batch statistics are those of the global batch, as the JAX
  model's are under SPMD: SyncBatchNorm's steps (per-rank mean and
  1/std, one all-gather, the combined statistics; in the backward one
  all-reduce of two per-channel sums), on ATen's CUDA kernels for them
  on the card and their plain versions on the CPU. In a world of one
  the collectives drop out and the steps are the same.
* **Init**: convs ``variance_scaling(2, fan_out, normal)``, the head
  flax's default ``lecun_normal`` (truncated at 2 std) with zero bias.

``stem="s2d"`` is the space-to-depth stem: 2x2 pixel blocks become
channels and a 4x4/1 conv over them computes any 7x7/2 conv
(:func:`s2d_stem_kernel_from_conv7`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_tpu_torch.runtime import distributed as dist
from pytorch_distributed_tpu_torch.runtime.device import (
    DeviceLike,
    resolve_device,
)
from pytorch_distributed_tpu_torch.runtime.precision import Policy

# flax's truncated_normal draws in [-2, 2] and divides by the std of that
# truncated unit normal, so the kept draws have the asked-for variance
_TRUNC_STD = 0.87962566103423978

Pad = Tuple[Tuple[int, int], Tuple[int, int]]


def space_to_depth(x: torch.Tensor, block: int) -> torch.Tensor:
    """[N, H, W, C] -> [N, H/b, W/b, b*b*C]; channel = (di*b + dj)*C + c."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // block, w // block, block * block * c)


def s2d_stem_kernel_from_conv7(k7):
    """A [7, 7, C, F] stride-2 conv kernel (HWIO) as the equivalent
    [4, 4, 4C, F] kernel over ``space_to_depth(x, 2)``: tap offset
    u in [-3, 3] goes to (du, di) with u = 2 du + di - 4 (the u = -4 tap
    is zero)."""
    k7 = np.asarray(k7)
    c, f = k7.shape[2], k7.shape[3]
    out = np.zeros((4, 4, 4 * c, f), k7.dtype)
    for u in range(-3, 4):
        du, di = (u + 4) // 2, (u + 4) % 2
        for v in range(-3, 4):
            dv, dj = (v + 4) // 2, (v + 4) % 2
            ch = (di * 2 + dj) * c
            out[du, dv, ch:ch + c, :] = k7[u + 3, v + 3]
    return out


def same_padding(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax's SAME padding (before, after) of one spatial dim."""
    out = -(-size // s)
    pad = max((out - 1) * s + k - size, 0)
    return pad // 2, pad - pad // 2


def _memory_format(device):
    """channels_last on the card. The CPU path runs NCHW-contiguous: the
    oneDNN in PyTorch's CPU build (2.13) corrupts its heap in the
    backward of a 1x1 stride-2 conv on channels_last tensors of 16x16
    and up."""
    if torch.device(device).type == "cuda":
        return torch.channels_last
    return torch.contiguous_format


class Conv(nn.Module):
    """A bias-free 2-D conv; ``padding=None`` is flax's SAME, computed
    from each call's input."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: Optional[Pad] = None, *, policy: Policy, device):
        super().__init__()
        # laid out as the activations are, so that its gradient has the
        # strides DDP's buckets were laid out with
        self.weight = nn.Parameter(torch.empty(
            cout, cin, k, k, device=device, dtype=policy.param_dtype,
            memory_format=_memory_format(device)))
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        k, s = self.weight.shape[-1], self.stride
        if self.padding is None:
            ph = same_padding(x.shape[2], k, s)
            pw = same_padding(x.shape[3], k, s)
        else:
            ph, pw = self.padding
        w = self.weight.to(x.dtype, memory_format=_memory_format(x.device))
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, w, stride=s, padding=(ph[0], pw[0]))
        return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=s)


_NHW = (0, 2, 3)


def _acc_dtype(x):
    return torch.promote_types(x.dtype, torch.float32)   # at least f32


def _per_channel(v):
    return v[:, None, None]


def _stats(x, eps):
    """This rank's per-channel mean and 1/sqrt(biased var + eps), in at
    least f32."""
    if x.is_cuda:
        return torch.batch_norm_stats(x, eps)
    var, mean = torch.var_mean(x.to(_acc_dtype(x)), _NHW, correction=0)
    return mean, torch.rsqrt(var + eps)


def _combine(means, invstds, counts, eps):
    """The global batch's mean and 1/std from every rank's (Chan's
    parallel formula)."""
    if means.is_cuda:
        # the kernel reads only the rows; its first argument picks the
        # dtype it dispatches on, which the counts must have
        return torch.batch_norm_gather_stats_with_counts(
            means, means, invstds, None, None, 0.0, eps, counts)
    n = counts[:, None]
    mean = (n * means).sum(0) / n.sum()
    var = (n * (invstds.pow(-2) - eps + (means - mean).square())).sum(0)
    return mean, torch.rsqrt(var / n.sum() + eps)


def _normalize(x, weight, bias, mean, invstd, eps):
    if x.is_cuda:
        return torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
    y = ((x.to(mean.dtype) - _per_channel(mean))
         * _per_channel(invstd * weight) + _per_channel(bias))
    return y.to(x.dtype)


def _backward_sums(dy, x, mean, invstd, weight):
    """(sum dy, sum dy * (x - mean), d weight, d bias) over this rank."""
    if x.is_cuda:
        return torch.batch_norm_backward_reduce(dy, x, mean, invstd, weight,
                                                True, True, True)
    dy = dy.to(mean.dtype)
    sum_dy = dy.sum(_NHW)
    sum_dy_xmu = (dy * (x.to(mean.dtype) - _per_channel(mean))).sum(_NHW)
    return sum_dy, sum_dy_xmu, sum_dy_xmu * invstd, sum_dy


def _backward_input(dy, x, mean, invstd, weight, sum_dy, sum_dy_xmu,
                    counts):
    if x.is_cuda:
        return torch.batch_norm_backward_elemt(
            dy, x, mean, invstd, weight, sum_dy, sum_dy_xmu, counts)
    n = counts.sum().to(mean.dtype)
    dy32, xmu = dy.to(mean.dtype), x.to(mean.dtype) - _per_channel(mean)
    dx = (dy32 - _per_channel(sum_dy / n)
          - xmu * _per_channel(invstd.square() * sum_dy_xmu / n)
          ) * _per_channel(invstd * weight)
    return dx.to(x.dtype)


class _TrainNorm(torch.autograd.Function):
    """Training-mode batch norm over N, H, W; with ``world`` > 1 on the
    statistics of every rank's batch together. ``counts`` is this rank's
    element count per channel (int32 [1]). Returns (y, mean, invstd); the
    statistics are not differentiable. Each rank's weight and bias
    gradients are its own batch's sums: DDP's average over the ranks
    completes them."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, world, counts):
        c = x.shape[1]
        mean, invstd = _stats(x, eps)
        if world > 1:
            rows = dist.all_gather(
                torch.cat([mean, invstd, counts.to(mean.dtype)]))
            mean, invstd = _combine(rows[:, :c], rows[:, c:2 * c],
                                    rows[:, 2 * c], eps)
            counts = rows[:, 2 * c].to(torch.int32)
        y = _normalize(x, weight, bias, mean, invstd, eps)
        ctx.save_for_backward(x, weight, mean, invstd, counts)
        ctx.world = world
        ctx.mark_non_differentiable(mean, invstd)
        return y, mean, invstd

    @staticmethod
    def backward(ctx, dy, _mean, _invstd):
        x, weight, mean, invstd, counts = ctx.saved_tensors
        fmt = (torch.channels_last
               if x.is_contiguous(memory_format=torch.channels_last)
               else torch.contiguous_format)
        dy = dy.contiguous(memory_format=fmt)
        sum_dy, sum_dy_xmu, dw, db = _backward_sums(dy, x, mean, invstd,
                                                    weight)
        if ctx.world > 1:
            sums = dist.all_reduce(torch.cat([sum_dy, sum_dy_xmu]))
            sum_dy, sum_dy_xmu = sums.split(x.shape[1])
        dx = _backward_input(dy, x, mean, invstd, weight, sum_dy,
                             sum_dy_xmu, counts)
        return dx, dw, db, None, None, None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over N, H, W of an NCHW tensor; see the
    module docstring. Output in the input's dtype. ``global_stats``
    (on unless turned off) takes the training statistics over every rank
    of the process group."""

    def __init__(self, channels: int, *, policy: Policy, device,
                 momentum: float = 0.9, eps: float = 1e-5,
                 zero_scale: bool = False):
        super().__init__()
        kw = dict(device=device, dtype=policy.param_dtype)
        self.weight = nn.Parameter(
            torch.full((channels,), 0.0 if zero_scale else 1.0, **kw))
        self.bias = nn.Parameter(torch.zeros(channels, **kw))
        self.register_buffer("running_mean", torch.zeros(
            channels, device=device, dtype=torch.float32))
        self.register_buffer("running_var", torch.ones(
            channels, device=device, dtype=torch.float32))
        self.momentum = momentum
        self.eps = eps
        self.zero_scale = zero_scale
        self.global_stats = True
        self._counts = {}    # (count, device) -> int32 [1], made once

    def forward(self, x, train: bool):
        f32 = _acc_dtype(x)
        w, b = self.weight.to(f32), self.bias.to(f32)
        if not train:
            return F.batch_norm(x, self.running_mean.to(f32),
                                self.running_var.to(f32), w, b, False, 0.0,
                                self.eps)
        world = dist.get_world_size() if self.global_stats else 1
        y, mean, invstd = _TrainNorm.apply(x, w, b, self.eps, world,
                                           self._count(x))
        with torch.no_grad():
            self._update(mean, invstd.pow(-2).sub_(self.eps))
        return y

    def _count(self, x):
        key = (x.numel() // x.shape[1], x.device)
        if key not in self._counts:
            self._counts[key] = torch.full((1,), key[0], dtype=torch.int32,
                                           device=x.device)
        return self._counts[key]

    def _update(self, mean, var):
        """flax's running update, ``ra = m * ra + (1 - m) * batch``, from
        the batch's mean and biased variance, in one launch."""
        ra = [self.running_mean, self.running_var]
        torch._foreach_lerp_(ra, [mean.to(ra[0].dtype), var.to(ra[1].dtype)],
                             1.0 - self.momentum)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, *,
                 momentum: float, **kw):
        super().__init__()
        bn = dict(momentum=momentum, **kw)
        self.conv0 = Conv(cin, filters, 3, stride, **kw)
        self.bn0 = BatchNorm(filters, **bn)
        self.conv1 = Conv(filters, filters, 3, **kw)
        self.bn1 = BatchNorm(filters, zero_scale=True, **bn)
        if stride != 1 or cin != filters:
            self.proj = Conv(cin, filters, 1, stride, **kw)
            self.proj_bn = BatchNorm(filters, **bn)

    def forward(self, x, train: bool):
        y = F.relu(self.bn0(self.conv0(x), train))
        y = self.bn1(self.conv1(y), train)
        if hasattr(self, "proj"):
            x = self.proj_bn(self.proj(x), train)
        return F.relu(x + y)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, *,
                 momentum: float, **kw):
        super().__init__()
        bn = dict(momentum=momentum, **kw)
        cout = 4 * filters
        self.conv0 = Conv(cin, filters, 1, **kw)
        self.bn0 = BatchNorm(filters, **bn)
        self.conv1 = Conv(filters, filters, 3, stride, **kw)
        self.bn1 = BatchNorm(filters, **bn)
        self.conv2 = Conv(filters, cout, 1, **kw)
        # a zero last scale starts each block as the identity
        self.bn2 = BatchNorm(cout, zero_scale=True, **bn)
        if stride != 1 or cin != cout:
            self.proj = Conv(cin, cout, 1, stride, **kw)
            self.proj_bn = BatchNorm(cout, **bn)

    def forward(self, x, train: bool):
        y = F.relu(self.bn0(self.conv0(x), train))
        y = F.relu(self.bn1(self.conv1(y), train))
        y = self.bn2(self.conv2(y), train)
        if hasattr(self, "proj"):
            x = self.proj_bn(self.proj(x), train)
        return F.relu(x + y)


class ResNet(nn.Module):
    """``forward(x, train=True)``: NHWC images -> [N, num_classes] logits.
    Module names follow the JAX model's (``stem``, ``stem_bn``,
    ``stage{i}_block{j}``, ``head``; ``conv{i}``/``bn{i}`` for flax's
    ``Conv_{i}``/``BatchNorm_{i}``)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int, width: int = 64, stem: str = "imagenet",
                 *, in_channels: int = 3, bn_momentum: float = 0.9,
                 device: DeviceLike = None, policy: Policy = Policy.train()):
        super().__init__()
        device = resolve_device(device)
        self.policy = policy
        self.stem_kind = stem
        kw = dict(policy=policy, device=device)
        if stem == "imagenet":
            self.stem = Conv(in_channels, width, 7, 2, ((3, 3), (3, 3)), **kw)
        elif stem == "s2d":
            self.stem = Conv(4 * in_channels, width, 4, 1, ((2, 1), (2, 1)),
                             **kw)
        elif stem == "cifar":
            self.stem = Conv(in_channels, width, 3, **kw)
        else:
            raise ValueError(f"unknown stem {stem!r}")
        self.stem_bn = BatchNorm(width, momentum=bn_momentum, **kw)
        self.block_names = []
        cin = width
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                block = block_cls(cin, width * 2**i, stride,
                                  momentum=bn_momentum, **kw)
                name = f"stage{i + 1}_block{j + 1}"
                self.add_module(name, block)
                self.block_names.append(name)
                cin = width * 2**i * block_cls.expansion
        self.head = nn.Linear(cin, num_classes, device=device,
                              dtype=policy.param_dtype)

    def batch_norms(self):
        return [m for m in self.modules() if isinstance(m, BatchNorm)]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Seeded weights drawn as flax's initializers draw them."""
        for m in self.modules():
            if isinstance(m, Conv):
                fan_out = m.weight[:, 0].numel()
                draw = torch.randn(m.weight.shape, generator=generator,
                                   device=m.weight.device)
                m.weight.copy_(draw * math.sqrt(2.0 / fan_out))
            elif isinstance(m, BatchNorm):
                m.weight.fill_(0.0 if m.zero_scale else 1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        w = self.head.weight
        draw = torch.empty(w.shape, device=w.device, dtype=torch.float32)
        nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.copy_(draw / (math.sqrt(w.shape[1]) * _TRUNC_STD))
        self.head.bias.zero_()
        return self

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        dtype = self.policy.compute_dtype
        x = x.to(dtype)
        if self.stem_kind == "s2d":
            x = space_to_depth(x, 2)
        # NHWC memory is channels_last NCHW: no copy on the card
        x = x.permute(0, 3, 1, 2).contiguous(
            memory_format=_memory_format(x.device))
        x = F.relu(self.stem_bn(self.stem(x), train))
        if self.stem_kind != "cifar":
            x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        x = x.mean((2, 3))
        x = F.linear(x, self.head.weight.to(dtype), self.head.bias.to(dtype))
        return x.to(self.policy.output_dtype)


def ResNet18(num_classes: int = 10, stem: str = "cifar", **kw) -> ResNet:
    return ResNet([2, 2, 2, 2], BasicBlock, num_classes, stem=stem, **kw)


def ResNet34(num_classes: int = 1000, stem: str = "imagenet",
             **kw) -> ResNet:
    return ResNet([3, 4, 6, 3], BasicBlock, num_classes, stem=stem, **kw)


def ResNet50(num_classes: int = 1000, stem: str = "imagenet",
             **kw) -> ResNet:
    return ResNet([3, 4, 6, 3], Bottleneck, num_classes, stem=stem, **kw)


def ResNet101(num_classes: int = 1000, stem: str = "imagenet",
              **kw) -> ResNet:
    return ResNet([3, 4, 23, 3], Bottleneck, num_classes, stem=stem, **kw)


def ResNet152(num_classes: int = 1000, stem: str = "imagenet",
              **kw) -> ResNet:
    return ResNet([3, 8, 36, 3], Bottleneck, num_classes, stem=stem, **kw)
