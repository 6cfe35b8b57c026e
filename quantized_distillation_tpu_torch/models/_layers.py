"""Layers of the vision and LM families, written to flax's semantics where
PyTorch's own layers differ (a port-only module: the JAX package uses
flax's layers as they are).

- ``padding="SAME"``: lax pads ``total = max((out - 1) * s + k - n, 0)``
  with ``out = ceil(n / s)``, ``total // 2`` before and the rest after. A
  stride-2 3×3 conv on an even input pads (0, 1), which no symmetric
  ``Conv2d(padding=...)`` gives (:func:`conv_same`).
- ``BatchNorm``: momentum 0.99, eps 1e-5; in training it normalizes with
  the batch's biased variance ``E[x²] - E[x]²`` (clipped at 0) over N, H,
  W and keeps that same biased variance in its running average, where
  ``nn.BatchNorm2d`` keeps the unbiased one with momentum 0.1.

Every submodule carries the name flax gives it (``Conv_0``, ``BatchNorm_1``,
``shortcut``), so a parameter's dotted name is its flax path (see
:mod:`..convert`). Parameters keep flax's names and layouts, except that a
conv ``kernel`` is OIHW here (HWIO in flax) and a BatchNorm's ``scale`` is
``weight``; its running statistics are the buffers ``running_mean`` and
``running_var`` (flax's ``batch_stats`` ``mean`` and ``var``).

Models built from these layers hold their weights on ``device``, made from
a seed, with gradients off (the trainer turns them on); :class:`FlaxModel`
loads flax trees into them and runs them on substituted weights and
running statistics.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from .._device import resolve_device
from ..convert import batch_stats_from_numpy, flatten_tree, fuse_flax_leaves, params_from_numpy
from .seq2seq import _copy


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of lax's ``SAME`` rule for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """flax ``nn.Conv(padding="SAME")`` on NCHW ``x`` with an OIHW kernel."""
    (top, bottom), (left, right) = (
        same_pads(x.shape[2], w.shape[2], stride), same_pads(x.shape[3], w.shape[3], stride))
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


class Conv(nn.Module):
    """Bias-free conv: ``padding`` is ``"SAME"`` or a symmetric int (flax's
    explicit ``[(p, p), (p, p)]``)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding="SAME"):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cout, cin, k, k))
        self.stride, self.padding = stride, padding

    def forward(self, x):
        if self.padding == "SAME":
            return conv_same(x, self.kernel, self.stride)
        return F.conv2d(x, self.kernel, stride=self.stride, padding=self.padding)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias``, kernel ``[in, out]``."""

    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(fin, fout))
        self.bias = nn.Parameter(torch.empty(fout))

    def forward(self, x):
        return x @ self.kernel + self.bias


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of NCHW input (see the
    module docstring). In training the running statistics are overwritten
    with their new values, so a caller that must keep the old ones passes
    copies (:meth:`FlaxModel.forward_with` does). ``zero_scale``: the scale
    starts at 0 (ResNet's last BatchNorm of a block)."""

    MOMENTUM, EPS = 0.99, 1e-5

    def __init__(self, features: int, zero_scale: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.zero_scale = zero_scale

    def forward(self, x, train: bool = False):
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
            m = self.MOMENTUM
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.EPS) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class FlaxModel(nn.Module):
    """What the vision and LM models share: seeded init on ``device``,
    flax-tree loading, and a forward on substituted weights."""

    def _place(self, device, seed: int) -> None:
        self.requires_grad_(False)
        self.eval()
        self.init_weights(seed)
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def init_weights(self, seed: int) -> None:
        """Random weights from ``seed`` (drawn on the CPU, so a seed gives the
        same weights on every device): kernels N(0, 1/fan_in) (a conv's
        fan-in is I·kh·kw), embeddings N(0, 1/embed_dim), biases 0,
        BatchNorm scales 1 (0 with ``zero_scale``), running mean 0 and
        variance 1."""
        g = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            for name, p in mod.named_parameters(recurse=False):
                if isinstance(mod, BatchNorm) and name == "weight":
                    val = torch.full(p.shape, 0.0 if mod.zero_scale else 1.0)
                elif p.dim() == 1:
                    val = torch.zeros(p.shape)
                else:
                    if name == "embedding":
                        fan_in = p.shape[1]
                    elif p.dim() == 4:
                        fan_in = math.prod(p.shape[1:])
                    else:
                        fan_in = p.shape[0]
                    val = torch.randn(p.shape, generator=g) / fan_in ** 0.5
                _copy(p, val)
            if isinstance(mod, BatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)

    def load_params(self, tree) -> "FlaxModel":
        """Copy a flax ``params`` tree (numpy arrays or tensors) in."""
        named = dict(self.named_parameters())
        for name, t in fuse_flax_leaves(flatten_tree(params_from_numpy(tree)), named).items():
            _copy(named[name], t)
        return self

    def load_batch_stats(self, tree) -> "FlaxModel":
        """Copy a flax ``batch_stats`` tree in, as the running statistics."""
        named = dict(self.named_buffers())
        for name, t in batch_stats_from_numpy(tree).items():
            _copy(named[name], t)
        return self

    def forward_with(self, params: Mapping[str, torch.Tensor], *args, train: bool = False,
                     generator: Optional[torch.Generator] = None):
        """:meth:`forward` on the weights and running statistics in
        ``params`` (names → tensors, as ``named_parameters()`` and
        ``named_buffers()`` give them; a name left out reads the module's
        own) → ``(output, batch_stats)``. In training the BatchNorms update
        copies of the statistics, which come back as ``batch_stats``: no
        tensor of ``params`` and no buffer of the module changes. In eval
        ``batch_stats`` holds the statistics used."""
        own = dict(self.named_buffers())
        stats = {n: params.get(n, t) for n, t in own.items()}
        if train:
            stats = {n: t.clone() for n, t in stats.items()}
        out = functional_call(self, {**params, **stats}, args,
                              {"train": train, "generator": generator})
        return out, stats
