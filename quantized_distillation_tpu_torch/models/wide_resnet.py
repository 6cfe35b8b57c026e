"""WideResNet for CIFAR-100 (teacher) and narrower students (PyTorch port
of the JAX package's ``models/wide_resnet.py``): pre-activation
BasicBlocks in three groups of widths ``16k / 32k / 64k``, stride 2
between groups, global average pool and a linear classifier. Input is
NCHW; the strided convs pad as flax's ``SAME`` does (see :mod:`._layers`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ._layers import BatchNorm, Conv, Dense, FlaxModel
from .seq2seq import dropout


class BasicBlock(nn.Module):
    """Pre-activation residual block: BN-ReLU-Conv3x3 twice + shortcut. The
    projection shortcut (when the stride or width changes) reads the
    activated input; the identity reads the block's input."""

    def __init__(self, cin: int, filters: int, stride: int = 1, dropout: float = 0.0):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(cin)
        self.shortcut = Conv(cin, filters, 1, stride) if cin != filters or stride != 1 else None
        self.Conv_0 = Conv(cin, filters, 3, stride)
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3)
        self.dropout = dropout

    def forward(self, x, train: bool = False, generator=None):
        h = F.relu(self.BatchNorm_0(x, train))
        shortcut = x if self.shortcut is None else self.shortcut(h)
        h = F.relu(self.BatchNorm_1(self.Conv_0(h), train))
        h = dropout(h, self.dropout, train, generator)
        return self.Conv_1(h) + shortcut


class WideResNet(FlaxModel):
    """WRN-depth-widen; depth = 6n + 4."""

    def __init__(self, depth: int = 16, widen: int = 2, num_classes: int = 100,
                 dropout: float = 0.0, *, device="cuda", seed: int = 0):
        super().__init__()
        if (depth - 4) % 6 != 0:
            raise ValueError(f"WRN depth must be 6n+4, got {depth}")
        n = (depth - 4) // 6
        self.conv_init = Conv(3, 16, 3)
        cin, k = 16, 0
        for group, width in enumerate((16 * widen, 32 * widen, 64 * widen)):
            for i in range(n):
                stride = 2 if (group > 0 and i == 0) else 1
                self.add_module(f"BasicBlock_{k}", BasicBlock(cin, width, stride, dropout))
                cin, k = width, k + 1
        self.blocks = k
        self.BatchNorm_0 = BatchNorm(cin)
        self.Dense_0 = Dense(cin, num_classes)
        self._place(device, seed)

    def forward(self, x, *, train: bool = False, generator: Optional[torch.Generator] = None):
        """NCHW images → logits [B, num_classes]."""
        x = self.conv_init(x)
        for k in range(self.blocks):
            x = getattr(self, f"BasicBlock_{k}")(x, train, generator)
        x = F.relu(self.BatchNorm_0(x, train))
        return self.Dense_0(x.mean(dim=(2, 3)))


WRN_PRESETS = {
    "teacher": dict(depth=28, widen=10),
    "student_large": dict(depth=22, widen=4),
    "student_medium": dict(depth=16, widen=4),
    "student_small": dict(depth=16, widen=2),
}


def make_wrn(preset: str = "student_small", num_classes: int = 100, *, device="cuda",
             seed: int = 0) -> WideResNet:
    return WideResNet(num_classes=num_classes, device=device, seed=seed, **WRN_PRESETS[preset])
