"""ImageNet-family ResNets (PyTorch port of the JAX package's
``models/resnet.py``): post-activation ResNet-v1 with basic (18/34) and
bottleneck (50) blocks; students shrink by a width multiplier. Input is
NCHW. The ImageNet stem is a 7×7/2 conv with explicit padding 3 and a 3×3/2
max-pool with padding 1; ``small_inputs`` swaps them for a 3×3 ``SAME``
conv. The last BatchNorm of every block starts with scale 0.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ._layers import BatchNorm, Conv, Dense, FlaxModel


class ResNetBlock(nn.Module):
    """Post-activation basic block: Conv-BN-ReLU-Conv-BN + shortcut, ReLU."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, 3, stride)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3)
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True)
        _projection(self, cin, filters, stride)

    def forward(self, x, train: bool = False):
        h = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        h = self.BatchNorm_1(self.Conv_1(h), train)
        return F.relu(h + _shortcut(self, x, train))


class BottleneckBlock(nn.Module):
    """1x1 → 3x3 → 1x1 bottleneck with 4x expansion."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, 1)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, stride)
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = Conv(filters, 4 * filters, 1)
        self.BatchNorm_2 = BatchNorm(4 * filters, zero_scale=True)
        _projection(self, cin, 4 * filters, stride)

    def forward(self, x, train: bool = False):
        h = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        h = F.relu(self.BatchNorm_1(self.Conv_1(h), train))
        h = self.BatchNorm_2(self.Conv_2(h), train)
        return F.relu(h + _shortcut(self, x, train))


def _projection(block: nn.Module, cin: int, cout: int, stride: int) -> None:
    """The 1x1 conv + BN shortcut where the stride or width changes."""
    if cin != cout or stride != 1:
        block.shortcut = Conv(cin, cout, 1, stride)
        block.shortcut_bn = BatchNorm(cout)
    else:
        block.shortcut = None


def _shortcut(block: nn.Module, x, train: bool):
    return x if block.shortcut is None else block.shortcut_bn(block.shortcut(x), train)


class ResNet(FlaxModel):
    """ResNet-v1. ``stage_sizes`` blocks per stage at widths 64w/128w/256w/512w."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2), bottleneck: bool = False,
                 num_classes: int = 1000, width_mult: float = 1.0, small_inputs: bool = False,
                 *, device="cuda", seed: int = 0):
        super().__init__()
        self.small_inputs = small_inputs
        w0 = max(int(64 * width_mult), 16)
        self.stem = Conv(3, w0, 3) if small_inputs else Conv(3, w0, 7, stride=2, padding=3)
        self.BatchNorm_0 = BatchNorm(w0)
        block = BottleneckBlock if bottleneck else ResNetBlock
        cin, k = w0, 0
        for stage, n_blocks in enumerate(stage_sizes):
            filters = max(int(64 * (2 ** stage) * width_mult), 16)
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                self.add_module(f"{block.__name__}_{k}", block(cin, filters, stride))
                cin, k = block.expansion * filters, k + 1
        self.blocks = [f"{block.__name__}_{i}" for i in range(k)]
        self.Dense_0 = Dense(cin, num_classes)
        self._place(device, seed)

    def forward(self, x, *, train: bool = False, generator: Optional[torch.Generator] = None):
        """NCHW images → logits [B, num_classes]."""
        x = F.relu(self.BatchNorm_0(self.stem(x), train))
        if not self.small_inputs:
            x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        return self.Dense_0(x.mean(dim=(2, 3)))


RESNET_PRESETS = {
    "resnet18": dict(stage_sizes=(2, 2, 2, 2), bottleneck=False),
    "resnet34": dict(stage_sizes=(3, 4, 6, 3), bottleneck=False),
    "resnet50": dict(stage_sizes=(3, 4, 6, 3), bottleneck=True),
    "resnet18_half": dict(stage_sizes=(2, 2, 2, 2), bottleneck=False, width_mult=0.5),
    "resnet18_quarter": dict(stage_sizes=(2, 2, 2, 2), bottleneck=False, width_mult=0.25),
}


def make_resnet(preset: str = "resnet18", num_classes: int = 1000, *, small_inputs: bool = False,
                device="cuda", seed: int = 0) -> ResNet:
    return ResNet(num_classes=num_classes, small_inputs=small_inputs, device=device, seed=seed,
                  **RESNET_PRESETS[preset])
