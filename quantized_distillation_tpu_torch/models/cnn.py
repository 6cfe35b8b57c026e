"""Small CIFAR-10 CNN teacher/student family (PyTorch port of the JAX
package's ``models/cnn.py``): a conv / BatchNorm / ReLU (/ 2×2 max-pool)
stack, then an FC head with dropout after each hidden layer.

Input is NCHW (the vision task permutes the NHWC batch). flax flattens the
last feature map in (H, W, C) order, so the first Dense kernel's rows are in
that order: the port permutes the activation to NHWC before the flatten and
keeps the kernel in flax's layout, which is the one that gets bucketed.
flax sizes that kernel from the first input; the port from ``image_size``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._layers import BatchNorm, Conv, Dense, FlaxModel
from .seq2seq import dropout


@dataclass(frozen=True)
class CNNSpec:
    """(filters, use_pool) per conv layer + FC widths."""

    conv: Tuple[Tuple[int, bool], ...]
    fc: Tuple[int, ...]
    num_classes: int = 10
    dropout: float = 0.3


PRESETS = {
    "teacher": CNNSpec(
        conv=((96, False), (96, True), (192, False), (192, True), (256, True)),
        fc=(1024, 512),
    ),
    "student_large": CNNSpec(
        conv=((64, False), (64, True), (128, True), (128, True)),
        fc=(512,),
    ),
    "student_medium": CNNSpec(
        conv=((32, True), (64, True), (96, True)),
        fc=(256,),
    ),
    "student_small": CNNSpec(
        conv=((16, True), (32, True), (48, True)),
        fc=(128,),
    ),
}


class ConvForwardNet(FlaxModel):
    """Conv/BN/ReLU(/MaxPool) stack + dropout + FC head."""

    def __init__(self, spec: CNNSpec, *, image_size: int = 32, device="cuda", seed: int = 0):
        super().__init__()
        self.spec = spec
        cin, size = 3, image_size
        for i, (filters, pool) in enumerate(spec.conv):
            self.add_module(f"Conv_{i}", Conv(cin, filters, 3))
            self.add_module(f"BatchNorm_{i}", BatchNorm(filters))
            cin, size = filters, size // 2 if pool else size
        widths = (size * size * cin,) + spec.fc + (spec.num_classes,)
        for i in range(len(widths) - 1):
            self.add_module(f"Dense_{i}", Dense(widths[i], widths[i + 1]))
        self._place(device, seed)

    def forward(self, x, *, train: bool = False, generator: Optional[torch.Generator] = None):
        """NCHW images → logits [B, num_classes]."""
        for i, (_, pool) in enumerate(self.spec.conv):
            x = getattr(self, f"Conv_{i}")(x)
            x = F.relu(getattr(self, f"BatchNorm_{i}")(x, train))
            if pool:
                x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's (H, W, C) order
        for i in range(len(self.spec.fc)):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
            x = dropout(x, self.spec.dropout, train, generator)
        return getattr(self, f"Dense_{len(self.spec.fc)}")(x)


def make_cnn(preset: str = "teacher", num_classes: int = 10, *, image_size: int = 32,
             device="cuda", seed: int = 0) -> ConvForwardNet:
    spec = PRESETS[preset]
    if num_classes != spec.num_classes:
        spec = CNNSpec(conv=spec.conv, fc=spec.fc, num_classes=num_classes, dropout=spec.dropout)
    return ConvForwardNet(spec, image_size=image_size, device=device, seed=seed)
