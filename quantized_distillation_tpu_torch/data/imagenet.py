"""ImageNet-family data pipeline, downsampled-ImageNet format + synthetic
(the port's own copy of the JAX package's ``data/imagenet.py``; the same
seeds and files give the same arrays, bit for bit).

Loading is two-tier like ``data/cifar.py``:

1. Real data: ``{split}_images.npy`` (uint8 ``[N, S, S, 3]``) +
   ``{split}_labels.npy`` (int) under ``data_dir`` — the common packaging of
   downsampled ImageNet (Imagenet32/64) — normalized with the standard
   ImageNet channel statistics.
2. Otherwise a deterministic synthetic stand-in at the requested resolution
   with learnable class structure (labelled ``source='synthetic'``).

Reuses :func:`.cifar.batches` / :func:`.cifar.augment` for epoch iteration
(they are resolution-agnostic).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .cifar import BASE_DATA_FOLDER, ImageDataset, _normalize

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _synthetic_images(
    num_classes: int, n: int, image_size: int, seed: int, sample_seed: int
) -> ImageDataset:
    """Class-template + noise images at any resolution (see cifar._synthetic)."""
    block = max(image_size // 8, 1)
    grid = -(-image_size // block)  # ceil: kron output covers >= image_size
    trng = np.random.default_rng((seed, num_classes, image_size, 777))
    freq = trng.standard_normal((num_classes, grid, grid, 3)).astype(np.float32)
    templates = np.stack(
        [np.kron(f, np.ones((block, block, 1), np.float32)) for f in freq]
    )[:, :image_size, :image_size]  # crop to exact resolution (size may not divide)
    rng = np.random.default_rng(sample_seed)
    labels = rng.integers(0, num_classes, n).astype(np.int32)
    images = templates[labels] + rng.standard_normal(
        (n, image_size, image_size, 3)
    ).astype(np.float32)
    return ImageDataset(images, labels, num_classes, "synthetic")


def load_imagenet(
    train: bool = True,
    data_dir: str = BASE_DATA_FOLDER,
    image_size: int = 64,
    num_classes: Optional[int] = None,
    synthetic_size: Optional[int] = None,
    seed: int = 0,
    label_base: Optional[int] = None,
) -> ImageDataset:
    """Load a downsampled-ImageNet npy pack or a synthetic stand-in.

    ``label_base``: base of the on-disk labels (Imagenet64 ships 1-based).
    ``None`` auto-detects: subtract 1 only when ``y.min() == 1``. A 0-based
    pack whose split lacks class 0 keeps its labels intact either way only if
    you pass ``label_base=0`` explicitly — auto-detection cannot distinguish
    that case from a 1-based pack.

    ``num_classes``: explicit class count (authoritative when given — pass
    the same value for train and val so the splits stay consistent even when
    one split is missing some classes). ``None`` derives it from this
    split's labels for disk packs and defaults to 1000 for synthetic data.
    """
    split = "train" if train else "val"
    xp = os.path.join(data_dir, f"{split}_images.npy")
    yp = os.path.join(data_dir, f"{split}_labels.npy")
    if os.path.exists(xp) and os.path.exists(yp):
        x = np.load(xp)
        y = np.load(yp).astype(np.int32)
        base = label_base if label_base is not None else (1 if y.min() == 1 else 0)
        y -= base
        nc = num_classes if num_classes is not None else int(y.max()) + 1
        if int(y.max()) >= nc:
            raise ValueError(
                f"{split} labels reach {int(y.max())} but num_classes={nc}"
            )
        return ImageDataset(
            _normalize(x, IMAGENET_MEAN, IMAGENET_STD), y, nc, "disk"
        )
    n = synthetic_size or (20000 if train else 2000)
    return _synthetic_images(
        num_classes or 1000, n, image_size, seed, seed * 2 + (0 if train else 1)
    )
