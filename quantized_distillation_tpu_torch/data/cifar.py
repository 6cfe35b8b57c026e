"""CIFAR-10 / CIFAR-100 datasets (the port's own copy of the JAX package's
``data/cifar.py``, which imports no JAX but is not shared; the same seeds
and files give the same arrays and batches, bit for bit).

Loading is two-tier, and downloads nothing:

1. If the standard CIFAR python-pickle archives are on disk (the extracted
   ``cifar-10-batches-py`` / ``cifar-100-python`` directories under
   ``data_dir``), load them directly — byte-compatible with the originals.
2. Otherwise generate a *deterministic synthetic* stand-in with the same
   shapes and a learnable class→feature structure, so every pipeline,
   training loop, and test runs end-to-end without the real data. Reports on
   synthetic data are labelled as such by ``source``.

Host-side numpy only: batches are NHWC numpy arrays, which the train step
(``train/tasks.py::vision_task``) moves to the device and views as NCHW.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

BASE_DATA_FOLDER = os.environ.get("QDT_DATA_DIR", os.path.expanduser("~/qdt_data"))

CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)
CIFAR100_MEAN = np.array([0.5071, 0.4865, 0.4409], np.float32)
CIFAR100_STD = np.array([0.2673, 0.2564, 0.2762], np.float32)


@dataclass
class ImageDataset:
    images: np.ndarray  # [N, 32, 32, 3] float32, normalized
    labels: np.ndarray  # [N] int32
    num_classes: int
    source: str  # 'disk' | 'synthetic'


def _load_pickle(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f, encoding="bytes")


def _normalize(x_uint8: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    x = x_uint8.astype(np.float32) / 255.0
    return (x - mean) / std


def _try_load_cifar10(data_dir: str, train: bool) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    d = os.path.join(data_dir, "cifar-10-batches-py")
    if not os.path.isdir(d):
        return None
    files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    xs, ys = [], []
    for fn in files:
        batch = _load_pickle(os.path.join(d, fn))
        xs.append(batch[b"data"])
        ys.extend(batch[b"labels"])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return x, np.asarray(ys, np.int32)


def _try_load_cifar100(data_dir: str, train: bool) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    d = os.path.join(data_dir, "cifar-100-python")
    if not os.path.isdir(d):
        return None
    batch = _load_pickle(os.path.join(d, "train" if train else "test"))
    x = batch[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return x, np.asarray(batch[b"fine_labels"], np.int32)


def _synthetic(
    num_classes: int, n: int, seed: int, sample_seed: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Learnable synthetic images: class-specific low-frequency template +
    noise. A small CNN separates them but not trivially (noise σ ≈ signal).

    The class templates depend only on (num_classes, seed) — train and test
    splits describe the SAME classification task; only the samples/noise
    (``sample_seed``) differ.
    """
    trng = np.random.default_rng((seed, num_classes, 777))
    freq = trng.standard_normal((num_classes, 8, 8, 3)).astype(np.float32)
    templates = np.stack(
        [np.kron(f, np.ones((4, 4, 1), np.float32)) for f in freq]
    )  # [C,32,32,3]
    rng = np.random.default_rng(sample_seed)
    labels = rng.integers(0, num_classes, n).astype(np.int32)
    images = templates[labels] + 1.0 * rng.standard_normal(
        (n, 32, 32, 3)
    ).astype(np.float32)
    return images, labels


def load_cifar(
    num_classes: int = 10,
    train: bool = True,
    data_dir: str = BASE_DATA_FOLDER,
    synthetic_size: Optional[int] = None,
    seed: int = 0,
) -> ImageDataset:
    loader = _try_load_cifar10 if num_classes == 10 else _try_load_cifar100
    mean, std = (
        (CIFAR10_MEAN, CIFAR10_STD) if num_classes == 10 else (CIFAR100_MEAN, CIFAR100_STD)
    )
    raw = loader(data_dir, train)
    if raw is not None:
        x, y = raw
        return ImageDataset(_normalize(x, mean, std), y, num_classes, "disk")
    n = synthetic_size or (50000 if train else 10000)
    x, y = _synthetic(num_classes, n, seed, seed * 2 + (0 if train else 1))
    return ImageDataset(x, y, num_classes, "synthetic")


def augment(images: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Random 4-pixel-pad crop + horizontal flip (the reference's torchvision
    transform stack), on the host: one reflect pad of the batch, then a
    Python loop over its images."""
    n, h, w, c = images.shape
    padded = np.pad(images, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="reflect")
    out = np.empty_like(images)
    ys = rng.integers(0, 9, n)
    xs = rng.integers(0, 9, n)
    flip = rng.random(n) < 0.5
    for i in range(n):
        img = padded[i, ys[i] : ys[i] + h, xs[i] : xs[i] + w]
        out[i] = img[:, ::-1] if flip[i] else img
    return out


def batches(
    ds: ImageDataset,
    batch_size: int,
    *,
    shuffle: bool = True,
    train_augment: bool = False,
    seed: int = 0,
    drop_remainder: bool = True,
) -> Iterator[dict]:
    """Epoch iterator of {'image', 'label'} numpy batches."""
    rng = np.random.default_rng(seed)
    idx = np.arange(len(ds.labels))
    if shuffle:
        rng.shuffle(idx)
    end = (len(idx) // batch_size) * batch_size if drop_remainder else len(idx)
    for start in range(0, end, batch_size):
        take = idx[start : start + batch_size]
        imgs = ds.images[take]
        if train_augment:
            imgs = augment(imgs, rng)
        yield {"image": imgs, "label": ds.labels[take]}
