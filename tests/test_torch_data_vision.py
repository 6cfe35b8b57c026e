"""The port's vision data pipelines (``data/cifar.py``, ``data/imagenet.py``)
against the JAX package's on the same seeds and files: every array equal
bit for bit, with the same dtype, class count and ``source``."""

import pickle

import numpy as np
import pytest
import torch

from quantized_distillation_tpu import data as jdata
from quantized_distillation_tpu.data import cifar as jcifar
from quantized_distillation_tpu.data import imagenet as jimagenet
from quantized_distillation_tpu_torch import data as pdata
from quantized_distillation_tpu_torch.data import cifar as pcifar
from quantized_distillation_tpu_torch.data import imagenet as pimagenet

torch.set_num_threads(2)


def _same_array(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _same_dataset(a, b):
    _same_array(a.images, b.images)
    _same_array(a.labels, b.labels)
    assert (a.num_classes, a.source) == (b.num_classes, b.source)


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y) == ["image", "label"]
        _same_array(x["image"], y["image"])
        _same_array(x["label"], y["label"])


def test_exports_and_constants_match():
    assert pdata.__all__ == jdata.__all__
    for name in ("CIFAR10_MEAN", "CIFAR10_STD", "CIFAR100_MEAN", "CIFAR100_STD"):
        _same_array(getattr(pcifar, name), getattr(jcifar, name))
    for name in ("IMAGENET_MEAN", "IMAGENET_STD"):
        _same_array(getattr(pimagenet, name), getattr(jimagenet, name))
    assert pcifar.BASE_DATA_FOLDER == jcifar.BASE_DATA_FOLDER


@pytest.mark.parametrize("num_classes", [10, 100])
@pytest.mark.parametrize("train", [True, False])
def test_load_cifar_synthetic(tmp_path, num_classes, train):
    a = pdata.load_cifar(num_classes, train, str(tmp_path), 40, seed=3)
    b = jdata.load_cifar(num_classes, train, str(tmp_path), 40, seed=3)
    assert a.source == "synthetic" and a.images.shape == (40, 32, 32, 3)
    _same_dataset(a, b)


def _write_cifar10(root, rng, n=6):
    d = root / "cifar-10-batches-py"
    d.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        batch = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                 b"labels": [int(v) for v in rng.integers(0, 10, n)]}
        with open(d / name, "wb") as f:
            pickle.dump(batch, f)


def _write_cifar100(root, rng, n=9):
    d = root / "cifar-100-python"
    d.mkdir()
    for name in ("train", "test"):
        batch = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                 b"fine_labels": [int(v) for v in rng.integers(0, 100, n)],
                 b"coarse_labels": [int(v) for v in rng.integers(0, 20, n)]}
        with open(d / name, "wb") as f:
            pickle.dump(batch, f)


@pytest.mark.parametrize("num_classes", [10, 100])
@pytest.mark.parametrize("train", [True, False])
def test_load_cifar_from_pickle_archives(tmp_path, num_classes, train):
    rng = np.random.default_rng(num_classes)
    (_write_cifar10 if num_classes == 10 else _write_cifar100)(tmp_path, rng)
    a = pdata.load_cifar(num_classes, train, str(tmp_path))
    b = jdata.load_cifar(num_classes, train, str(tmp_path))
    n = (30 if train else 6) if num_classes == 10 else 9
    assert a.source == "disk" and a.images.shape == (n, 32, 32, 3)
    _same_dataset(a, b)


def test_augment_same_draws():
    x = np.random.default_rng(0).standard_normal((7, 12, 10, 3)).astype(np.float32)
    a = pdata.augment(x, np.random.default_rng(5))
    b = jdata.augment(x, np.random.default_rng(5))
    _same_array(a, b)
    assert not np.array_equal(a, x)


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(train_augment=True), dict(shuffle=False, drop_remainder=False),
     dict(train_augment=True, drop_remainder=False, seed=4), dict(shuffle=False)],
    ids=["shuffle", "augment", "eval", "augment_tail", "ordered"],
)
def test_batches(kw):
    ds_p = pdata.load_cifar(10, True, "/nonexistent", 37, seed=1)
    ds_j = jdata.load_cifar(10, True, "/nonexistent", 37, seed=1)
    _same_batches(pdata.batches(ds_p, 8, **kw), jdata.batches(ds_j, 8, **kw))
    n = sum(len(b["label"]) for b in pdata.batches(ds_p, 8, **kw))
    assert n == (37 if kw.get("drop_remainder") is False else 32)


@pytest.mark.parametrize("image_size", [32, 40, 42])
@pytest.mark.parametrize("train", [True, False])
def test_load_imagenet_synthetic(image_size, train):
    # 42 px: blocks of 42 // 8 = 5 px, so the 9 x 9 template grid (45 px) is cropped
    kw = dict(data_dir="/nonexistent", image_size=image_size, num_classes=11,
              synthetic_size=12, seed=2)
    a, b = pdata.load_imagenet(train, **kw), jdata.load_imagenet(train, **kw)
    assert a.images.shape == (12, image_size, image_size, 3)
    _same_dataset(a, b)


def _write_pack(root, labels, split="train", size=8):
    x = np.random.default_rng(len(labels)).integers(0, 256, (len(labels), size, size, 3))
    np.save(root / f"{split}_images.npy", x.astype(np.uint8))
    np.save(root / f"{split}_labels.npy", np.asarray(labels, np.int64))


@pytest.mark.parametrize(
    "labels,kw,num_classes",
    [([1, 2, 3, 5, 1], {}, 5),  # 1-based, auto-detected
     ([0, 2, 3, 4, 1], {}, 5),  # 0-based
     ([1, 2, 3, 2], dict(label_base=0), 4),  # 0-based split without class 0
     ([1, 2, 3, 2], dict(num_classes=10), 10)],  # authoritative class count
    ids=["one_based", "zero_based", "label_base", "num_classes"],
)
def test_load_imagenet_npy_pack(tmp_path, labels, kw, num_classes):
    _write_pack(tmp_path, labels)
    a = pdata.load_imagenet(True, data_dir=str(tmp_path), **kw)
    b = jdata.load_imagenet(True, data_dir=str(tmp_path), **kw)
    assert a.source == "disk" and a.num_classes == num_classes
    _same_dataset(a, b)


def test_load_imagenet_labels_past_num_classes_raise(tmp_path):
    _write_pack(tmp_path, [0, 3, 7, 2], split="val")
    errors = []
    for load in (pdata.load_imagenet, jdata.load_imagenet):
        with pytest.raises(ValueError, match="num_classes=5") as e:
            load(False, data_dir=str(tmp_path), num_classes=5)
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "val labels reach 7 but num_classes=5"
