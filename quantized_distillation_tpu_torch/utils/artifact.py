"""Compressed model artifacts: Huffman-coded quantized weights on disk
(PyTorch port of the JAX package's ``utils/artifact.py``; same container,
same bytes).

Every quantizable weight is bucketed and quantized, its level (or codebook
index) stream coded with the host codec's canonical Huffman code
(:mod:`..native`), and the result is one self-describing file that
:func:`load_artifact` restores to the deployment (hard-quantized) weights.
The file's size is what :func:`..ops.sizes.model_size_report` estimates.

Container (little-endian)::

    magic b"QDTA" | version u32 | header_len u64 | header JSON | blob

The header holds, per tensor, its shape, bits, scaling, element count and
offsets into the blob; the blob holds per quantized tensor the code length
table (2^bits bytes), the coded stream and the per-bucket scale and offset
(f32), and the raw f32 values of every other tensor (biases).

Tensors are the flax leaves of the port's parameters
(:func:`..convert.flax_leaves`: an LSTM cell's gate blocks apart, conv
kernels in HWIO, flax's sorted leaf order) under their flax paths, which is
how the JAX package names and orders them, so the same weights give the
same file in both packages. Quantization runs on the CPU; loading
dequantizes with NumPy, as the JAX package does, and only then moves the
weights to ``device``.
"""

from __future__ import annotations

import io
import json
import os
import struct
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import native
from .._device import resolve_device
from ..config import QuantSpec
from ..convert import flax_leaves, fuse_flax_leaves
from ..ops import codebook as cb
from ..ops import uniform
from ..train.quantize_tree import is_quantizable

MAGIC = b"QDTA"
VERSION = 1



def _params(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def save_artifact(
    path: str,
    params,
    spec: QuantSpec,
    *,
    codebooks: Optional[Mapping[str, torch.Tensor]] = None,
    bits_map: Optional[Mapping[str, int]] = None,
    meta: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Write the artifact of ``params`` (a port model, or its parameter
    names → tensors) → stats (file bytes, fp32 bytes, their ratio, bytes
    per tensor).

    ``codebooks`` (flax path → points) with ``spec.method == "codebook"``
    stores codebook indices and each leaf's points; ``bits_map`` (flax path
    → bits) overrides ``spec.bits`` per leaf."""
    blob = io.BytesIO()
    tensors: Dict[str, Dict[str, Any]] = {}
    fp32_bytes = 0
    for name, leaf in flax_leaves(_params(params)):
        arr = leaf.detach().to("cpu").contiguous()
        fp32_bytes += arr.numel() * 4
        entry: Dict[str, Any] = {"shape": list(arr.shape)}
        if is_quantizable(name, arr, spec) and arr.is_floating_point():
            bits = bits_map.get(name, spec.bits) if bits_map else spec.bits
            if spec.method == "codebook" and codebooks is not None:
                points = codebooks[name].detach().to("cpu", torch.float32)
                ct = cb.quantize(arr, points, bucket_size=spec.bucket_size,
                                 scaling=spec.scaling)
                idx, sp, n = ct.idx, ct.scale, ct.n
                bits = points.numel().bit_length() - 1
                entry["points"] = points.tolist()
            else:
                qt = uniform.quantize(arr, bits, bucket_size=spec.bucket_size,
                                      scaling=spec.scaling)
                idx, sp, n = qt.levels, qt.scale, qt.n
            stream = idx.reshape(-1)[:n].to(torch.int32).numpy()
            payload, lens, nbits = native.huffman_encode(stream, 1 << bits)
            scale = sp.scale.to(torch.float32).reshape(-1).numpy()
            offset = sp.offset.to(torch.float32).reshape(-1).numpy()
            entry.update(
                quant=True, bits=bits, scaling=sp.kind, n=int(n),
                bucket_size=spec.bucket_size, n_bits=int(nbits), lens_off=blob.tell(),
            )
            blob.write(lens.tobytes())
            entry["payload_off"] = blob.tell()
            entry["payload_len"] = (nbits + 7) // 8
            blob.write(payload[: entry["payload_len"]])
            entry["scale_off"] = blob.tell()
            entry["n_buckets"] = int(scale.size)
            blob.write(scale.tobytes())
            blob.write(offset.tobytes())
        else:
            raw = arr.to(torch.float32).numpy()
            entry.update(quant=False, raw_off=blob.tell(), raw_len=raw.nbytes)
            blob.write(raw.tobytes())
        tensors[name] = entry

    header = json.dumps(
        {"tensors": tensors, "meta": meta or {}, "spec": {
            "bits": spec.bits, "bucket_size": spec.bucket_size,
            "scaling": spec.scaling, "method": spec.method}},
    ).encode()
    data = blob.getvalue()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<IQ", VERSION, len(header)))
        f.write(header)
        f.write(data)
    total = len(MAGIC) + 12 + len(header) + len(data)
    return {
        "file_bytes": total,
        "fp32_bytes": fp32_bytes,
        "compression_ratio": fp32_bytes / max(total, 1),
        "tensors": {k: v.get("payload_len", v.get("raw_len", 0)) for k, v in tensors.items()},
    }


def _read_leaves(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """An artifact's flax leaves (path → f32 array, dequantized on the
    host) and its meta."""
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"{path}: not a QDTA artifact")
        version, hlen = struct.unpack("<IQ", f.read(12))
        if version != VERSION:
            raise ValueError(f"{path}: unsupported version {version}")
        header = json.loads(f.read(hlen))
        blob = f.read()
    out: Dict[str, np.ndarray] = {}
    for name, e in header["tensors"].items():
        shape = tuple(e["shape"])
        if not e["quant"]:
            raw = np.frombuffer(blob, np.float32, count=e["raw_len"] // 4, offset=e["raw_off"])
            out[name] = raw.reshape(shape).copy()
            continue
        bits, n = e["bits"], e["n"]
        lens = np.frombuffer(blob, np.uint8, count=1 << bits, offset=e["lens_off"])
        payload = blob[e["payload_off"]: e["payload_off"] + e["payload_len"]]
        stream = native.huffman_decode(payload, e["n_bits"], lens, n)
        nb = e["n_buckets"]
        scale = np.frombuffer(blob, np.float32, count=nb, offset=e["scale_off"])
        offset = np.frombuffer(blob, np.float32, count=nb, offset=e["scale_off"] + 4 * nb)
        bs = e["bucket_size"]
        levels = np.pad(stream, (0, nb * bs - n), mode="edge").reshape(nb, bs)
        if "points" in e:
            x01 = np.asarray(e["points"], np.float32)[levels]
        else:
            x01 = levels.astype(np.float32) / ((1 << bits) - 1)
        vals = x01 * scale[:, None] + offset[:, None]
        out[name] = vals.reshape(-1)[:n].reshape(shape).astype(np.float32)
    return out, header.get("meta", {})


def load_artifact(path: str, template, *, device="cuda") -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Read an artifact → (the port parameters named as in ``template``, a
    port model or its parameter names → tensors, each a new tensor on
    ``device``; the artifact's meta). The values equal the saved
    parameters' ``quantize_tree_hard`` to rounding (the JAX package's
    dequantization order), and the JAX package's ``load_artifact`` of the
    same file bit for bit."""
    dev = resolve_device(device)
    leaves, meta = _read_leaves(path)
    template = _params(template)
    params = fuse_flax_leaves({p: torch.from_numpy(a) for p, a in leaves.items()}, template)
    for name, t in params.items():
        if tuple(t.shape) != tuple(template[name].shape):
            raise ValueError(f"{path}: {name} has shape {tuple(t.shape)}, the template "
                             f"{tuple(template[name].shape)}")
    return {n: t.contiguous().to(dev) for n, t in params.items()}, meta
