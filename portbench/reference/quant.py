"""Bucketed uniform quantization, written out from the paper's description
(arXiv:1802.05668 §2.1 with the bucketing of its §2.2): a weight tensor is
cut into buckets of ``bucket_size`` consecutive values, each bucket is
scaled into [0, 1] by its own minimum and range (a constant bucket by 1),
each value is rounded half to even onto the grid ``k / (2^bits - 1)`` and
scaled back.

Two cuts into buckets are used, as the two paths of the system use them:

- training (:func:`ste_quantize`): each weight matrix of the model
  flattened row-major, an LSTM cell's four gate blocks (i, f, g, o, side by
  side in the fused ``wi``/``wh`` tensors) each on its own, the last
  bucket padded with the last value; biases stay at full precision;
- serving (:func:`quantize_rows`): each row of a ``[K, N]`` matrix cut into
  buckets of 256 columns, the last padded with the last column.

Every operation is rounded on its own in float32.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

EXCLUDED = ("bias", "bn", "batch_stats", "scale_param")
GATES = 4


def fake_quant_flat(x: torch.Tensor, bits: int, bucket_size: int) -> torch.Tensor:
    """``x`` quantized and dequantized, bucketed over its row-major
    flattening."""
    flat = x.reshape(-1)
    n = flat.numel()
    pad = -n % bucket_size
    if pad:
        flat = torch.cat([flat, flat[-1:].expand(pad)])
    b = flat.reshape(-1, bucket_size)
    lo = b.amin(dim=1, keepdim=True)
    rng = b.amax(dim=1, keepdim=True) - lo
    scale = torch.where(rng > 0, rng, torch.ones_like(rng))
    s = float((1 << bits) - 1)
    q = torch.clamp(torch.round(((b - lo) / scale) * s), 0.0, s)
    out = (q * torch.tensor(1.0 / s, dtype=torch.float32)) * scale + lo
    return out.reshape(-1)[:n].reshape(x.shape)


def quantizable(name: str, t: torch.Tensor) -> bool:
    """Matrices and embeddings; biases (``bh``, ``*_bias``, ``*.bias``)
    stay at full precision."""
    return t.dim() >= 2 and not any(s in name for s in EXCLUDED)


def fake_quant_param(name: str, t: torch.Tensor, bits: int, bucket_size: int) -> torch.Tensor:
    """One parameter as the training path buckets it: a fused LSTM kernel
    (``*.wi``, ``*.wh``: gate blocks side by side on the last dim) gate by
    gate, anything else whole."""
    if name.endswith((".wi", ".wh")):
        return torch.cat([fake_quant_flat(g, bits, bucket_size)
                          for g in t.chunk(GATES, dim=-1)], dim=-1)
    return fake_quant_flat(t, bits, bucket_size)


def ste_quantize(params: Mapping[str, torch.Tensor], bits: int,
                 bucket_size: int) -> Dict[str, torch.Tensor]:
    """Straight-through fake quantization: each quantizable parameter's
    value is its quantized value, its gradient the identity."""
    out = {}
    for name, t in params.items():
        if quantizable(name, t):
            q = fake_quant_param(name, t.detach(), bits, bucket_size)
            out[name] = t + (q - t.detach())
        else:
            out[name] = t
    return out


def quantize_rows(w: torch.Tensor, bits: int, bucket: int = 256) -> torch.Tensor:
    """A ``[K, N]`` matrix quantized and dequantized in buckets of
    ``bucket`` columns of each row; the weight is ``level * (range / s) +
    min``."""
    k, n = w.shape
    pad = -n % bucket
    if pad:
        w = torch.cat([w, w[:, -1:].expand(k, pad)], dim=1)
    b = w.reshape(-1, bucket)
    lo = b.amin(dim=1, keepdim=True)
    rng = b.amax(dim=1, keepdim=True) - lo
    scale = torch.where(rng > 0, rng, torch.ones_like(rng))
    s = float((1 << bits) - 1)
    q = torch.clamp(torch.round(((b - lo) / scale) * s), 0.0, s)
    return (q * (scale / s) + lo).reshape(k, -1)[:, :n]
