"""Weights made on the device from a seed, in a few large calls: one draw
of normal values for all of a model's matrices, split into views and
scaled by ``1 / sqrt(fan_in)`` (an embedding by ``1 / sqrt(dim)``); biases
are zero. The shapes come from the configuration, in the layout the
reference reads (``portbench.reference.models``)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

Shapes = Dict[str, Tuple[int, ...]]


def stream_seed(seed: int, *stream) -> int:
    """A 64-bit seed for one stream of draws of run ``seed``."""
    return int(np.random.SeedSequence([int(seed), *stream]).generate_state(1, np.uint64)[0])


def seq2seq_shapes(vocab: int, embed: int, hidden: int, layers: int) -> Shapes:
    shapes: Shapes = {"encoder.embedding": (vocab, embed)}
    for i in range(layers):
        shapes.update(_cell(f"encoder.cells.{i}", embed if i == 0 else hidden, hidden))
    shapes["tgt_embed"] = (vocab, embed)
    for i in range(layers):
        shapes.update(_cell(f"decoder.cells.{i}", embed + hidden if i == 0 else hidden, hidden))
    shapes.update({"decoder.attn.linear_in": (hidden, hidden),
                   "decoder.attn.linear_out": (2 * hidden, hidden),
                   "generator_kernel": (hidden, vocab), "generator_bias": (vocab,)})
    return shapes


def lm_shapes(vocab: int, embed: int, hidden: int, layers: int) -> Shapes:
    shapes: Shapes = {"embed.embedding": (vocab, embed)}
    for i in range(layers):
        shapes.update(_cell(f"OptimizedLSTMCell_{i}", embed if i == 0 else hidden, hidden))
    shapes.update({"generator.kernel": (hidden, vocab), "generator.bias": (vocab,)})
    return shapes


def _cell(name: str, fin: int, hidden: int) -> Shapes:
    return {f"{name}.wi": (fin, 4 * hidden), f"{name}.wh": (hidden, 4 * hidden),
            f"{name}.bh": (4 * hidden,)}


def make(shapes: Shapes, seed: int, device) -> Dict[str, torch.Tensor]:
    """Float32 weights of ``shapes`` from ``seed`` on ``device``."""
    mats = {n: s for n, s in shapes.items() if len(s) >= 2}
    sizes = [int(np.prod(s)) for s in mats.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape), size in zip(mats.items(), sizes):
        fan_in = shape[1] if "embed" in name else shape[0]
        out[name] = flat[at:at + size].view(shape).mul_(fan_in ** -0.5)
        at += size
    for name, shape in shapes.items():
        if len(shape) < 2:
            out[name] = torch.zeros(shape, device=device)
    return {n: out[n] for n in shapes}


def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``module``'s parameters, which must have the
    same names and shapes."""
    params = dict(module.named_parameters())
    got = {n: tuple(p.shape) for n, p in params.items()}
    want = {n: tuple(t.shape) for n, t in weights.items()}
    if got != want:
        raise ValueError(f"the model's parameters {got} are not the configuration's {want}")
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(weights[n])
