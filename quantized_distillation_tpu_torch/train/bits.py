"""Automatic bit-width assignment across layers (PyTorch port of the JAX
package's ``train/bits.py``).

A layer's sensitivity is ``s_l = mean |g_l * w_l|`` over its weights (the
first-order loss change per weight if they move), averaged over a few
batches; layers are then bumped from the lowest allowed bit width toward
the highest, most sensitive first, while the parameter-weighted mean stays
within the budget. Both work per flax leaf (``convert.flax_leaves``), so a
``bits_map`` from here keys the quantize-tree transforms as the JAX
package's does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Mapping, Tuple

import torch

from ..config import QuantSpec
from ..convert import flax_leaves
from .quantize_tree import is_quantizable

ALLOWED_BITS = (2, 4, 8)


def gradient_sensitivities(
    loss_fn: Callable[[Dict[str, torch.Tensor], Any], torch.Tensor],
    params: Mapping[str, torch.Tensor],
    batches: Iterable[Any],
    spec: QuantSpec,
) -> Dict[str, float]:
    """Flax path → mean |g * w| per weight of each quantizable leaf, averaged
    over ``batches``. ``loss_fn(params, batch)`` returns a scalar tensor;
    the gradients are taken on detached copies of ``params``, so the
    caller's tensors are left as they are."""
    wrt = {n: t.detach().requires_grad_(True) for n, t in params.items()}
    names = list(wrt)
    acc: Dict[str, float] = {}
    count = 0
    for batch in batches:
        grads = torch.autograd.grad(loss_fn(wrt, batch), [wrt[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(wrt[n]) if g is None else g for n, g in zip(names, grads)}
        weights = dict(flax_leaves({n: t.detach() for n, t in wrt.items()}))
        for path, g in flax_leaves(grads):
            if is_quantizable(path, g, spec):
                acc[path] = acc.get(path, 0.0) + float(torch.mean(torch.abs(g * weights[path])))
        count += 1
    return {k: v / max(count, 1) for k, v in acc.items()}


def assign_bits(
    param_sizes: Dict[str, int],
    sensitivities: Dict[str, float],
    target_mean_bits: float,
    allowed: Tuple[int, ...] = ALLOWED_BITS,
) -> Dict[str, int]:
    """Greedy budgeted assignment: path → bits with
    ``sum n_l b_l / sum n_l <= target_mean_bits``. Everyone starts at
    ``min(allowed)``; in decreasing sensitivity, each layer takes the most
    bits the remaining budget allows."""
    allowed = tuple(sorted(allowed))
    names = [n for n in param_sizes if n in sensitivities]
    total = sum(param_sizes[n] for n in names)
    if total == 0:
        return {}
    bits = {n: allowed[0] for n in names}
    budget = (target_mean_bits - allowed[0]) * total  # spare bit-volume
    for n in sorted(names, key=lambda x: -sensitivities[x]):
        for b in reversed(allowed):
            cost = param_sizes[n] * (b - bits[n])
            if cost <= budget + 1e-9:
                budget -= cost
                bits[n] = b
                break
    return bits
