"""The optimizer chain the JAX package builds from optax, written out in
PyTorch so that it takes the same steps.

:class:`Optimizer` is ``optax.chain(clip_by_global_norm(clip_norm),
add_decayed_weights(weight_decay), adam | sgd | sgd(momentum=0.9,
nesterov=True))`` with a learning-rate schedule, in that order, and the
same arithmetic: optax's clip scales by ``max_norm / g_norm`` only when
``g_norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` divides by
``norm + 1e-6`` instead); the schedule is read at the update count *before*
the update; Adam's bias corrections are computed in f32 as optax computes
them. Parameters, gradients and moments are dicts of parameter name →
tensor; the state lives on the parameters' device and the count on the
host, so an update needs no device-to-host copy.

An update is replayable, as a captured CUDA graph replays it: the moments
are persistent tensors updated in place, and the values that change from
step to step (the learning rate, Adam's bias corrections) are computed on
the host (:meth:`Optimizer.hyper_values`) and read from a small device
tensor, never baked into the arithmetic as Python numbers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..parallel.comm import psum
from ..parallel.mesh import MODEL_AXIS

Tensors = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]

OPTIMIZERS = ("adam", "sgd", "momentum")
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults
MOMENTUM = 0.9  # the JAX trainer's sgd(momentum=0.9, nesterov=True)


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int
) -> Schedule:
    """optax's: linear warm-up from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to 0 by ``decay_steps`` (which
    counts the warm-up)."""
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, span)
        return peak_value * (0.5 * (1 + math.cos(math.pi * c / span)))

    return schedule


def exponential_decay_staircase(init_value: float, every: int, rate: float) -> Schedule:
    """optax's ``exponential_decay(init_value, every, rate, staircase=True)``."""
    if every <= 0 or rate == 0:
        return constant_schedule(init_value)
    return lambda count: init_value if count <= 0 else init_value * rate ** math.floor(count / every)


def global_norm(tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors.values()))


def model_parallel_norm(tensors: Mapping[str, torch.Tensor], mp) -> torch.Tensor:
    """:func:`global_norm` of tensors of which this rank holds shards
    (``mp`` a ``parallel.tensor.ModelParallel``): each split tensor's
    squares summed over ``model`` once (one all-reduce), each whole one's
    counted once."""
    zero = next(iter(tensors.values())).new_zeros(())
    split = sum((torch.sum(t * t) for n, t in tensors.items() if mp.is_split(n)), zero)
    whole = sum((torch.sum(t * t) for n, t in tensors.items() if not mp.is_split(n)), zero)
    return torch.sqrt(psum(split, mp.mesh, MODEL_AXIS) + whole)


def _bias_correction(decay: float, count: int) -> np.float32:
    """``1 - decay**count`` in f32, as optax computes it."""
    return np.float32(1) - np.float32(decay) ** np.float32(count)


def _unbias(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``x`` divided by a bias correction read from ``c`` (see
    :meth:`Optimizer.hyper_values`: on the card ``c`` holds its
    reciprocal)."""
    return x * c if x.is_cuda else x / c


class OptState(NamedTuple):
    count: int  # updates applied so far
    mu: Optional[Tensors]  # Adam's first moment, or the momentum trace (updated in place)
    nu: Optional[Tensors]  # Adam's second moment (updated in place)


@dataclass(frozen=True)
class Optimizer:
    """See the module docstring. ``init(params)`` → state;
    ``update(grads, state, params)`` → (updates to add, new state)."""

    kind: str
    schedule: Schedule
    clip_norm: Optional[float] = None
    weight_decay: float = 0.0

    def __post_init__(self):
        if self.kind not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {self.kind!r}; expected one of {OPTIMIZERS}")

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        def zeros():
            return {n: torch.zeros_like(p, memory_format=torch.contiguous_format).detach()
                    for n, p in params.items()}

        return OptState(
            count=0,
            mu=zeros() if self.kind in ("adam", "momentum") else None,
            nu=zeros() if self.kind == "adam" else None,
        )

    def hyper_values(self, count: int, device) -> np.ndarray:
        """What the update after ``count`` updates reads of the host, as f32
        for a tensor on ``device``: the step ``-lr`` (the schedule at
        ``count``) and Adam's two bias corrections. On the card each
        correction is stored as its f32 reciprocal, because PyTorch divides a
        CUDA tensor by a host scalar as the product with its reciprocal: the
        update then gives the bits it gave with host scalars."""
        bc = [_bias_correction(B1, count + 1), _bias_correction(B2, count + 1)]
        if torch.device(device).type == "cuda":
            bc = [np.float32(1) / c for c in bc]
        return np.array([-self.schedule(count), *bc], np.float32)

    def update(
        self, grads: Mapping[str, torch.Tensor], state: OptState,
        params: Mapping[str, torch.Tensor], *, norm: Optional[torch.Tensor] = None,
        hyper: Optional[torch.Tensor] = None,
    ) -> Tuple[Tensors, OptState]:
        """The updates to add, and the state after them: its moments are
        ``state``'s, updated in place. ``norm``: the gradients' global norm
        where ``grads`` are one rank's shards (:func:`model_parallel_norm`);
        computed from ``grads`` when None. ``hyper``: a device tensor holding
        :meth:`hyper_values` of ``state.count`` (a train step writes it
        before the step); made here when None."""
        g = {n: t.detach() for n, t in grads.items()}
        if hyper is None:
            dev = next(iter(g.values())).device
            hyper = torch.from_numpy(self.hyper_values(state.count, dev)).to(
                dev, non_blocking=True)
        lr, c1, c2 = hyper[0], hyper[1], hyper[2]
        if self.clip_norm:
            norm = global_norm(g) if norm is None else norm
            g = {n: torch.where(norm < self.clip_norm, t, (t / norm) * self.clip_norm)
                 for n, t in g.items()}
        if self.weight_decay:
            g = {n: t + self.weight_decay * params[n].detach() for n, t in g.items()}
        mu, nu = state.mu, state.nu
        if self.kind == "adam":
            for n, t in g.items():
                torch.add((1 - B1) * t, B1 * mu[n], out=mu[n])
                torch.add((1 - B2) * (t * t), B2 * nu[n], out=nu[n])
            g = {n: _unbias(mu[n], c1) / (torch.sqrt(_unbias(nu[n], c2)) + EPS) for n in g}
        elif self.kind == "momentum":
            for n, t in g.items():
                torch.add(t, MOMENTUM * mu[n], out=mu[n])
            g = {n: t + MOMENTUM * mu[n] for n, t in g.items()}  # nesterov
        return {n: lr * t for n, t in g.items()}, OptState(state.count + 1, mu, nu)


def apply_updates(params: Mapping[str, torch.Tensor], updates: Mapping[str, torch.Tensor]) -> None:
    """``p += u`` for every parameter, in place and outside autograd."""
    with torch.no_grad():
        for n, p in params.items():
            p.add_(updates[n])
