"""Knowledge-distillation training of a 4-bit student, written out
(arXiv:1802.05668 §2, quantized distillation; Hinton et al. 2015 for the
loss): each step quantizes the student's weights with a straight-through
gradient, runs the student on them and the teacher on its own weights,
takes ``(1 - w) CE(student, labels) + w T² KL(softmax(teacher / T) ||
softmax(student / T))`` averaged over the real target tokens, its gradient
on the full-precision weights, clips the global norm (optax's rule: scale by
``clip / norm`` when ``norm >= clip``) and takes an Adam step (β 0.9,
0.999, ε 1e-8, bias corrections in float32).

:func:`follow` runs a given number of steps from given weights and records
what the benchmark compares: each step's loss, the first step's gradient as
the optimizer takes it (after clipping) and each parameter's change over
all the steps, as norms per parameter.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .models import lm_forward, seq2seq_forward
from .quant import ste_quantize

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclass(frozen=True)
class Recipe:
    """What a training configuration fixes."""

    family: str  # "seq2seq" or "lm"
    layers_student: int
    layers_teacher: int
    bits: int = 4
    bucket_size: int = 256
    learning_rate: float = 1e-3
    clip_norm: float = 5.0
    distill_weight: float = 0.7
    temperature: float = 5.0


def kd_loss(student, teacher, labels, mask, weight: float, temperature: float,
            rows: Optional[slice] = None):
    """The distillation loss over the real tokens (``mask``); ``rows``
    restricts it to some rows of the batch (a planted fault)."""
    if rows is not None:
        student, teacher, labels, mask = student[rows], teacher[rows], labels[rows], mask[rows]
    denom = torch.clamp(mask.sum(), min=1.0)
    nll = -torch.gather(torch.log_softmax(student, dim=-1), -1, labels[..., None])[..., 0]
    ce = (nll * mask).sum() / denom
    t = temperature
    p_t = torch.softmax(teacher / t, dim=-1)
    kl = (p_t * (torch.log_softmax(teacher / t, dim=-1)
                 - torch.log_softmax(student / t, dim=-1))).sum(dim=-1)
    return (1.0 - weight) * ce + weight * (t * t) * (kl * mask).sum() / denom


def _bias_correction(decay: float, count: int) -> float:
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def follow(recipe: Recipe, student: Mapping[str, torch.Tensor],
           teacher: Mapping[str, torch.Tensor], batches: Sequence[Dict[str, torch.Tensor]],
           carry=None, fmt: str = "f32", fault: Optional[str] = None) -> dict:
    """Train a copy of ``student`` on ``batches``, one step each →
    ``{"loss": [...], "grad": {name: norm}, "change": {name: norm}}``.
    ``carry`` (LM: ``{"student": ((c, h), ...), "teacher": ...}``) starts
    the threaded LSTM state. ``fault="half"`` takes each loss over the
    first half of the batch's rows only."""
    params = {n: t.detach().clone().requires_grad_(True) for n, t in student.items()}
    start = {n: t.detach().clone() for n, t in student.items()}
    mu = {n: torch.zeros_like(t) for n, t in start.items()}
    nu = {n: torch.zeros_like(t) for n, t in start.items()}
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for step, batch in enumerate(batches):
        q = ste_quantize(params, recipe.bits, recipe.bucket_size)
        if recipe.family == "seq2seq":
            s = seq2seq_forward(q, batch["src"], batch["src_len"], batch["tgt_in"],
                                recipe.layers_student, fmt)
            with torch.no_grad():
                t = seq2seq_forward(teacher, batch["src"], batch["src_len"], batch["tgt_in"],
                                    recipe.layers_teacher, fmt)
            labels, mask = batch["tgt_out"], batch["tgt_mask"]
        else:
            s, s_carry = lm_forward(q, batch["input"], carry["student"], recipe.layers_student, fmt)
            with torch.no_grad():
                t, t_carry = lm_forward(teacher, batch["input"], carry["teacher"],
                                        recipe.layers_teacher, fmt)
            carry = {"student": tuple((c.detach(), h.detach()) for c, h in s_carry),
                     "teacher": t_carry}
            labels = batch["target"]
            mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
        rows = slice(0, labels.shape[0] // 2) if fault == "half" else None
        loss = kd_loss(s, t, labels, mask, recipe.distill_weight, recipe.temperature, rows)
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
        del s, t, q
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            if norm >= recipe.clip_norm:
                grads = {n: (g / norm) * recipe.clip_norm for n, g in grads.items()}
            if step == 0:
                grad_norms = {n: float(torch.linalg.vector_norm(g)) for n, g in grads.items()}
            c1 = _bias_correction(B1, step + 1)
            c2 = _bias_correction(B2, step + 1)
            for n, g in grads.items():
                mu[n] = (1 - B1) * g + B1 * mu[n]
                nu[n] = (1 - B2) * (g * g) + B2 * nu[n]
                step_n = (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + EPS)
                params[n].add_(-recipe.learning_rate * step_n)
        losses.append(float(loss.detach()))
    change = {n: float(torch.linalg.vector_norm(params[n].detach() - start[n])) for n in params}
    return {"loss": losses, "grad": grad_norms, "change": change}
