"""Classification and knowledge-distillation losses (PyTorch port of the
JAX package's ``train/losses.py``)::

  loss = (1 - w) * CE(student, labels)
       + w * T^2 * KL( softmax_T(teacher) || softmax_T(student) )

with temperature ``T`` and mixing weight ``w``; the NMT variant applies it
per time step under the target padding mask (word-level distillation).

With ``model_parallel`` (a :class:`..parallel.tensor.ModelParallel`) the
student's logits are this rank's vocab columns, and the log-softmax terms
are taken over the whole vocab with collectives over ``model``
(:mod:`..parallel.tensor`); the loss and the metrics come out whole on
every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import DistillSpec
from ..parallel.tensor import ModelParallel, vocab_parallel_kd_kl, vocab_parallel_nll


def _denom(mask: torch.Tensor) -> torch.Tensor:
    return torch.clamp(mask.sum(), min=1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch; ``labels`` are int class ids, logits [..., V]."""
    return vocab_parallel_nll(logits, labels, None).mean()


def masked_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
    model_parallel: Optional[ModelParallel] = None,
) -> torch.Tensor:
    """Token-mean CE over the unmasked positions."""
    return (vocab_parallel_nll(logits, labels, model_parallel) * mask).sum() / _denom(mask)


def kd_kl(
    student_logits: torch.Tensor,
    teacher_logits: torch.Tensor,
    temperature: float,
    mask: Optional[torch.Tensor] = None,
    model_parallel: Optional[ModelParallel] = None,
) -> torch.Tensor:
    """T^2-scaled KL(softmax_T(teacher) || softmax_T(student))."""
    t = temperature
    kl = vocab_parallel_kd_kl(student_logits, teacher_logits, t, model_parallel)
    if mask is not None:
        return (t * t) * (kl * mask).sum() / _denom(mask)
    return (t * t) * kl.mean()


def distillation_loss(
    student_logits: torch.Tensor,
    teacher_logits: Optional[torch.Tensor],
    labels: torch.Tensor,
    spec: Optional[DistillSpec],
    mask: Optional[torch.Tensor] = None,
    model_parallel: Optional[ModelParallel] = None,
) -> torch.Tensor:
    """Combined KD loss; plain CE when distillation is off (spec or teacher
    None). No gradient reaches the teacher's logits. ``model_parallel``:
    vocab-split student logits and a mask (the sequence tasks')."""
    if model_parallel is not None and mask is None:
        raise ValueError("vocab-split logits take the masked sequence loss")
    ce = (
        masked_cross_entropy(student_logits, labels, mask, model_parallel)
        if mask is not None
        else cross_entropy(student_logits, labels)
    )
    if spec is None or teacher_logits is None:
        return ce
    kl = kd_kl(student_logits, teacher_logits.detach(), spec.temperature, mask, model_parallel)
    return (1.0 - spec.weight) * ce + spec.weight * kl


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).to(torch.float32).mean()


def perplexity_terms(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
    model_parallel: Optional[ModelParallel] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum NLL, token count): summed across batches, then exp(nll / count)."""
    return (vocab_parallel_nll(logits, labels, model_parallel) * mask).sum(), mask.sum()
