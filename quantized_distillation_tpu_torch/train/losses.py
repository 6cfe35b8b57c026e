"""Classification and knowledge-distillation losses (PyTorch port of the
JAX package's ``train/losses.py``)::

  loss = (1 - w) * CE(student, labels)
       + w * T^2 * KL( softmax_T(teacher) || softmax_T(student) )

with temperature ``T`` and mixing weight ``w``; the NMT variant applies it
per time step under the target padding mask (word-level distillation).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import DistillSpec


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def _denom(mask: torch.Tensor) -> torch.Tensor:
    return torch.clamp(mask.sum(), min=1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch; ``labels`` are int class ids, logits [..., V]."""
    return _nll(logits, labels).mean()


def masked_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Token-mean CE over the unmasked positions."""
    return (_nll(logits, labels) * mask).sum() / _denom(mask)


def kd_kl(
    student_logits: torch.Tensor,
    teacher_logits: torch.Tensor,
    temperature: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """T^2-scaled KL(softmax_T(teacher) || softmax_T(student))."""
    t = temperature
    p_teacher = torch.softmax(teacher_logits / t, dim=-1)
    logp_teacher = torch.log_softmax(teacher_logits / t, dim=-1)
    logp_student = torch.log_softmax(student_logits / t, dim=-1)
    kl = (p_teacher * (logp_teacher - logp_student)).sum(dim=-1)
    if mask is not None:
        return (t * t) * (kl * mask).sum() / _denom(mask)
    return (t * t) * kl.mean()


def distillation_loss(
    student_logits: torch.Tensor,
    teacher_logits: Optional[torch.Tensor],
    labels: torch.Tensor,
    spec: Optional[DistillSpec],
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Combined KD loss; plain CE when distillation is off (spec or teacher
    None). No gradient reaches the teacher's logits."""
    ce = (
        masked_cross_entropy(student_logits, labels, mask)
        if mask is not None
        else cross_entropy(student_logits, labels)
    )
    if spec is None or teacher_logits is None:
        return ce
    kl = kd_kl(student_logits, teacher_logits.detach(), spec.temperature, mask)
    return (1.0 - spec.weight) * ce + spec.weight * kl


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).to(torch.float32).mean()


def perplexity_terms(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum NLL, token count): summed across batches, then exp(nll / count)."""
    return (_nll(logits, labels) * mask).sum(), mask.sum()
