"""Task bindings (PyTorch port of the JAX package's ``train/tasks.py``):
NMT sequence training with word-level distillation.

Batch format (numpy arrays or tensors):
  nmt: {"src": [B,Ts] int, "src_len": [B] int,
        "tgt_in": [B,Tt] int (BOS-shifted), "tgt_out": [B,Tt] int,
        "tgt_mask": [B,Tt] float}

``vision_task`` and ``lm_task`` come with their model families.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from .losses import distillation_loss, perplexity_terms
from .trainer import Task


def nmt_task(student_model, teacher_model=None, *, device="cuda") -> Task:
    """Seq2seq training with word-level (per time step) distillation.

    The student runs on the weights the trainer hands it
    (:meth:`..models.seq2seq.Seq2Seq.forward_with`); the teacher runs on its
    own weights under ``torch.no_grad()`` on the same teacher-forced batch.
    The KD term is the per-step KL between the two next-token
    distributions, masked by target padding. Both models must be on
    ``device``."""
    dev = resolve_device(device)
    for m in (student_model, teacher_model):
        if m is not None and m.device != dev:
            raise ValueError(f"model is on {m.device}, not {dev}")

    def student_forward(params, batch, train, generator):
        logits = student_model.forward_with(
            params, batch["src"], batch["src_len"], batch["tgt_in"],
            train=train, generator=generator,
        )
        return logits, {}

    teacher_forward = None
    if teacher_model is not None:

        def teacher_forward(batch):
            with torch.no_grad():
                return teacher_model(batch["src"], batch["src_len"], batch["tgt_in"])

    def loss_and_metrics(logits, teacher_logits, batch, distill):
        mask = batch["tgt_mask"]
        loss = distillation_loss(logits, teacher_logits, batch["tgt_out"], distill, mask)
        nll_sum, n_tok = perplexity_terms(logits.detach(), batch["tgt_out"], mask)
        return loss, {"nll_sum": nll_sum, "n_tokens": n_tok}

    return Task(student_forward, loss_and_metrics, teacher_forward)
