"""Task bindings (PyTorch port of the JAX package's ``train/tasks.py``):
vision classification, NMT sequence training with word-level distillation,
and word-level language modelling with optional carry threading.

Batch format (numpy arrays or tensors), the JAX package's:
  vision: {"image": [B,H,W,C] float (NHWC), "label": [B] int}
  nmt: {"src": [B,Ts] int, "src_len": [B] int,
        "tgt_in": [B,Tt] int (BOS-shifted), "tgt_out": [B,Tt] int,
        "tgt_mask": [B,Tt] float}
  lm: {"input": [B,T] int, "target": [B,T] int}

Every student runs on the weights (and running statistics) the trainer
hands it (``forward_with``); every teacher on its own weights under
``torch.no_grad()``, in eval mode. All models must be on ``device``.

``nmt_task`` and ``lm_task`` also train one rank's shards of the student
(``model_parallel=``, see ``trainer.make_train_step(param_specs=)``): the
student runs its tensor-parallel forward (``forward_tp``), and where its
logits are this rank's vocab columns the losses and metrics take the
vocab-parallel path (``losses``, ``model_parallel=``); the teacher runs
whole on every rank and its logits are sliced there.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from .losses import accuracy, distillation_loss, perplexity_terms
from .trainer import Task


def _check_models(device, *models) -> None:
    dev = resolve_device(device)
    for m in models:
        if m is not None and m.device != dev:
            raise ValueError(f"model is on {m.device}, not {dev}")


def _nchw(image: torch.Tensor) -> torch.Tensor:
    """The NHWC batch as NCHW: a permuted view (channels-last in memory)."""
    return image.permute(0, 3, 1, 2)


def vision_task(student_model, teacher_model=None, *, device="cuda") -> Task:
    """CNN / WideResNet / ResNet classification with optional KD teacher.
    In training the student's BatchNorms normalize with the batch's
    statistics and return the new running statistics as
    ``updates["batch_stats"]``; in eval they read the ones handed in."""
    _check_models(device, student_model, teacher_model)

    def student_forward(variables, batch, train, generator):
        logits, stats = student_model.forward_with(
            variables, _nchw(batch["image"]), train=train, generator=generator)
        return logits, ({"batch_stats": stats} if train else {})

    teacher_forward = None
    if teacher_model is not None:

        def teacher_forward(batch):
            with torch.no_grad():
                return teacher_model(_nchw(batch["image"]))

    def loss_and_metrics(logits, teacher_logits, batch, distill):
        loss = distillation_loss(logits, teacher_logits, batch["label"], distill)
        return loss, {"accuracy": accuracy(logits.detach(), batch["label"])}

    return Task(student_forward, loss_and_metrics, teacher_forward)


def nmt_task(student_model, teacher_model=None, *, device="cuda") -> Task:
    """Seq2seq training with word-level (per time step) distillation.

    The student runs on the weights the trainer hands it
    (:meth:`..models.seq2seq.Seq2Seq.forward_with`); the teacher runs on its
    own weights under ``torch.no_grad()`` on the same teacher-forced batch.
    The KD term is the per-step KL between the two next-token
    distributions, masked by target padding. Both models must be on
    ``device``."""
    _check_models(device, student_model, teacher_model)

    def student_forward(params, batch, train, generator, model_parallel=None):
        args = (params, batch["src"], batch["src_len"], batch["tgt_in"])
        if model_parallel is not None:
            return student_model.forward_tp(*args, model_parallel=model_parallel, train=train,
                                            generator=generator), {}
        return student_model.forward_with(*args, train=train, generator=generator), {}

    teacher_forward = None
    if teacher_model is not None:

        def teacher_forward(batch):
            with torch.no_grad():
                return teacher_model(batch["src"], batch["src_len"], batch["tgt_in"])

    def loss_and_metrics(logits, teacher_logits, batch, distill, model_parallel=None):
        vp = model_parallel if student_model.logits_split(model_parallel) else None
        mask = batch["tgt_mask"]
        loss = distillation_loss(logits, teacher_logits, batch["tgt_out"], distill, mask, vp)
        nll_sum, n_tok = perplexity_terms(logits.detach(), batch["tgt_out"], mask, vp)
        return loss, {"nll_sum": nll_sum, "n_tokens": n_tok}

    return Task(student_forward, loss_and_metrics, teacher_forward, model_parallel=True)


def lm_task(student_model, teacher_model=None, *, thread_carry: bool = False,
            device="cuda") -> Task:
    """Word-level LM training with per-time-step distillation.

    ``thread_carry=False``: every window starts from a zero carry.
    ``thread_carry=True`` is the standard PTB recipe: the LSTM carry, the
    student's and the teacher's, continues across the contiguous-BPTT
    windows, cut from the graph at each window boundary. It rides the
    trainer's carry channel: seed ``TrainState.carry`` with
    :func:`lm_initial_carry`, and pass ``initial_carry=`` to
    :func:`.loops.evaluate` for threaded eval. The teacher then runs inside
    ``student_forward`` with its own carry (``teacher_forward`` has no state
    channel) and both logits travel together; in eval the teacher does not
    run and its carry passes through unchanged."""
    _check_models(device, student_model, teacher_model)

    def loss_and_metrics(logits, teacher_logits, batch, distill, model_parallel=None):
        vp = model_parallel if student_model.logits_split(model_parallel) else None
        if thread_carry:
            logits, teacher_logits = logits
        mask = torch.ones(batch["target"].shape, dtype=torch.float32,
                          device=batch["target"].device)
        loss = distillation_loss(logits, teacher_logits, batch["target"], distill, mask, vp)
        nll_sum, n_tok = perplexity_terms(logits.detach(), batch["target"], mask, vp)
        return loss, {"nll_sum": nll_sum, "n_tokens": n_tok}

    def run_student(params, tokens, carry, train, generator, model_parallel):
        if model_parallel is not None:
            return student_model.forward_tp(params, tokens, carry, model_parallel=model_parallel,
                                            train=train, generator=generator)
        return student_model.forward_with(params, tokens, carry, train=train, generator=generator)

    if thread_carry:

        def student_forward(params, batch, train, generator, model_parallel=None):
            carry = batch.get("carry")
            logits, new_s = run_student(
                params, batch["input"], None if carry is None else carry["student"],
                train, generator, model_parallel)
            t_logits, new_t = None, None if carry is None else carry["teacher"]
            if teacher_model is not None and train:
                with torch.no_grad():
                    t_logits, new_t = teacher_model(
                        batch["input"], None if carry is None else carry["teacher"])
            return (logits, t_logits), {"carry": {"student": new_s, "teacher": new_t}}

        return Task(student_forward, loss_and_metrics, None, model_parallel=True)

    def student_forward(params, batch, train, generator, model_parallel=None):
        logits, _ = run_student(params, batch["input"], None, train, generator, model_parallel)
        return logits, {}

    teacher_forward = None
    if teacher_model is not None:

        def teacher_forward(batch):
            with torch.no_grad():
                return teacher_model(batch["input"])[0]

    return Task(student_forward, loss_and_metrics, teacher_forward, model_parallel=True)


def lm_initial_carry(student_model, batch_size: int, teacher_model=None) -> dict:
    """Zero carry tree for a ``thread_carry`` LM task (train or eval)."""
    return {
        "student": student_model.initial_carry(batch_size),
        "teacher": teacher_model.initial_carry(batch_size) if teacher_model else None,
    }
