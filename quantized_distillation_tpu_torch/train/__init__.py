"""Training (PyTorch port of the JAX package's ``train/``): the KD trainer
with STE fake-quant weights or learned codebooks, its losses, the NMT task,
the loops and automatic bit assignment.

Ported for the seq2seq family: modes ``weights`` (quantized distillation),
``codebooks`` and ``joint`` (differentiable quantization), and ``bits.py``.
Still to come: the experiment manager, the vision and LM tasks, and
multi-GPU training.
"""

from . import bits, losses, quantize_tree, tasks, trainer
from .bits import assign_bits, gradient_sensitivities
from .loops import evaluate, fit
from .losses import accuracy, cross_entropy, distillation_loss, kd_kl
from .tasks import nmt_task
from .trainer import (
    Task,
    TrainState,
    build_optimizer,
    create_train_state,
    make_eval_step,
    make_train_step,
)

__all__ = [
    "bits",
    "assign_bits",
    "gradient_sensitivities",
    "losses",
    "evaluate",
    "fit",
    "quantize_tree",
    "tasks",
    "trainer",
    "accuracy",
    "cross_entropy",
    "distillation_loss",
    "kd_kl",
    "nmt_task",
    "Task",
    "TrainState",
    "build_optimizer",
    "create_train_state",
    "make_eval_step",
    "make_train_step",
]
