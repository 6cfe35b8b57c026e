"""Training (PyTorch port of the JAX package's ``train/``): the KD trainer
with STE fake-quant weights, its losses, the NMT task and the loops.

Ported: mode ``weights`` (quantized distillation) for the seq2seq family.
Still to come: differentiable quantization (``codebooks``/``joint``,
``bits.py``), the experiment manager, the vision and LM tasks, and
multi-GPU training.
"""

from . import losses, quantize_tree, tasks, trainer
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
