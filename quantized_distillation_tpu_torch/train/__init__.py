"""Training (PyTorch port of the JAX package's ``train/``): the KD trainer
with STE fake-quant weights or learned codebooks, its losses, the vision,
NMT and LM tasks, the loops and automatic bit assignment.

Ported for every model family (seq2seq, CNN, WideResNet, ResNet, LSTM LM):
modes ``weights`` (quantized distillation), ``codebooks`` and ``joint``
(differentiable quantization), the BatchNorm running statistics and the
truncated-BPTT carry of the train state, ``bits.py``, the experiment
manager (checkpoints and a run registry), and data- and tensor-parallel
training over ``torch.distributed`` (``make_train_step(mesh=,
grad_reduce_dtype=, param_specs=)``: the seq2seq and LM students on
``place_params_*`` shards).
"""

from . import bits, losses, manager, quantize_tree, tasks, trainer
from .bits import assign_bits, gradient_sensitivities
from .loops import evaluate, fit
from .losses import accuracy, cross_entropy, distillation_loss, kd_kl
from .manager import ExperimentManager
from .tasks import lm_initial_carry, lm_task, nmt_task, vision_task
from .trainer import (
    Task,
    TrainState,
    build_optimizer,
    create_train_state,
    make_eval_step,
    make_train_step,
    preferred_grad_reduce_dtype,
)

__all__ = [
    "bits",
    "assign_bits",
    "gradient_sensitivities",
    "losses",
    "manager",
    "ExperimentManager",
    "evaluate",
    "fit",
    "quantize_tree",
    "tasks",
    "trainer",
    "accuracy",
    "cross_entropy",
    "distillation_loss",
    "kd_kl",
    "lm_initial_carry",
    "lm_task",
    "nmt_task",
    "vision_task",
    "Task",
    "TrainState",
    "build_optimizer",
    "create_train_state",
    "make_eval_step",
    "make_train_step",
    "preferred_grad_reduce_dtype",
]
