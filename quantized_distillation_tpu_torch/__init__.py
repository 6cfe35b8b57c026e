"""PyTorch + CUDA port of quantized_distillation_tpu, for NVIDIA Hopper.

A package of its own beside the JAX one: it imports torch and numpy, never
jax, flax or the JAX package. Module names mirror the JAX package's. Every
entry point takes ``device`` (default ``"cuda"``) and raises when that device
is missing; the CPU runs only when the caller passes ``device="cpu"``, and
then every kernel wrapper runs its plain PyTorch version.

Ported so far: the packed beam-search serving path of the seq2seq student
(``serve.infer.pack_decoder`` → ``encode_packed`` → ``beam_search_packed``)
with hand-written CUDA kernels for its three TPU kernels, the
continuous-batching engine over it (``serve.engine.TranslationEngine``),
the coverage penalty and per-hypothesis attention on every beam path, and
4-bit STE and learned-codebook knowledge-distillation training of it
(``train/``: ``nmt_task`` → ``create_train_state`` → ``make_train_step``)
with a hand-written CUDA fake-quant kernel (``kernels/``), and the same
training of the other model families with their tasks: the CIFAR CNN, the
WideResNet and the ImageNet ResNets (``vision_task``, with BatchNorm
running statistics in the train state) and the LSTM language model
(``lm_task``, with the truncated-BPTT carry threaded across steps). On
more than one device (``parallel/``, one process per rank over
``torch.distributed``): serving sharded over a mesh (slots over ``data``,
the generator's vocab over ``model``) and data-parallel training.
"""

from .config import BeamConfig, DistillSpec, QuantSpec, ServeConfig, TrainConfig
from .models import make_cnn, make_lm, make_resnet, make_seq2seq, make_wrn
from .train import lm_initial_carry, lm_task, nmt_task, vision_task

__all__ = [
    "BeamConfig",
    "DistillSpec",
    "QuantSpec",
    "ServeConfig",
    "TrainConfig",
    "lm_initial_carry",
    "lm_task",
    "make_cnn",
    "make_lm",
    "make_resnet",
    "make_seq2seq",
    "make_wrn",
    "nmt_task",
    "vision_task",
]
