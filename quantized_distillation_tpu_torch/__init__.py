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
with a hand-written CUDA fake-quant kernel (``kernels/``).
"""

from .config import BeamConfig, DistillSpec, QuantSpec, ServeConfig, TrainConfig

__all__ = ["BeamConfig", "DistillSpec", "QuantSpec", "ServeConfig", "TrainConfig"]
