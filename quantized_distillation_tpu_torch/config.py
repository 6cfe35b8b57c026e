"""Configuration dataclasses of the PyTorch port.

Own copies of the JAX package's ``config.py`` classes that the serving and
training slices need (that module imports jax through ``ops``, so nothing
is shared).
Field names and defaults are the same, so a caller can build either
package's config from the same keywords.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

from .ops.bucketing import DEFAULT_BUCKET_SIZE, LINEAR


@dataclass(frozen=True)
class QuantSpec:
    """How to quantize weights: grid bits, bucket size, bucket scaling,
    stochastic rounding, and parameter-path substrings kept at full
    precision."""

    bits: int = 4
    bucket_size: int = DEFAULT_BUCKET_SIZE
    scaling: str = LINEAR
    stochastic: bool = False
    method: str = "uniform"
    exclude_substrings: Tuple[str, ...] = ("bias", "bn", "batch_stats", "scale_param")

    def excludes(self, path: str) -> bool:
        return any(s in path for s in self.exclude_substrings)

    def replace(self, **kw) -> "QuantSpec":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class DistillSpec:
    """Knowledge-distillation loss: ``(1 - weight) * CE(student, labels) +
    weight * T^2 * KL(softmax_T(teacher) || softmax_T(student))``."""

    weight: float = 0.7
    temperature: float = 5.0


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 128
    epochs: int = 10
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    clip_norm: Optional[float] = None  # global-norm clipping, as onmt/Optim.py
    optimizer: str = "adam"  # 'adam' | 'sgd' | 'momentum'
    lr_schedule: str = "constant"  # 'constant' | 'cosine' | 'step'
    lr_decay_rate: float = 0.5
    lr_decay_every: int = 0  # steps; 0 = once per epoch
    warmup_steps: int = 0
    seed: int = 0
    quant: Optional[QuantSpec] = None
    distill: Optional[DistillSpec] = None
    log_every: int = 50
    eval_every: int = 0  # steps; 0 = per epoch


@dataclass(frozen=True)
class BeamConfig:
    """Beam-search decoding configuration (GNMT length penalty ``alpha``,
    coverage penalty ``beta``, n-best list size)."""

    beam_size: int = 5
    max_len: int = 100
    length_penalty: float = 0.0
    coverage_penalty: float = 0.0
    n_best: int = 1


@dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    model: int = 1
    axis_names: Tuple[str, str] = ("data", "model")


@dataclass(frozen=True)
class ServeConfig:
    """Configuration of the continuous-batching engine
    (``serve.engine.TranslationEngine``): slot grid, source and target
    lengths, beam, admission width, chunk lengths and staging depth; the
    fields mirror the JAX package's. ``mesh`` is kept for the JAX package's
    field list; the engine takes its mesh as an argument
    (``TranslationEngine(mesh=...)``), as the JAX package's does."""

    max_slots: int = 64
    max_src_len: int = 64
    max_tgt_len: int = 100
    beam: BeamConfig = field(default_factory=BeamConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    admit_batch: int = 8
    chunk_steps: int = 1
    chunk_steps_busy: int | None = None
    stage_ahead: int = 0
