"""Parallelism of the PyTorch port: the device mesh, the sharding rules and
placement, the collectives with their budget, and a launcher of rank
processes. One process per rank over ``torch.distributed`` (NCCL on
CUDA, gloo on the host), where the JAX package runs one controller over a
``jax.sharding.Mesh``. Tensor parallelism over ``model`` writes out
the collectives XLA inserts (:mod:`.tensor`)."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    data_sharding,
    make_mesh,
    mesh_from_config,
    replicated,
)
from .sharding import (
    batch_pspecs,
    place_batch,
    place_params_lm,
    place_params_seq2seq,
    place_replicated,
    placed_pspecs,
    replicated_pspecs,
    seq2seq_pspecs,
)
from .tensor import ModelParallel

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "data_sharding",
    "make_mesh",
    "mesh_from_config",
    "replicated",
    "batch_pspecs",
    "place_batch",
    "place_params_lm",
    "place_params_seq2seq",
    "place_replicated",
    "replicated_pspecs",
    "seq2seq_pspecs",
    "placed_pspecs",
    "ModelParallel",
]
