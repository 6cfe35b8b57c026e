"""Counterparts of the JAX package's scripts ``scripts/comm_budget.py``,
``scripts/multihost_smoke.py``, ``scripts/accuracy_grid.py`` and
``scripts/topk_divergence.py``, and ``grid_spread`` (the CNN grid run
several times, the train step graphed and eager in turns), run as
``python -m quantized_distillation_tpu_torch.scripts.<name>``."""
