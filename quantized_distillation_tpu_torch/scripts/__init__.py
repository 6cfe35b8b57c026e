"""Counterparts of the JAX package's scripts ``scripts/comm_budget.py``,
``scripts/multihost_smoke.py``, ``scripts/accuracy_grid.py`` and
``scripts/topk_divergence.py``, run as ``python -m
quantized_distillation_tpu_torch.scripts.<name>``."""
