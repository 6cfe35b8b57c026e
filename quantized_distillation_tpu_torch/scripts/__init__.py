"""Counterparts of the JAX package's ``scripts/comm_budget.py`` and
``scripts/multihost_smoke.py``, run as ``python -m
quantized_distillation_tpu_torch.scripts.<name>``."""
