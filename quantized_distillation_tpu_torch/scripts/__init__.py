"""Counterparts of the JAX package's scripts ``scripts/comm_budget.py``,
``scripts/multihost_smoke.py``, ``scripts/accuracy_grid.py``,
``scripts/topk_divergence.py`` and ``scripts/text_scale_bench.py``, and
``grid_spread`` (the CNN grid run several times, the train step graphed
and eager in turns), run as
``python -m quantized_distillation_tpu_torch.scripts.<name>``."""

__all__ = ["accuracy_grid", "comm_budget", "grid_spread", "multihost_smoke",
           "text_scale_bench", "topk_divergence"]
