"""Example drivers of the PyTorch port, run as modules, e.g.
``python -m quantized_distillation_tpu_torch.examples.wmt_distill``."""
