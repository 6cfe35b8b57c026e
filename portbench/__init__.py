"""The benchmark of the PyTorch and CUDA port
(``quantized_distillation_tpu_torch``): one cell is one model configuration
under one traffic mix, named in ``BENCHMARK.json`` at the repository root.
Run a cell with ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``; ``README.md`` beside this file says how to
add configurations, mixes, cells and metrics."""
