"""The plain reference: plain PyTorch, float32 with TF32 off, written from
the published descriptions of the models, of bucketed quantization and of
distillation. It imports nothing of the system under test and takes
nothing the system made: the benchmark hands it the weights and inputs it
made itself."""
