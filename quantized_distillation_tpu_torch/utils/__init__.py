"""Utilities of the PyTorch port: metrics logging (``utils.metrics``).
BLEU scoring, artifacts and profiling helpers come with later slices."""
