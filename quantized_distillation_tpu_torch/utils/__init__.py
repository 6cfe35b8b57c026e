"""Utilities of the PyTorch port: metrics logging (``utils.metrics``) and
device timing on the card (``utils.timing``). BLEU scoring, artifacts and
profiling helpers come with later slices."""
