"""Utilities of the PyTorch port: metrics logging (``utils.metrics``),
device timing, roofline and tracing on the card (``utils.profiling``),
CUDA-graph capture (``utils.graphs``), spans and counters
(``utils.tracing``), numeric sanitizers
(``utils.debug``), BLEU scoring (``utils.bleu``) and the compressed
``.qdt`` artifact (``utils.artifact``)."""

from .bleu import corpus_bleu, detok_bleu, tokenize_13a

__all__ = ["corpus_bleu", "detok_bleu", "tokenize_13a"]
