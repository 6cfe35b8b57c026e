"""Data pipelines of the PyTorch port: NMT parallel corpora (vocab, toy
corpus, bucketed padded batches as numpy arrays) and raw-text
preprocessing (Moses-style tokenization, BPE, savable pipelines). The
vision and LM loaders come with later slices."""

from .text import (
    BPECodec,
    TextPipeline,
    bpe_join,
    learn_bpe,
    moses_detokenize,
    moses_tokenize,
)
from .translation import (
    BOS,
    EOS,
    PAD,
    UNK,
    ParallelCorpus,
    Vocab,
    build_vocab,
    load_parallel_files,
    load_raw_parallel,
    nmt_batches,
    toy_corpus,
)

__all__ = [
    "BOS",
    "EOS",
    "PAD",
    "UNK",
    "ParallelCorpus",
    "Vocab",
    "build_vocab",
    "load_parallel_files",
    "load_raw_parallel",
    "nmt_batches",
    "toy_corpus",
    "BPECodec",
    "TextPipeline",
    "bpe_join",
    "learn_bpe",
    "moses_detokenize",
    "moses_tokenize",
]
