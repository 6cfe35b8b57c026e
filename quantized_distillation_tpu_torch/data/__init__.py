"""Data pipelines of the PyTorch port, host-side numpy like the JAX
package's and equal to them array for array: CIFAR-10/100 and
downsampled-ImageNet images (pickle archives, npy packs or synthetic
stand-ins; crop/flip augmentation, epoch batches), language-model token
streams with contiguous-BPTT windows, NMT parallel corpora (vocab, toy
corpus, bucketed padded batches) and raw-text preprocessing (Moses-style
tokenization, BPE, savable pipelines)."""

from .cifar import ImageDataset, augment, batches, load_cifar
from .imagenet import load_imagenet
from .lm import LMCorpus, lm_batches, load_token_file, synthetic_lm_corpus
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
    "ImageDataset",
    "augment",
    "batches",
    "load_cifar",
    "load_imagenet",
    "LMCorpus",
    "lm_batches",
    "load_token_file",
    "synthetic_lm_corpus",
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
