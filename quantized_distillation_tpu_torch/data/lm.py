"""Language-model data pipeline: token streams, contiguous-BPTT batches (the
port's own copy of the JAX package's ``data/lm.py``; the same seeds and
files give the same streams and windows).

Companion to ``models/lm.py`` for the Penn-Treebank-style word-level LM
experiments. The pipeline is source-agnostic, mirroring
``data/translation.py``:

1. Real corpora: a whitespace-tokenized text file (PTB convention: one
   sentence per line, ``<eos>`` appended per line) via :func:`load_token_file`.
2. A deterministic *synthetic language* via :func:`synthetic_lm_corpus`: a
   sparse-support first-order Markov chain with skewed transition
   probabilities. It has low-but-nonzero entropy, so perplexity meaningfully
   decreases with model quality and the full distill→quantize→eval loop is
   exercised end to end.

Batching is the standard contiguous/truncated-BPTT layout: the token stream
is split into ``batch_size`` parallel contiguous lanes; each yielded window
is ``{"input": [B, T], "target": [B, T]}`` with targets shifted by one, and
consecutive windows continue each lane so an LSTM carry threaded across
windows sees an unbroken stream. Every window has the static shape
``[B, bptt]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from .translation import SPECIALS, Vocab, build_vocab


@dataclass
class LMCorpus:
    tokens: np.ndarray  # 1-D int32 token-id stream
    vocab: Vocab
    source: str = "synthetic"


def load_token_file(
    path: str, vocab: Optional[Vocab] = None, max_vocab: int = 50000
) -> LMCorpus:
    """Whitespace-tokenized text file → flat id stream (PTB: ``<eos>`` per line)."""
    with open(path) as f:
        lines = [l.split() + ["</s>"] for l in f if l.strip()]
    if vocab is None:
        vocab = build_vocab(lines, max_vocab)
    stream = np.asarray(
        [i for line in lines for i in vocab.encode(line)], np.int32
    )
    return LMCorpus(stream, vocab, source="disk")


def synthetic_lm_corpus(
    n_tokens: int = 100_000,
    vocab_size: int = 128,
    branching: int = 4,
    seed: int = 0,
) -> LMCorpus:
    """Sparse Markov-chain language (see module docstring).

    Each word can be followed by only ``branching`` successors, with a skewed
    (geometric-ish) distribution over them. The transition structure depends
    only on ``vocab_size``/``branching`` — NOT on ``seed`` — so train and
    valid streams drawn with different seeds describe the same language.
    """
    n_words = vocab_size - len(SPECIALS)
    struct_rng = np.random.default_rng(1000 + vocab_size * 13 + branching)
    successors = np.stack(
        [struct_rng.permutation(n_words)[:branching] for _ in range(n_words)]
    )  # [n_words, branching]
    probs = 0.55 ** np.arange(branching, dtype=np.float64)  # geometric skew
    probs = probs / probs.sum()

    rng = np.random.default_rng(seed)
    state = int(rng.integers(0, n_words))
    picks = rng.choice(branching, size=n_tokens, p=probs)
    out = np.empty(n_tokens, np.int64)
    for i in range(n_tokens):
        state = int(successors[state, picks[i]])
        out[i] = state
    vocab = Vocab(SPECIALS + [f"w{i}" for i in range(n_words)])
    return LMCorpus((out + len(SPECIALS)).astype(np.int32), vocab)


def lm_batches(
    corpus: LMCorpus, batch_size: int, bptt: int = 35
) -> Iterator[dict]:
    """Contiguous-BPTT windows over ``batch_size`` parallel lanes.

    Yields ``{"input": [B, bptt], "target": [B, bptt]}`` int32; window ``k``'s
    lanes continue window ``k-1``'s (thread the LSTM carry across windows for
    the standard PTB recipe). The stream tail that doesn't fill a full
    ``[B, bptt]`` window is dropped, as in the usual PTB batcher.
    """
    stream = corpus.tokens
    n = (len(stream) - 1) // batch_size  # tokens per lane
    if n < 1:
        raise ValueError("corpus too small for batch_size")
    inputs = stream[: batch_size * n].reshape(batch_size, n)
    targets = stream[1 : batch_size * n + 1].reshape(batch_size, n)
    for start in range(0, n - bptt + 1, bptt):
        yield {
            "input": inputs[:, start : start + bptt],
            "target": targets[:, start : start + bptt],
        }
