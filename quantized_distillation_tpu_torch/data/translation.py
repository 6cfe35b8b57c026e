"""Translation data pipeline: vocab, bucketed padded batches, toy corpus
(the port's own copy of the JAX package's ``data/translation.py``, which
imports no JAX but is not shared; the same seeds give the same corpora and
batches).

WMT13 de-en preprocessing, vocab build, length-bucketed padded batches. The
pipeline downloads nothing and reads any source:

1. Real corpora: any pair of pre-tokenized parallel text files on disk
   (one sentence per line, whitespace tokens — the format the reference's
   preprocessing emits) via :func:`load_parallel_files`, or RAW text via
   :func:`load_raw_parallel` (Moses-style tokenization + optional learned
   BPE from :mod:`.text` — the reference's WMT13 preprocessing fidelity).
2. A deterministic *toy translation task* via :func:`toy_corpus` — the
   "translation" reverses the source sentence and maps tokens through a fixed
   bijection. It has real source→target structure (attention must learn the
   reversal alignment), so BLEU on it meaningfully tracks model quality and
   exercises the full train→beam-decode→BLEU path end-to-end.

Batches are padded to a small ladder of bucket lengths (8, 16, 32, 64), so
a model sees few distinct shapes (each shape is one CUDA-graph capture of
the beam search on the card).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

PAD, BOS, EOS, UNK = 0, 1, 2, 3
SPECIALS = ["<pad>", "<s>", "</s>", "<unk>"]


@dataclass
class Vocab:
    itos: List[str]
    stoi: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if not self.stoi:
            self.stoi = {w: i for i, w in enumerate(self.itos)}

    def __len__(self):
        return len(self.itos)

    def encode(self, tokens: Sequence[str]) -> List[int]:
        return [self.stoi.get(t, UNK) for t in tokens]

    def decode(self, ids: Sequence[int]) -> List[str]:
        return [
            self.itos[i]
            for i in ids
            if i not in (PAD, BOS, EOS) and 0 <= i < len(self.itos)
        ]

    def save(self, path: str) -> None:
        """One token per line (tokens never contain whitespace)."""
        with open(path, "w") as f:
            for w in self.itos:
                f.write(w + "\n")

    @classmethod
    def load(cls, path: str) -> "Vocab":
        with open(path) as f:
            itos = [l.rstrip("\n") for l in f]
        if itos[: len(SPECIALS)] != SPECIALS:
            raise ValueError(f"{path} is not a saved vocab (bad specials row)")
        return cls(itos)


def build_vocab(sentences: Sequence[Sequence[str]], max_size: int = 50000, min_freq: int = 1) -> Vocab:
    """Frequency-sorted vocab with the onmt special tokens up front."""
    freqs: Dict[str, int] = {}
    for s in sentences:
        for t in s:
            freqs[t] = freqs.get(t, 0) + 1
    words = sorted(
        (w for w, f in freqs.items() if f >= min_freq),
        key=lambda w: (-freqs[w], w),
    )[: max_size - len(SPECIALS)]
    return Vocab(SPECIALS + words)


@dataclass
class ParallelCorpus:
    src: List[List[int]]  # token ids, no BOS/EOS
    tgt: List[List[int]]  # token ids, no BOS/EOS
    src_vocab: Vocab
    tgt_vocab: Vocab
    source: str = "toy"


def load_parallel_files(
    src_path: str,
    tgt_path: str,
    src_vocab: Optional[Vocab] = None,
    tgt_vocab: Optional[Vocab] = None,
    max_len: int = 64,
    max_vocab: int = 50000,
) -> ParallelCorpus:
    """Pre-tokenized parallel text files → corpus (reference: onmt preprocess)."""
    with open(src_path) as f:
        src_tok = [l.split() for l in f]
    with open(tgt_path) as f:
        tgt_tok = [l.split() for l in f]
    pairs = [
        (s, t)
        for s, t in zip(src_tok, tgt_tok)
        if 0 < len(s) <= max_len and 0 < len(t) <= max_len
    ]
    src_tok = [p[0] for p in pairs]
    tgt_tok = [p[1] for p in pairs]
    if src_vocab is None:
        src_vocab = build_vocab(src_tok, max_vocab)
    if tgt_vocab is None:
        tgt_vocab = build_vocab(tgt_tok, max_vocab)
    return ParallelCorpus(
        [src_vocab.encode(s) for s in src_tok],
        [tgt_vocab.encode(t) for t in tgt_tok],
        src_vocab,
        tgt_vocab,
        source="disk",
    )


def load_raw_parallel(
    src_path: str,
    tgt_path: str,
    *,
    src_pipe: Optional["TextPipeline"] = None,
    tgt_pipe: Optional["TextPipeline"] = None,
    src_lang: str = "de",
    tgt_lang: str = "en",
    bpe_merges: Optional[int] = None,
    lower: bool = False,
    src_vocab: Optional[Vocab] = None,
    tgt_vocab: Optional[Vocab] = None,
    max_len: int = 64,
    max_vocab: int = 50000,
):
    """RAW parallel text → (corpus, src_pipe, tgt_pipe).

    The reference's full WMT13 preprocessing path
    (``datasets/translation_datasets.py``): Moses-style tokenization, an
    optional learned BPE (``bpe_merges`` merge ops per side; ``None`` =
    word-level, the reference/paper setting), then vocab build + id encode.
    Pass the returned pipelines (and vocabs) back in for the test split and
    at serve time so preprocessing is identical everywhere.
    """
    from .text import TextPipeline, learn_bpe

    with open(src_path) as f:
        src_raw = [l.rstrip("\n") for l in f]
    with open(tgt_path) as f:
        tgt_raw = [l.rstrip("\n") for l in f]
    if src_pipe is None:
        src_pipe = TextPipeline(lang=src_lang, lower=lower)
    if tgt_pipe is None:
        tgt_pipe = TextPipeline(lang=tgt_lang, lower=lower)

    def _tok(pipe, lines):
        from .text import moses_tokenize

        return [
            moses_tokenize(l.lower() if pipe.lower else l, pipe.lang)
            for l in lines
        ]

    src_tok = _tok(src_pipe, src_raw)
    tgt_tok = _tok(tgt_pipe, tgt_raw)
    if bpe_merges and src_pipe.bpe is None:
        src_pipe.bpe = learn_bpe(src_tok, bpe_merges)
    if bpe_merges and tgt_pipe.bpe is None:
        tgt_pipe.bpe = learn_bpe(tgt_tok, bpe_merges)
    if src_pipe.bpe is not None:
        src_tok = [src_pipe.bpe.encode(s) for s in src_tok]
    if tgt_pipe.bpe is not None:
        tgt_tok = [tgt_pipe.bpe.encode(t) for t in tgt_tok]
    pairs = [
        (s, t)
        for s, t in zip(src_tok, tgt_tok)
        if 0 < len(s) <= max_len and 0 < len(t) <= max_len
    ]
    src_tok = [p[0] for p in pairs]
    tgt_tok = [p[1] for p in pairs]
    if src_vocab is None:
        src_vocab = build_vocab(src_tok, max_vocab)
    if tgt_vocab is None:
        tgt_vocab = build_vocab(tgt_tok, max_vocab)
    corpus = ParallelCorpus(
        [src_vocab.encode(s) for s in src_tok],
        [tgt_vocab.encode(t) for t in tgt_tok],
        src_vocab,
        tgt_vocab,
        source="raw",
    )
    return corpus, src_pipe, tgt_pipe


def toy_corpus(
    n: int = 5000,
    vocab_size: int = 120,
    min_len: int = 3,
    max_len: int = 12,
    seed: int = 0,
    zipf: float = 0.0,
) -> ParallelCorpus:
    """Deterministic reversal+relabel translation task (see module docstring).

    ``zipf`` > 0 draws words from a power-law distribution (p ∝ rank^-zipf)
    instead of uniform — at large vocabularies this matches real text's
    head-heavy statistics, so a fixed-size corpus still teaches the model
    its frequent words (uniform draws at 32k vocab give every word ~n*8/32k
    occurrences and nothing is learnable).
    """
    rng = np.random.default_rng(seed)
    n_words = vocab_size - len(SPECIALS)
    src_vocab = Vocab(SPECIALS + [f"s{i}" for i in range(n_words)])
    tgt_vocab = Vocab(SPECIALS + [f"t{i}" for i in range(n_words)])
    # The bijection depends only on vocab_size, NOT on `seed`: train and test
    # splits drawn with different seeds must describe the same "language".
    perm = np.random.default_rng(vocab_size).permutation(n_words)
    probs = None
    if zipf > 0:
        probs = 1.0 / np.arange(1, n_words + 1) ** zipf
        probs /= probs.sum()
    src, tgt = [], []
    for _ in range(n):
        length = int(rng.integers(min_len, max_len + 1))
        if probs is None:
            words = rng.integers(0, n_words, length)
        else:
            words = rng.choice(n_words, size=length, p=probs)
        src.append([int(w) + len(SPECIALS) for w in words])
        tgt.append([int(perm[w]) + len(SPECIALS) for w in words[::-1]])
    return ParallelCorpus(src, tgt, src_vocab, tgt_vocab, source="toy")


def _bucket_len(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def nmt_batches(
    corpus: ParallelCorpus,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    src_buckets: Sequence[int] = (8, 16, 32, 64),
    tgt_buckets: Sequence[int] = (8, 16, 32, 64),
    drop_remainder: bool = False,
) -> Iterator[dict]:
    """Length-bucketed padded batches.

    Yields {'src' [B,Ts], 'src_len' [B], 'tgt_in' [B,Tt] (BOS + tgt),
    'tgt_out' [B,Tt] (tgt + EOS), 'tgt_mask' [B,Tt]} with Ts/Tt drawn from
    the static bucket ladder (few distinct shapes). Sentences are grouped
    by bucket (the reference's length-bucketed batching in onmt IO) to
    minimize padding waste.
    """
    rng = np.random.default_rng(seed)
    order = np.arange(len(corpus.src))
    if shuffle:
        rng.shuffle(order)
    # group indices by (src_bucket, tgt_bucket)
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i in order:
        s, t = corpus.src[i], corpus.tgt[i]
        key = (
            _bucket_len(len(s), src_buckets),
            _bucket_len(len(t) + 1, tgt_buckets),  # +1 for BOS/EOS shift
        )
        groups.setdefault(key, []).append(int(i))
    keys = sorted(groups)
    if shuffle:
        rng.shuffle(keys)
    for key in keys:
        idxs = groups[key]
        ts, tt = key
        for start in range(0, len(idxs), batch_size):
            take = idxs[start : start + batch_size]
            if drop_remainder and len(take) < batch_size:
                continue
            b = len(take)
            src = np.full((b, ts), PAD, np.int32)
            src_len = np.zeros(b, np.int32)
            tgt_in = np.full((b, tt), PAD, np.int32)
            tgt_out = np.full((b, tt), PAD, np.int32)
            mask = np.zeros((b, tt), np.float32)
            for j, i in enumerate(take):
                s = corpus.src[i][:ts]
                t = corpus.tgt[i][: tt - 1]
                src[j, : len(s)] = s
                src_len[j] = len(s)
                tgt_in[j, 0] = BOS
                tgt_in[j, 1 : len(t) + 1] = t
                tgt_out[j, : len(t)] = t
                tgt_out[j, len(t)] = EOS
                mask[j, : len(t) + 1] = 1.0
            yield {
                "src": src,
                "src_len": src_len,
                "tgt_in": tgt_in,
                "tgt_out": tgt_out,
                "tgt_mask": mask,
                # corpus row of each batch element — lets callers re-align
                # bucketed output with references (BLEU eval); not a model
                # input: strip it before a train or eval step.
                "index": np.asarray(take, np.int32),
            }
