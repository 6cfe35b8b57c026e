"""The port's language-model data pipeline (``data/lm.py``) against the JAX
package's on the same seeds and files: the same token streams (int32, bit
for bit), vocabularies and contiguous-BPTT windows."""

import numpy as np
import pytest
import torch

from quantized_distillation_tpu import data as jdata
from quantized_distillation_tpu_torch import data as pdata

torch.set_num_threads(2)


def _same_array(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _same_corpus(a, b):
    _same_array(a.tokens, b.tokens)
    assert a.vocab.itos == b.vocab.itos and a.source == b.source


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("vocab_size,branching", [(40, 4), (300, 3)])
def test_synthetic_corpus_matches(seed, vocab_size, branching):
    a = pdata.synthetic_lm_corpus(1500, vocab_size, branching, seed=seed)
    b = jdata.synthetic_lm_corpus(1500, vocab_size, branching, seed=seed)
    assert a.tokens.dtype == np.int32 and a.source == "synthetic"
    _same_corpus(a, b)


def test_two_seeds_one_language():
    """The transition structure depends on the vocabulary size and
    branching only: two seeds give different streams of one language."""
    a, b = (pdata.synthetic_lm_corpus(4000, 30, 3, seed=s) for s in (0, 7))
    assert a.vocab.itos == b.vocab.itos
    assert not np.array_equal(a.tokens, b.tokens)
    successors = {}
    for stream in (a.tokens, b.tokens):
        for prev, nxt in zip(stream[:-1], stream[1:]):
            successors.setdefault(int(prev), set()).add(int(nxt))
    assert max(len(s) for s in successors.values()) == 3


@pytest.fixture
def token_files(tmp_path):
    rng = np.random.default_rng(0)
    words = [f"tok{i}" for i in range(25)]
    paths = []
    for name, n in (("train.txt", 40), ("valid.txt", 12)):
        lines = [" ".join(rng.choice(words, rng.integers(1, 9))) for _ in range(n)]
        lines.insert(3, "   ")  # a blank line is skipped
        (tmp_path / name).write_text("\n".join(lines) + "\n")
        paths.append(str(tmp_path / name))
    return paths


def test_load_token_file_builds_its_vocab(token_files):
    a = pdata.load_token_file(token_files[0])
    b = jdata.load_token_file(token_files[0])
    assert a.source == "disk"
    _same_corpus(a, b)
    small_a = pdata.load_token_file(token_files[0], max_vocab=12)
    small_b = jdata.load_token_file(token_files[0], max_vocab=12)
    _same_corpus(small_a, small_b)
    assert (small_a.tokens == 3).any()  # words past the cap map to <unk>


def test_load_token_file_with_a_given_vocab(token_files):
    vocab = pdata.load_token_file(token_files[0], max_vocab=15).vocab
    jvocab = jdata.load_token_file(token_files[0], max_vocab=15).vocab
    a = pdata.load_token_file(token_files[1], vocab=vocab)
    b = jdata.load_token_file(token_files[1], vocab=jvocab)
    assert a.vocab is vocab
    _same_corpus(a, b)


@pytest.mark.parametrize("n_tokens,batch_size,bptt", [(500, 4, 7), (353, 5, 35), (97, 8, 12)])
def test_lm_batches_every_window(n_tokens, batch_size, bptt):
    a = pdata.synthetic_lm_corpus(n_tokens, 50, seed=2)
    b = jdata.synthetic_lm_corpus(n_tokens, 50, seed=2)
    wa = list(pdata.lm_batches(a, batch_size, bptt))
    wb = list(jdata.lm_batches(b, batch_size, bptt))
    lane = (n_tokens - 1) // batch_size
    assert len(wa) == len(wb) == len(range(0, lane - bptt + 1, bptt))
    for x, y in zip(wa, wb):
        assert sorted(x) == sorted(y) == ["input", "target"]
        _same_array(x["input"], y["input"])
        _same_array(x["target"], y["target"])
        assert x["input"].shape == (batch_size, bptt)
    if len(wa) > 1:  # window k's lanes continue window k-1's
        np.testing.assert_array_equal(wa[1]["input"][:, 0], wa[0]["target"][:, -1])


def test_lm_batches_corpus_too_small():
    tiny = pdata.LMCorpus(np.arange(3, dtype=np.int32), pdata.Vocab(["<pad>"]))
    with pytest.raises(ValueError, match="too small"):
        next(pdata.lm_batches(tiny, 4))
