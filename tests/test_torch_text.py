"""The port's translation data, text preprocessing and BLEU against the JAX
package's on the same inputs and seeds: Moses-style tokenization and
detokenization, BPE learning, encoding and serialization, text pipelines,
vocabularies, the toy corpus, bucketed batches and BLEU. All host-side
Python, so every comparison is exact.

The JAX package's modules are imported inside a fixture (they load no JAX,
but the JAX package's ``data`` imports its vision loaders)."""

import types

import numpy as np
import pytest
import torch

from quantized_distillation_tpu_torch import data as pdata
from quantized_distillation_tpu_torch.utils import bleu as pbleu

torch.set_num_threads(2)

SENTS = [
    "Hello, world!",
    "pi is 3.14, not 1,000.",
    'He said "go home now" loudly.',
    "it's John's dog, isn't it?",
    "Mr. Smith met Dr. Jones (briefly).",
    "A state-of-the-art result: 95.8% BLEU!",
    "the U.S. economy",
    "“quoted” and ‘single’ — dash",
    "wait... what",
    "am 3. Tag kam die Katze, schnell!",
    "",
]


@pytest.fixture(scope="module")
def jx():
    from quantized_distillation_tpu import data
    from quantized_distillation_tpu.utils import bleu

    return types.SimpleNamespace(data=data, bleu=bleu)


def _synthetic_corpus(n=300, seed=0):
    """Raw-text sentence pairs from a small fake bilingual lexicon."""
    rng = np.random.default_rng(seed)
    src_words = ["katze", "hund", "haus", "wasser", "brot", "stadt", "nacht",
                 "morgen", "schnell", "langsam", "grosse", "kleine"]
    tgt_words = ["cat", "dog", "house", "water", "bread", "city", "night",
                 "morning", "quickly", "slowly", "large", "small"]
    src, tgt = [], []
    for _ in range(n):
        idx = rng.integers(0, len(src_words), rng.integers(3, 8))
        punct = "." if rng.random() < 0.7 else "!"
        src.append(" ".join(src_words[i] for i in idx).capitalize() + punct)
        tgt.append(" ".join(tgt_words[i] for i in idx).capitalize() + punct)
    return src, tgt


@pytest.mark.parametrize("lang", ["en", "de"])
@pytest.mark.parametrize("s", SENTS)
def test_moses_tokenize_and_detokenize_match_jax(jx, s, lang):
    toks = pdata.moses_tokenize(s, lang=lang)
    assert toks == jx.data.moses_tokenize(s, lang=lang)
    assert pdata.moses_detokenize(toks, lang=lang) == jx.data.moses_detokenize(toks, lang=lang)


@pytest.mark.parametrize("merges", [5, 40, 200])
def test_learn_bpe_and_encode_match_jax(jx, merges, tmp_path):
    src, _ = _synthetic_corpus()
    toks = [pdata.moses_tokenize(s) for s in src]
    mine, theirs = pdata.learn_bpe(toks, merges), jx.data.learn_bpe(toks, merges)
    assert mine.merges == theirs.merges
    for sent in toks[:50] + [["zzz", "unseen"]]:
        assert mine.encode(sent) == theirs.encode(sent)
        assert pdata.bpe_join(mine.encode(sent)) == jx.data.bpe_join(theirs.encode(sent))
    mine.save(str(tmp_path / "p.bpe"))
    theirs.save(str(tmp_path / "j.bpe"))
    assert (tmp_path / "p.bpe").read_bytes() == (tmp_path / "j.bpe").read_bytes()
    assert jx.data.BPECodec.load(str(tmp_path / "p.bpe")).merges == mine.merges


def test_text_pipeline_save_load_matches_jax(jx, tmp_path):
    src, _ = _synthetic_corpus()
    toks = [pdata.moses_tokenize(s) for s in src]
    pipe = pdata.TextPipeline(lang="de", bpe=pdata.learn_bpe(toks, 80))
    pipe.save(str(tmp_path / "port"), "src")
    jx.data.TextPipeline(lang="de", bpe=jx.data.learn_bpe(toks, 80)).save(
        str(tmp_path / "jax"), "src")
    for f in sorted((tmp_path / "jax").iterdir()):
        assert (tmp_path / "port" / f.name).read_bytes() == f.read_bytes(), f.name
    loaded = pdata.TextPipeline.load(str(tmp_path / "jax"), "src")
    for line in src[:20]:
        enc = loaded.encode_line(line)
        assert enc == pipe.encode_line(line)
        assert loaded.decode_tokens(enc) == line


def test_build_vocab_matches_jax(jx, tmp_path):
    src, tgt = _synthetic_corpus()
    sents = [pdata.moses_tokenize(s) for s in src + tgt]
    for max_size, min_freq in ((50000, 1), (10, 1), (50000, 40)):
        v = pdata.build_vocab(sents, max_size, min_freq)
        assert v.itos == jx.data.build_vocab(sents, max_size, min_freq).itos
    v.save(str(tmp_path / "v"))
    assert jx.data.Vocab.load(str(tmp_path / "v")).itos == v.itos
    assert v.encode(["cat", "zzz"]) == jx.data.Vocab(v.itos).encode(["cat", "zzz"])


@pytest.mark.parametrize("kw", [dict(n=300, vocab_size=40, seed=0),
                                dict(n=200, vocab_size=2000, seed=3, zipf=1.1),
                                dict(n=100, vocab_size=120, min_len=1, max_len=30, seed=991)])
def test_toy_corpus_and_nmt_batches_match_jax(jx, kw):
    mine, theirs = pdata.toy_corpus(**kw), jx.data.toy_corpus(**kw)
    assert (mine.src, mine.tgt) == (theirs.src, theirs.tgt)
    assert mine.src_vocab.itos == theirs.src_vocab.itos
    for opts in (dict(), dict(shuffle=False), dict(seed=5, drop_remainder=True)):
        got = list(pdata.nmt_batches(mine, 16, **opts))
        want = list(jx.data.nmt_batches(theirs, 16, **opts))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_load_raw_parallel_matches_jax(jx, tmp_path):
    src, tgt = _synthetic_corpus(300)
    paths = {}
    for name, lines in [("s", src), ("t", tgt)]:
        paths[name] = str(tmp_path / f"{name}.txt")
        open(paths[name], "w").write("\n".join(lines) + "\n")
    for bpe in (None, 60):
        mine, _, mt = pdata.load_raw_parallel(paths["s"], paths["t"], bpe_merges=bpe)
        theirs, _, jt = jx.data.load_raw_parallel(paths["s"], paths["t"], bpe_merges=bpe)
        assert (mine.src, mine.tgt, mine.source) == (theirs.src, theirs.tgt, theirs.source)
        assert mine.tgt_vocab.itos == theirs.tgt_vocab.itos
        assert mt.decode_tokens(mine.tgt_vocab.decode(mine.tgt[0])) == tgt[0]
    tok_s, tok_t = str(tmp_path / "ts.txt"), str(tmp_path / "tt.txt")
    open(tok_s, "w").write("a b c\nd e\n\nf g h i\n")
    open(tok_t, "w").write("x y\nz\nw\nv u\n")
    mine = pdata.load_parallel_files(tok_s, tok_t)
    theirs = jx.data.load_parallel_files(tok_s, tok_t)
    assert (mine.src, mine.tgt, mine.source) == (theirs.src, theirs.tgt, theirs.source)


def test_bleu_matches_jax(jx):
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(30)]
    refs = [list(rng.choice(words, rng.integers(3, 15))) for _ in range(40)]
    hyps = [[w if rng.random() < 0.7 else "x" for w in r][: max(1, len(r) - 1)] for r in refs]
    for max_n in (1, 2, 4):
        got = pbleu.corpus_bleu(hyps, refs, max_n)
        assert got == jx.bleu.corpus_bleu(hyps, refs, max_n) and got > 0
    assert pbleu.corpus_bleu(refs, refs) == pytest.approx(100.0)
    assert pbleu.corpus_bleu([["a"]], [["b"]]) == 0.0
    with pytest.raises(ValueError):
        pbleu.corpus_bleu([["a"]], [])
    lines = SENTS[:-1]
    for s in lines:
        assert pbleu.tokenize_13a(s) == jx.bleu.tokenize_13a(s)
    noisy = [s.replace(",", " ,").lower() for s in lines]
    assert pbleu.detok_bleu(noisy, lines) == jx.bleu.detok_bleu(noisy, lines)
    assert pbleu.detok_bleu(lines, lines) == pytest.approx(100.0)
