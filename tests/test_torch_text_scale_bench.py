"""The port's ``scripts/text_scale_bench.py`` against the JAX package's
script of that name (loaded by its path: it is not in a package) and the
JAX package's text pipeline, at 2,000 sentence pairs and 300 merges:

- the port's ``synth_corpus`` writes the JAX script's bytes for the same
  seed (and other bytes for another seed);
- over that corpus the port's ``learn_bpe`` learns the JAX package's
  merges in their order, and the port's ``load_raw_parallel`` gives its
  corpus: the same ids, vocabularies and BPE merges on both sides;
- the printed JSON has the JAX script's keys, nested keys included, and
  counts the same pairs, tokens and kept pairs.

The port's script imports no JAX; ``tests/test_torch_hygiene.py`` holds
that for every module of the port.
"""

import importlib.util
import json
import sys
from pathlib import Path

import pytest

from quantized_distillation_tpu_torch.data.text import learn_bpe, moses_tokenize
from quantized_distillation_tpu_torch.data.translation import load_raw_parallel
from quantized_distillation_tpu_torch.scripts import text_scale_bench

N, MERGES = 2000, 300
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location("jax_text_scale_bench",
                                                  ROOT / "scripts" / "text_scale_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpus(tmp_path_factory, jax_script):
    d = tmp_path_factory.mktemp("text_bench")
    paths = {}
    for who, fn in (("port", text_scale_bench.synth_corpus), ("jax", jax_script.synth_corpus)):
        paths[who] = (d / f"{who}.src", d / f"{who}.tgt")
        fn(str(paths[who][0]), str(paths[who][1]), N, 0)
    return paths


def test_synth_corpus_writes_the_jax_scripts_bytes(corpus, tmp_path):
    for port, jax in zip(corpus["port"], corpus["jax"]):
        assert port.read_bytes() == jax.read_bytes()
    src = corpus["port"][0].read_text().splitlines()
    assert len(src) == N and all(s[-1] in ".?" for s in src)
    other = (tmp_path / "o.src", tmp_path / "o.tgt")
    text_scale_bench.synth_corpus(str(other[0]), str(other[1]), 50, 1)
    assert other[0].read_text().splitlines() != src[:50]


def test_learn_bpe_learns_the_jax_merges(corpus):
    from quantized_distillation_tpu.data.text import learn_bpe as jlearn_bpe
    from quantized_distillation_tpu.data.text import moses_tokenize as jmoses_tokenize

    lines = corpus["port"][0].read_text().splitlines()
    tok = [moses_tokenize(line, "de") for line in lines]
    assert tok == [jmoses_tokenize(line, "de") for line in lines]
    merges = learn_bpe(tok, MERGES).merges
    assert len(merges) == MERGES
    assert merges == jlearn_bpe(tok, MERGES).merges


def test_load_raw_parallel_gives_the_jax_corpus(corpus):
    from quantized_distillation_tpu.data.translation import load_raw_parallel as jload

    ps, pt = (str(p) for p in corpus["port"])
    got, gsp, gtp = load_raw_parallel(ps, pt, bpe_merges=MERGES, max_len=64)
    want, wsp, wtp = jload(ps, pt, bpe_merges=MERGES, max_len=64)
    assert 0 < len(got.src) == len(want.src) <= N
    assert got.src == want.src and got.tgt == want.tgt
    assert got.src_vocab.itos == want.src_vocab.itos
    assert got.tgt_vocab.itos == want.tgt_vocab.itos
    assert gsp.bpe.merges == wsp.bpe.merges and gtp.bpe.merges == wtp.bpe.merges


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def _keys(d: dict) -> set:
    return {k if not isinstance(v, dict) else (k, frozenset(_keys(v))) for k, v in d.items()}


def test_printed_json_has_the_jax_scripts_keys(jax_script, capsys, monkeypatch):
    argv = ["--n", str(N), "--merges", str(MERGES), "--seed", "0"]
    assert text_scale_bench.main(argv) == 0
    got = _last_json(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["text_scale_bench.py", *argv])
    jax_script.main()
    want = _last_json(capsys.readouterr().out)
    assert _keys(got) == _keys(want)
    for k in ("pairs", "src_tokens", "bpe_merges", "corpus_pairs_kept"):
        assert got[k] == want[k], k
    assert got["raw_mb"] == pytest.approx(want["raw_mb"], abs=0.05)
    assert all(v >= 0 for v in got["stage_s"].values()) and got["peak_rss_gb"] > 0
