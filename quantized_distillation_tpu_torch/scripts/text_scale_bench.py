"""The raw-text pipeline at corpus scale (the PyTorch port's counterpart of
the JAX package's ``scripts/text_scale_bench.py``).

Generates a synthetic raw parallel corpus of ``--n`` sentence pairs (a
Zipf-distributed lexicon with punctuation, number and capitalisation
structure, so the Moses tokenizer and the BPE learner see realistic text;
the same bytes as the JAX script's for the same ``--seed``), then times
the user's path, ``data.translation.load_raw_parallel`` with learned BPE,
end to end, with a stage breakdown on the source side (read, Moses
tokenize, ``learn_bpe``, BPE encode) and the process's peak RSS. It answers
whether WMT13-size preprocessing (~4.5M pairs) is feasible on one host:
``learn_bpe`` is incremental (its cost scales with the unique words, not
the corpus), and ``wmt13_projection_s`` scales the measured time linearly.

Host only: no kernel, no device, no JAX.

    python -m quantized_distillation_tpu_torch.scripts.text_scale_bench --n 1000000

Prints the corpus size on stderr and, as the last line of stdout, one JSON
object with the JAX script's keys (its numbers unrounded). The corpus is
written under a temporary directory, removed at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import sys
import tempfile
import time

import numpy as np

from ..data.text import learn_bpe, moses_tokenize
from ..data.translation import load_raw_parallel

LEXICON = 30000  # word types a side (WMT13-like vocabulary scale before BPE)


def synth_corpus(path_src: str, path_tgt: str, n: int, seed: int) -> None:
    """``n`` pairs of Zipf-word synthetic raw text with punctuation and
    numbers, one sentence a line (the JAX script's draws, in its order)."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))

    def lexicon(m):
        return np.array(["".join(rng.choice(letters, length))
                         for length in rng.integers(2, 12, m)])

    lex_s, lex_t = lexicon(LEXICON), lexicon(LEXICON)
    zipf_p = 1.0 / np.arange(1, LEXICON + 1)
    zipf_p /= zipf_p.sum()
    with open(path_src, "w") as fs, open(path_tgt, "w") as ft:
        for _ in range(n):
            ln = int(rng.integers(5, 30))
            for lex, f in ((lex_s, fs), (lex_t, ft)):
                ws = list(lex[rng.choice(LEXICON, ln, p=zipf_p)])
                if rng.random() < 0.15:
                    ws.insert(int(rng.integers(0, len(ws))), str(rng.integers(1, 5000)))
                if rng.random() < 0.1:
                    ws[-1] = ws[-1] + ","
                end = "?" if rng.random() < 0.05 else "."
                f.write(" ".join(ws).capitalize() + end + "\n")


def measure(ps: str, pt: str, merges: int) -> dict:
    """The source side's stages, then ``load_raw_parallel`` on both sides →
    the timings and counts."""
    t0 = time.perf_counter()
    with open(ps) as f:
        lines = [line.rstrip("\n") for line in f]
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    tok = [moses_tokenize(line, "de") for line in lines]
    t_tok = time.perf_counter() - t0
    t0 = time.perf_counter()
    bpe = learn_bpe(tok, merges)
    t_learn = time.perf_counter() - t0
    t0 = time.perf_counter()
    for s in tok:
        bpe.encode(s)
    t_enc = time.perf_counter() - t0
    n_tokens = sum(len(s) for s in tok)
    del lines, tok
    # the user's path, end to end: tokenize, learn BPE, encode, build the
    # vocabularies and encode ids, both sides
    t0 = time.perf_counter()
    corpus, _, _ = load_raw_parallel(ps, pt, bpe_merges=merges, max_len=64)
    t_e2e = time.perf_counter() - t0
    return {"src_tokens": n_tokens, "read": t_read, "moses_tokenize": t_tok,
            "learn_bpe": t_learn, "bpe_encode": t_enc, "e2e": t_e2e,
            "pairs_kept": len(corpus.src)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--merges", type=int, default=10000)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    d = tempfile.mkdtemp(prefix="qdt_textbench_")
    try:
        ps, pt = os.path.join(d, "train.src"), os.path.join(d, "train.tgt")
        t0 = time.perf_counter()
        synth_corpus(ps, pt, args.n, args.seed)
        t_gen = time.perf_counter() - t0
        size_mb = (os.path.getsize(ps) + os.path.getsize(pt)) / 1e6
        print(f"corpus: {args.n} pairs, {size_mb:.0f}MB raw, generated in {t_gen:.0f}s",
              file=sys.stderr, flush=True)
        m = measure(ps, pt, args.merges)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6  # KiB on Linux
    out = {
        "pairs": args.n,
        "raw_mb": size_mb,
        "src_tokens": m["src_tokens"],
        "bpe_merges": args.merges,
        "stage_s": {k: m[k] for k in ("read", "moses_tokenize", "learn_bpe", "bpe_encode")},
        "load_raw_parallel_e2e_s": m["e2e"],
        "peak_rss_gb": rss_gb,
        "corpus_pairs_kept": m["pairs_kept"],
        "wmt13_projection_s": m["e2e"] * 4.5e6 / args.n,
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
