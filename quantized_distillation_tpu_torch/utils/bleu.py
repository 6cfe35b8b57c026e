"""Corpus BLEU (multi-bleu.perl semantics) and detokenized BLEU (mteval-13a)
(the port's own copy of the JAX package's ``utils/bleu.py``, which imports
no JAX but is not shared).

Modified n-gram precision up to 4-grams with the brevity penalty, corpus
level, over tokenized hypotheses and references. :func:`detok_bleu` scores
detokenized strings after applying the mteval-v13a tokenization to both
sides (sacrebleu's default, the WMT-comparable number), so the score does
not depend on the model's own tokenization or BPE. Host-side Python.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import List, Sequence, Tuple


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(
    hypotheses: Sequence[Sequence[str]],
    references: Sequence[Sequence[str]],
    max_n: int = 4,
) -> float:
    """BLEU in [0, 100], multi-bleu style (single reference per sentence)."""
    if len(hypotheses) != len(references):
        raise ValueError("hypothesis/reference count mismatch")
    matches = [0] * max_n
    totals = [0] * max_n
    hyp_len = 0
    ref_len = 0
    for hyp, ref in zip(hypotheses, references):
        hyp_len += len(hyp)
        ref_len += len(ref)
        for n in range(1, max_n + 1):
            h = _ngrams(hyp, n)
            r = _ngrams(ref, n)
            totals[n - 1] += max(len(hyp) - n + 1, 0)
            matches[n - 1] += sum(min(c, r[g]) for g, c in h.items())
    if hyp_len == 0 or matches[0] == 0:
        return 0.0
    log_prec = 0.0
    for n in range(max_n):
        if totals[n] == 0 or matches[n] == 0:
            # multi-bleu returns 0 when any n-gram order has no matches
            return 0.0
        log_prec += math.log(matches[n] / totals[n])
    log_prec /= max_n
    bp = min(0.0, 1.0 - ref_len / hyp_len)
    return 100.0 * math.exp(bp + log_prec)


def tokenize_13a(line: str) -> List[str]:
    """mteval-v13a tokenization (sacrebleu "13a"): language-independent
    punctuation splitting applied to detokenized text before scoring."""
    t = line
    t = t.replace("<skipped>", "")
    t = t.replace("-\n", "").replace("\n", " ")
    t = t.replace("&quot;", '"').replace("&amp;", "&")
    t = t.replace("&lt;", "<").replace("&gt;", ">")
    t = f" {t} "
    t = re.sub(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])", r" \1 ", t)
    t = re.sub(r"([^0-9])([\.,])", r"\1 \2 ", t)  # . , not preceded by digit
    t = re.sub(r"([\.,])([^0-9])", r" \1 \2", t)  # . , not followed by digit
    t = re.sub(r"([0-9])(-)", r"\1 \2 ", t)
    return t.split()


def detok_bleu(
    hyp_lines: Sequence[str], ref_lines: Sequence[str], max_n: int = 4
) -> float:
    """Corpus BLEU over detokenized strings (mteval-13a semantics)."""
    return corpus_bleu(
        [tokenize_13a(h) for h in hyp_lines],
        [tokenize_13a(r) for r in ref_lines],
        max_n,
    )
