"""Raw-text preprocessing: Moses-style tokenizer/detokenizer + learnable BPE
(the port's own copy of the JAX package's ``data/text.py``, which imports
no JAX but is not shared; same rules, same outputs).

The WMT13 de-en workflow reads Moses-tokenized text and scores BLEU on the
decoded output. Everything here is host-side pure Python, run once per
corpus:

- :func:`moses_tokenize` / :func:`moses_detokenize` — Moses
  ``tokenizer.perl``-style rules: punctuation splitting with number/
  abbreviation protection, English apostrophe contractions ("it's" ->
  "it 's"), quote handling; the detokenizer inverts them.
- :func:`learn_bpe` / :class:`BPECodec` — Sennrich-style byte-pair encoding
  learned from a tokenized corpus (incremental pair-count updates), applied
  with the standard greedy lowest-rank merge loop and the ``@@`` continuation
  marker; round-trips exactly via :func:`bpe_join`. Codecs serialize to the
  subword-nmt text format so a training-time codec is reusable at serve time.
- :class:`TextPipeline` — tokenizer options + optional BPE codec as one
  savable unit: ``encode_line`` (raw string -> model tokens) and
  ``decode_tokens`` (model tokens -> detokenized string).
"""

from __future__ import annotations

import os
import re
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# ---------------------------------------------------------------------------
# Moses-style tokenizer
# ---------------------------------------------------------------------------

# Non-breaking prefixes: a token ending in "." stays fused when the stem is
# one of these (Moses ships per-language nonbreaking_prefixes files; this is
# the load-bearing English/German common subset).
_NONBREAKING = {
    "mr", "mrs", "ms", "dr", "prof", "rev", "hon", "st", "jr", "sr",
    "vs", "etc", "eg", "ie", "cf", "inc", "ltd", "co", "corp", "dept",
    "univ", "assn", "bros", "gen", "rep", "sen", "gov", "adm", "capt",
    "col", "sgt", "lt", "maj", "fig", "no", "nr", "art", "bzw", "ca",
    "usw", "zb", "dh", "vgl", "evtl", "ggf", "z.b", "u.a", "d.h", "e.g",
    "i.e", "a.m", "p.m", "u.s", "u.k",
}

_QUOTE_MAP = {
    "“": '"', "”": '"', "„": '"', "«": '"', "»": '"',
    "‘": "'", "’": "'", "‚": "'", "‹": "'", "›": "'",
    "–": "-", "—": "-",
}

# punctuation always split off (period/comma/apostrophe handled separately)
_SPLIT_PUNCT = re.compile(r"([!?;:()\[\]{}\"%#&*+=/\\|~<>^@¡¿])")
_MULTIDOT = re.compile(r"\.{2,}")


def _protect_final_period(tok: str) -> List[str]:
    """Split a trailing period off unless the stem is a known abbreviation,
    a single letter (middle initials), or itself dotted (``e.g.``)."""
    if len(tok) < 2 or not tok.endswith(".") or tok == "..":
        return [tok]
    stem = tok[:-1]
    if stem.lower() in _NONBREAKING or (len(stem) == 1 and stem.isalpha()):
        return [tok]
    if "." in stem and all(p == "" or p.isalnum() for p in stem.split(".")):
        return [tok]  # acronyms like U.S. / e.g.
    if stem.isdigit():
        return [tok]  # enumeration "3." (German convention)
    return [stem, "."]


def moses_tokenize(text: str, lang: str = "en") -> List[str]:
    """Moses ``tokenizer.perl``-style tokenization (en/de subset).

    Splits punctuation into separate tokens while protecting decimal
    numbers (``3.14``, ``1,000``), abbreviations (``Mr.``, ``z.B.``),
    ellipses, and in-word hyphens; English apostrophe contractions split
    Moses-style (``it's`` -> ``it 's``, ``dogs'`` -> ``dogs '``).
    """
    t = text.strip()
    for k, v in _QUOTE_MAP.items():
        t = t.replace(k, v)
    t = _MULTIDOT.sub(lambda m: " " + "." * len(m.group(0)) + " ", t)
    t = _SPLIT_PUNCT.sub(r" \1 ", t)
    # commas: split unless digit,digit (1,000 stays)
    t = re.sub(r",(?!\d)", " , ", t)
    t = re.sub(r"(?<!\d),", " , ", t)
    # apostrophes: isolate quote-like ones FIRST (so the contraction split
    # below isn't re-split), then the in-word contraction rule
    t = re.sub(r"(?<!\w)'", " ' ", t)
    t = re.sub(r"'(?!\w)", " ' ", t)
    if lang == "en":
        t = re.sub(r"(\w)'(\w)", r"\1 '\2", t)  # it's -> it 's
    else:
        t = re.sub(r"(\w)'(\w)", r"\1' \2", t)  # l'avion -> l' avion
    # periods: split sentence-final / non-protected ones
    out: List[str] = []
    for tok in t.split():
        if tok.endswith(".") and not _MULTIDOT.fullmatch(tok):
            out.extend(_protect_final_period(tok))
        else:
            out.append(tok)
    return out


_ATTACH_LEFT = set(".,!?;:%)]}")
_ATTACH_RIGHT = set("([{¡¿$€£#")


def moses_detokenize(tokens: Sequence[str], lang: str = "en") -> str:
    """Moses ``detokenizer.perl``-style inverse of :func:`moses_tokenize`."""
    out: List[str] = []
    quote_open = False
    glue_next = False
    for tok in tokens:
        if not out:
            out.append(tok)
            glue_next = tok in _ATTACH_RIGHT
            continue
        if tok == '"':
            if quote_open:
                out[-1] += tok  # closing quote hugs left
            else:
                out.append(tok)  # opening quote hugs right
                glue_next = True
                quote_open = not quote_open
                continue
            quote_open = not quote_open
        elif glue_next:
            out[-1] += tok
        elif tok in _ATTACH_LEFT and len(tok) == 1:
            out[-1] += tok
        elif lang == "en" and tok.startswith("'") and len(tok) > 1:
            out[-1] += tok  # it 's -> it's
        elif lang != "en" and out[-1].endswith("'") and len(out[-1]) > 1:
            out[-1] += tok  # l' avion -> l'avion
        else:
            out.append(tok)
        glue_next = tok in _ATTACH_RIGHT and len(tok) == 1
    return " ".join(out)


# ---------------------------------------------------------------------------
# Byte-pair encoding (Sennrich et al. 2016, subword-nmt semantics)
# ---------------------------------------------------------------------------

EOW = "</w>"
BPE_SUFFIX = "@@"


def _word_symbols(word: str) -> Tuple[str, ...]:
    return tuple(word[:-1]) + (word[-1] + EOW,)


class BPECodec:
    """A learned merge table; applies BPE with the ``@@`` marker."""

    def __init__(self, merges: Sequence[Tuple[str, str]]):
        self.merges: List[Tuple[str, str]] = list(merges)
        self.rank: Dict[Tuple[str, str], int] = {
            pair: i for i, pair in enumerate(self.merges)
        }
        self._cache: Dict[str, Tuple[str, ...]] = {}

    def __len__(self) -> int:
        return len(self.merges)

    def _encode_word(self, word: str) -> Tuple[str, ...]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        sym = list(_word_symbols(word))
        while len(sym) > 1:
            best_rank, best_i = None, -1
            for i in range(len(sym) - 1):
                r = self.rank.get((sym[i], sym[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            # merge ALL occurrences of the best pair (subword-nmt order)
            a, b = sym[best_i], sym[best_i + 1]
            merged, i = [], 0
            while i < len(sym):
                if i < len(sym) - 1 and sym[i] == a and sym[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(sym[i])
                    i += 1
            sym = merged
        pieces = tuple(
            s[: -len(EOW)] if s.endswith(EOW) else s + BPE_SUFFIX for s in sym
        )
        # a word whose last symbol did not carry EOW cannot occur (EOW is
        # glued to the final char at split time and only ever merges forward)
        self._cache[word] = pieces
        return pieces

    def encode(self, tokens: Sequence[str]) -> List[str]:
        """Word tokens -> subword tokens (non-final pieces end in ``@@``)."""
        out: List[str] = []
        for tok in tokens:
            out.extend(self._encode_word(tok))
        return out

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("#version: qdt-bpe 1\n")
            for a, b in self.merges:
                f.write(f"{a} {b}\n")

    @classmethod
    def load(cls, path: str) -> "BPECodec":
        merges: List[Tuple[str, str]] = []
        with open(path) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                a, sep, b = line.rstrip("\n").partition(" ")
                if sep:
                    merges.append((a, b))
        return cls(merges)


def bpe_join(subword_tokens: Sequence[str]) -> List[str]:
    """Inverse of :meth:`BPECodec.encode`: fuse ``@@``-marked pieces."""
    out: List[str] = []
    buf = ""
    for tok in subword_tokens:
        if tok.endswith(BPE_SUFFIX):
            buf += tok[: -len(BPE_SUFFIX)]
        else:
            out.append(buf + tok)
            buf = ""
    if buf:
        out.append(buf)  # trailing continuation piece (truncated decode)
    return out


class _RevStr(str):
    """str with inverted ordering, so a min-heap pops the LARGEST pair
    among equal counts — the same tie-break as ``max(..., key=(count, pair))``."""

    __slots__ = ()

    def __lt__(self, other):  # pragma: no branch
        return str.__gt__(self, other)


def learn_bpe(
    sentences: Iterable[Sequence[str]],
    num_merges: int,
    min_pair_freq: int = 2,
) -> BPECodec:
    """Learn a BPE merge table from a tokenized corpus.

    Incremental pair-count maintenance (only words containing the merged
    pair are revisited) plus a lazily-invalidated max-heap over pair counts,
    so the per-merge cost is O(touched words + log #pairs) instead of a full
    O(#pairs) scan — the scan dominated wall-clock at corpus scale
    (measured: 10k merges over a 1M-sentence corpus, see BASELINE.md).
    Tie-breaks replicate the scan exactly (highest count, then
    lexicographically largest pair), so learned codecs are byte-identical.
    """
    import heapq

    word_freq: Counter = Counter()
    for sent in sentences:
        word_freq.update(sent)
    words: List[List[str]] = []
    freqs: List[int] = []
    for w, f in word_freq.items():
        words.append(list(_word_symbols(w)))
        freqs.append(f)

    stats: Counter = Counter()
    index: Dict[Tuple[str, str], Set[int]] = {}
    for wi, sym in enumerate(words):
        f = freqs[wi]
        for i in range(len(sym) - 1):
            pair = (sym[i], sym[i + 1])
            stats[pair] += f
            index.setdefault(pair, set()).add(wi)

    heap = [(-c, _RevStr(p[0]), _RevStr(p[1])) for p, c in stats.items()]
    heapq.heapify(heap)

    def push(pair, count):
        heapq.heappush(heap, (-count, _RevStr(pair[0]), _RevStr(pair[1])))

    def bump(pair, delta):
        stats[pair] += delta
        if stats[pair] <= 0:
            del stats[pair]
        else:
            # push on EVERY change (including decrements — the pair's only
            # valid heap entry must reflect its current count); outdated
            # entries are skipped lazily at pop time
            push(pair, stats[pair])

    merges: List[Tuple[str, str]] = []
    for _ in range(num_merges):
        best = None
        while heap:
            negc, a_, b_ = heap[0]
            pair = (str(a_), str(b_))
            if stats.get(pair) == -negc:
                best = pair
                break
            heapq.heappop(heap)  # stale (count changed or pair gone)
        if best is None or stats[best] < min_pair_freq:
            break
        merges.append(best)
        a, b = best
        ab = a + b
        for wi in list(index.get(best, ())):
            sym = words[wi]
            f = freqs[wi]
            # remove this word's contribution to all its current pairs
            for i in range(len(sym) - 1):
                pair = (sym[i], sym[i + 1])
                bump(pair, -f)
                s = index.get(pair)
                if s is not None:
                    s.discard(wi)
            # merge, then re-add
            merged, i = [], 0
            while i < len(sym):
                if i < len(sym) - 1 and sym[i] == a and sym[i + 1] == b:
                    merged.append(ab)
                    i += 2
                else:
                    merged.append(sym[i])
                    i += 1
            words[wi] = merged
            for i in range(len(merged) - 1):
                pair = (merged[i], merged[i + 1])
                bump(pair, f)
                index.setdefault(pair, set()).add(wi)
        stats.pop(best, None)
        index.pop(best, None)
    return BPECodec(merges)


# ---------------------------------------------------------------------------
# Pipeline: tokenizer + BPE as one savable unit
# ---------------------------------------------------------------------------


@dataclass
class TextPipeline:
    """Raw string <-> model-token preprocessing for one language side."""

    lang: str = "en"
    lower: bool = False
    bpe: Optional[BPECodec] = None

    def encode_line(self, line: str) -> List[str]:
        toks = moses_tokenize(line.lower() if self.lower else line, self.lang)
        return self.bpe.encode(toks) if self.bpe is not None else toks

    def decode_tokens(self, tokens: Sequence[str]) -> str:
        words = bpe_join(tokens) if self.bpe is not None else list(tokens)
        return moses_detokenize(words, self.lang)

    def save(self, directory: str, side: str) -> None:
        os.makedirs(directory, exist_ok=True)
        import json

        meta = {"lang": self.lang, "lower": self.lower, "bpe": self.bpe is not None}
        with open(os.path.join(directory, f"{side}.pipeline.json"), "w") as f:
            json.dump(meta, f)
        if self.bpe is not None:
            self.bpe.save(os.path.join(directory, f"{side}.bpe"))

    @classmethod
    def load(cls, directory: str, side: str) -> "TextPipeline":
        import json

        with open(os.path.join(directory, f"{side}.pipeline.json")) as f:
            meta = json.load(f)
        bpe = None
        if meta.get("bpe"):
            bpe = BPECodec.load(os.path.join(directory, f"{side}.bpe"))
        return cls(lang=meta["lang"], lower=meta["lower"], bpe=bpe)
