"""Operations and bytes worked out from shapes: the yardstick of the
per-layer metrics. Matrix products count 2 operations a multiply-add;
gate and softmax arithmetic is not counted. Nothing recomputed is counted.

A unit's shape (``record["unit_shapes"]``) is a dict: ``rows`` (sentences
or sequences), ``src_len`` (source positions, padded), ``tgt_len`` (target
positions, padded) and, for a search, ``beam`` and ``steps`` (decode
steps).
"""

from __future__ import annotations

BUCKET = 256


def generator_width(vocab: int, rows: int) -> int:
    """The served generator's padded width: the vocabulary padded to whole
    groups of 256-column buckets, the group the largest power of two up to
    32 whose [rows, (group + 16) * 256] f32 tile fits 48 MiB (the packing
    rule of the served model: V = 32000 at 1280 rows → 32768)."""
    rows_padded = -(-rows // 8) * 8
    group = 32
    while group > 1 and rows_padded * (group + 16) * BUCKET * 4 > 48 * 1024 * 1024:
        group //= 2
    align = group * BUCKET
    return -(-vocab // align) * align


def lstm_stack(rows: int, steps: int, first_in: int, hidden: int, layers: int) -> float:
    """A stack of LSTM layers over ``steps`` positions: the input and
    recurrent products of every gate."""
    return sum(2.0 * rows * steps * ((first_in if i == 0 else hidden) + hidden) * 4 * hidden
               for i in range(layers))


def seq2seq_forward(model: dict, vocab: int, rows: int, src_len: int, tgt_len: int) -> float:
    """A teacher-forced forward: encoder, attention keys, decoder with
    attention and input feed, generator."""
    e, h, n = model["embed_dim"], model["hidden"], model["num_layers"]
    enc = lstm_stack(rows, src_len, e, h, n) + 2.0 * rows * src_len * h * h
    dec = lstm_stack(rows, tgt_len, e + h, h, n)
    attn = tgt_len * (4.0 * rows * src_len * h + 2.0 * rows * 2 * h * h)
    return enc + dec + attn + 2.0 * rows * tgt_len * h * vocab


def lm_forward(model: dict, vocab: int, rows: int, length: int) -> float:
    e, h, n = model["embed_dim"], model["hidden"], model["num_layers"]
    return lstm_stack(rows, length, e, h, n) + 2.0 * rows * length * h * vocab


def search(model: dict, vocab: int, shape: dict) -> float:
    """One beam search: the encoder and keys over the sentences, then every
    decode step over sentences × beams, the generator at its padded width."""
    e, h, n = model["embed_dim"], model["hidden"], model["num_layers"]
    b, ls = shape["rows"], shape["src_len"]
    m = b * shape["beam"]
    enc = lstm_stack(b, ls, e, h, n) + 2.0 * b * ls * h * h
    step = (lstm_stack(m, 1, e + h, h, n) + 4.0 * m * ls * h + 2.0 * m * 2 * h * h
            + 2.0 * m * h * generator_width(vocab, m))
    return enc + shape["steps"] * step


def kd_step(config: dict, shape: dict) -> float:
    """One KD train step: the student's forward and backward (twice the
    forward) and the teacher's forward."""
    v, rows = config["vocab"], shape["rows"]
    if config["family"] == "seq2seq":
        def fwd(m):
            return seq2seq_forward(m, v, rows, shape["src_len"], shape["tgt_len"])
    else:
        def fwd(m):
            return lm_forward(m, v, rows, shape["tgt_len"])
    return 3.0 * fwd(config["student"]) + fwd(config["teacher"])


def quantized_weights(config: dict) -> int:
    """The student's weights a fake-quant pass reads, in whole buckets: each
    matrix bucketed on its own, an LSTM cell's gate blocks each on their
    own; biases are not quantized."""
    m, v = config["student"], config["vocab"]
    e, h, n = m["embed_dim"], m["hidden"], m["num_layers"]

    def buckets(numel):
        return -(-numel // config["quant"]["bucket_size"])

    def cells(first_in):
        return sum(4 * (buckets((first_in if i == 0 else h) * h) + buckets(h * h))
                   for i in range(n))

    if config["family"] == "seq2seq":
        total = (2 * buckets(v * e) + cells(e) + cells(e + h) + buckets(h * h)
                 + buckets(2 * h * h) + buckets(h * v))
    else:
        total = buckets(v * e) + cells(e) + buckets(h * v)
    return total * config["quant"]["bucket_size"]
