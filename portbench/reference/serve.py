"""The served translation model: the benchmark's weights with every decoder
matrix quantized as the deployment stores it (``quant.quantize_rows``: the
LSTM cells' input and recurrent kernels, the attention's output projection
and the generator; embeddings, the attention's input projection and the
encoder stay as they are), run teacher-forced over each prompt and the
tokens served for it; and the beam search the served model's tokens are
held to (``beam_search``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from .models import decoder_step, encode, seq2seq_forward
from .numerics import mm
from .quant import quantize_rows

BOS, EOS = 1, 2


def deployed_weights(w: Mapping[str, torch.Tensor], layers: int,
                     bits: int) -> Dict[str, torch.Tensor]:
    """The weights as the served decoder holds them."""
    out = dict(w)
    names = [f"decoder.cells.{i}.{k}" for i in range(layers) for k in ("wi", "wh")]
    for name in names + ["decoder.attn.linear_out", "generator_kernel"]:
        out[name] = quantize_rows(w[name], bits)
    return out


def served_logits(wq: Mapping[str, torch.Tensor], src, src_len, served, layers: int,
                  fmt: str = "f32") -> torch.Tensor:
    """Logits [n, T, V] at each position of ``served`` [n, T] given the
    tokens before it (the first position reads BOS)."""
    tgt_in = torch.cat([torch.full_like(served[:, :1], BOS), served[:, :-1]], dim=1)
    with torch.no_grad():
        return seq2seq_forward(wq, src, src_len, tgt_in, layers, fmt)


def beam_search(wq: Mapping[str, torch.Tensor], src, src_len, beam: int, max_len: int,
                layers: int, fmt: str = "f32") -> torch.Tensor:
    """The final hypotheses [beam, max_len] of a beam search of width
    ``beam`` over one sentence (``src`` [1, T]), best first.

    The rules are the usual ones (Sutskever et al. 2014; OpenNMT's
    translator without length or coverage penalty): the search starts from
    BOS with one live hypothesis; at each of ``max_len`` steps every
    hypothesis extends by each token at its log-probability, a finished one
    (its last token EOS) only by EOS at no cost; the ``beam`` best of those
    candidates by summed log-probability go on. A hypothesis's score is the
    sum of its tokens' log-probabilities up to and including its first
    EOS."""
    with torch.no_grad():
        enc_out, mask, states = encode(wq, src, src_len, layers, fmt)
        keys = mm(enc_out, wq["decoder.attn.linear_in"], fmt)
        grow = [beam] + [-1] * (enc_out.dim() - 1)
        enc_out, keys = enc_out.expand(*grow), keys.expand(*grow)
        mask = mask.expand(beam, -1)
        states = [(c.expand(beam, -1), h.expand(beam, -1)) for c, h in states]
        feed = enc_out.new_zeros((beam, wq["decoder.attn.linear_out"].shape[1]))
        vocab = wq["generator_kernel"].shape[1]
        dev = enc_out.device
        eos_row = torch.full((vocab,), float("-inf"), device=dev)
        eos_row[EOS] = 0.0
        scores = torch.full((beam,), float("-inf"), device=dev)
        scores[0] = 0.0
        finished = torch.zeros(beam, dtype=torch.bool, device=dev)
        last = torch.full((beam,), BOS, dtype=torch.int64, device=dev)
        hist = torch.empty((beam, 0), dtype=torch.int64, device=dev)
        for _ in range(max_len):
            states, feed = decoder_step(wq, states, feed, wq["tgt_embed"][last], keys, enc_out,
                                        mask, fmt)
            logits = mm(feed, wq["generator_kernel"], fmt) + wq["generator_bias"]
            logp = torch.where(finished[:, None], eos_row, torch.log_softmax(logits, dim=-1))
            scores, flat = torch.topk((scores[:, None] + logp).reshape(-1), beam)
            parent, last = flat // vocab, flat % vocab
            finished = finished[parent] | (last == EOS)
            states = [(c[parent], h[parent]) for c, h in states]
            feed = feed[parent]
            hist = torch.cat([hist[parent], last[:, None]], dim=1)
        return hist
