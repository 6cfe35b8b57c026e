"""The two model families, written out in plain PyTorch float32.

Weights are a dict of name → tensor in the layout the benchmark makes them
(``portbench.weights``): LSTM cells as ``<cell>.wi`` [in, 4H],
``<cell>.wh`` [H, 4H] and ``<cell>.bh`` [4H], gate blocks i, f, g, o side
by side; dense kernels ``[in, out]``; embeddings ``[vocab, dim]``.

- LSTM cell (Hochreiter & Schmidhuber; the gate layout of flax's
  ``OptimizedLSTMCell``): ``z = h W_h + b + x W_i``; ``c' = σ(f) c + σ(i)
  tanh(g)``; ``h' = σ(o) tanh(c')``.
- Seq2seq (OpenNMT's LSTM encoder-decoder; Luong et al. 2015, global
  "general" attention with input feeding): the encoder's final (c, h) of
  each layer, taken at each sentence's last real position, start the
  decoder; the decoder's first layer reads ``[embedding; attention output of
  the previous step]``; attention scores ``h_t · (h_s W_in)`` over the real
  source positions, ``attn_h = tanh([context; h_t] W_out)``; logits
  ``attn_h W_gen + b_gen``.
- LM (Zaremba et al. 2014): embedding, stacked LSTM over the window from a
  given carry, ``h W_gen + b_gen``.

Every product goes through ``numerics.mm`` in the format ``fmt``, so the
same code is the reference (``f32``) and its controls. Dropout is not
written: the benchmark's configurations run without it.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Tuple

import torch

from .numerics import mm

W = Mapping[str, torch.Tensor]
NEG = -1e9


def cell_step(w: W, name: str, c, h, xw, fmt: str):
    z = (mm(h, w[f"{name}.wh"], fmt) + w[f"{name}.bh"]) + xw
    zi, zf, zg, zo = z.chunk(4, dim=-1)
    c = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
    return c, torch.sigmoid(zo) * torch.tanh(c)


def lstm(w: W, name: str, x, c, h, fmt: str):
    """One LSTM layer over ``x`` [B, T, in] from (c, h) → (outputs [B, T,
    H], the (c, h) at every step as lists)."""
    xw = mm(x, w[f"{name}.wi"], fmt)
    hs, cs = [], []
    for t in range(x.shape[1]):
        c, h = cell_step(w, name, c, h, xw[:, t], fmt)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, dim=1), cs, hs


def encode(w: W, src, src_len, layers: int, fmt: str = "f32"):
    """→ (enc_out [B, T, H], mask [B, T] bool, per-layer final (c, h))."""
    b, t = src.shape
    x = w["encoder.embedding"][src]
    hidden = w["encoder.cells.0.wh"].shape[0]
    last = (src_len.long() - 1) % t
    rows = torch.arange(b, device=src.device)
    finals = []
    for i in range(layers):
        zeros = x.new_zeros((b, hidden))
        x, cs, _ = lstm(w, f"encoder.cells.{i}", x, zeros, zeros, fmt)
        finals.append((torch.stack(cs, dim=1)[rows, last], x[rows, last]))
    mask = torch.arange(t, device=src.device)[None, :] < src_len[:, None]
    return x, mask, finals


def decoder_step(w: W, states: List[Tuple[torch.Tensor, torch.Tensor]], feed, emb, keys,
                 enc_out, mask, fmt: str):
    """One decoder step → (new states, attention output [B, H])."""
    x = torch.cat([emb, feed], dim=-1)
    new = []
    for i, (c, h) in enumerate(states):
        name = f"decoder.cells.{i}"
        c, h = cell_step(w, name, c, h, mm(x, w[f"{name}.wi"], fmt), fmt)
        new.append((c, h))
        x = h
    scores = mm(keys, x[:, :, None], fmt)[:, :, 0]  # [B, T_src]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG))
    align = torch.softmax(scores, dim=-1)
    context = mm(align[:, None, :], enc_out, fmt)[:, 0]
    attn_h = torch.tanh(mm(torch.cat([context, x], dim=-1), w["decoder.attn.linear_out"], fmt))
    return new, attn_h


def seq2seq_forward(w: W, src, src_len, tgt_in, layers: int, fmt: str = "f32",
                    generator: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Teacher-forced logits [B, T_tgt, V]. ``generator`` replaces
    ``(generator_kernel, generator_bias)``."""
    enc_out, mask, states = encode(w, src, src_len, layers, fmt)
    keys = mm(enc_out, w["decoder.attn.linear_in"], fmt)
    emb = w["tgt_embed"][tgt_in]
    feed = enc_out.new_zeros((src.shape[0], w["decoder.attn.linear_out"].shape[1]))
    outs = []
    for t in range(tgt_in.shape[1]):
        states, feed = decoder_step(w, states, feed, emb[:, t], keys, enc_out, mask, fmt)
        outs.append(feed)
    kernel, bias = generator or (w["generator_kernel"], w["generator_bias"])
    return mm(torch.stack(outs, dim=1), kernel, fmt) + bias


def lm_forward(w: W, tokens, carry, layers: int, fmt: str = "f32"):
    """(logits [B, T, V], the final carry) from ``carry`` (per layer (c, h))."""
    x = w["embed.embedding"][tokens]
    finals = []
    for i in range(layers):
        c, h = carry[i]
        x, cs, hs = lstm(w, f"OptimizedLSTMCell_{i}", x, c, h, fmt)
        finals.append((cs[-1], hs[-1]))
    return mm(x, w["generator.kernel"], fmt) + w["generator.bias"], tuple(finals)
