"""OpenNMT-style LSTM seq2seq with Luong global attention + input feeding.

PyTorch port of the JAX package's ``models/seq2seq.py``: an LSTM encoder
(optionally bidirectional), a stacked-LSTM decoder with Luong attention
("general" or "dot") and input feeding, and a linear generator. Parameters
keep the flax layouts
(``[in, out]`` kernels, the fused i, f, g, o gate blocks of
``OptimizedLSTMCell``) so :meth:`Seq2Seq.load_params` reads a flax tree as
it is (see :mod:`..convert`).

Serving and training share the module. Parameters are built with
``requires_grad`` off, so serving records no graph; the trainer
(``train/trainer.py::create_train_state``) turns gradients on and runs the
model on substituted, fake-quantized weights through :meth:`Seq2Seq.forward_with`
(``torch.func.functional_call``). Dropout sits where flax puts it (between
encoder layers, after each decoder LSTM layer, after the attention output):
inverted dropout drawn from an explicit ``torch.Generator`` when
``train=True``, the identity otherwise. Time loops are explicit Python
loops.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from .._device import resolve_device
from ..convert import fuse_lstm_params

# Decoder carry: (((c, h) per layer, ...), input_feed [B, H])
DecoderState = Tuple[Tuple[Tuple[torch.Tensor, torch.Tensor], ...], torch.Tensor]


@dataclass(frozen=True)
class Seq2SeqConfig:
    src_vocab: int
    tgt_vocab: int
    embed_dim: int = 500
    hidden: int = 500
    num_layers: int = 2
    bidirectional: bool = False
    attn_type: str = "general"  # 'general' (h W h_s) or 'dot' (h . h_s)
    dropout: float = 0.3
    pad_id: int = 0
    bos_id: int = 1
    eos_id: int = 2


# Teacher/student scales for the WMT13 de→en experiments.
SEQ2SEQ_PRESETS = {
    "teacher": dict(embed_dim=500, hidden=500, num_layers=2),
    "student_medium": dict(embed_dim=256, hidden=256, num_layers=2),
    "student_small": dict(embed_dim=128, hidden=128, num_layers=1),
}


def make_seq2seq(
    preset: str, src_vocab: int, tgt_vocab: int, *, device="cuda", seed: int = 0,
    **overrides,
) -> "Seq2Seq":
    kw = dict(SEQ2SEQ_PRESETS[preset])
    kw.update(overrides)
    cfg = Seq2SeqConfig(src_vocab=src_vocab, tgt_vocab=tgt_vocab, **kw)
    return Seq2Seq(cfg, device=device, seed=seed)


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``: ``z = (h @ wh + bh) + x @ wi``, gate blocks
    i, f, g, o; ``c' = f*c + i*g``, ``h' = o*tanh(c')``."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.wi = nn.Parameter(torch.empty(in_features, 4 * hidden))
        self.wh = nn.Parameter(torch.empty(hidden, 4 * hidden))
        self.bh = nn.Parameter(torch.empty(4 * hidden))

    def forward(self, carry, x):
        return self.step(carry, x @ self.wi)

    def step(self, carry, xw):
        """One step on ``xw = x @ wi``, computed beforehand (for a whole
        window at once, say)."""
        c, h = carry
        z = (h @ self.wh + self.bh) + xw
        zi, zf, zg, zo = z.chunk(4, dim=-1)
        c = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
        return c, torch.sigmoid(zo) * torch.tanh(c)

    def load(self, cell_params) -> None:
        wi, wh, bh = fuse_lstm_params(cell_params)
        _copy(self.wi, wi)
        _copy(self.wh, wh)
        _copy(self.bh, bh)


class Encoder(nn.Module):
    """Embedding + stacked LSTM over the source. The final carry of each
    layer is the one at position ``src_len - 1``, as flax
    ``nn.RNN(seq_lengths=...)`` returns it; outputs at padded positions are
    computed and left to the attention mask.

    Bidirectional: each layer runs a forward and a backward LSTM of
    ``hidden / 2``; outputs and final carries are their concatenation. The
    backward one runs over each sentence's own length, as flax
    ``nn.RNN(reverse=True, keep_order=True, seq_lengths=...)`` does: the
    valid part of the sentence reversed, then its padding reversed
    (``flip_sequences``), with the outputs flipped back. ``cells`` holds the
    cells in flax's creation order, so cell ``2i`` is layer ``i``'s forward
    one and ``2i + 1`` its backward one (flax names them
    ``OptimizedLSTMCell_{2i}`` and ``_{2i+1}``)."""

    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        if cfg.bidirectional and cfg.hidden % 2:
            raise ValueError("bidirectional needs even hidden size")
        self.bidirectional = cfg.bidirectional
        width = cfg.hidden // 2 if cfg.bidirectional else cfg.hidden
        per_layer = 2 if cfg.bidirectional else 1
        self.embedding = nn.Parameter(torch.empty(cfg.src_vocab, cfg.embed_dim))
        self.cells = nn.ModuleList(
            LSTMCell(cfg.embed_dim if i < per_layer else cfg.hidden, width)
            for i in range(per_layer * cfg.num_layers)
        )
        self.width = width
        self.dropout = cfg.dropout

    def _run(self, cell, x, last, rows):
        """One LSTM over time → (outputs [B, T, width], final (c, h))."""
        c = h = x.new_zeros((x.shape[0], self.width))
        cs, hs = [], []
        for step in range(x.shape[1]):
            c, h = cell((c, h), x[:, step])
            cs.append(c)
            hs.append(h)
        out = torch.stack(hs, dim=1)
        return out, (torch.stack(cs)[last, rows], out[rows, last])

    def forward(self, src: torch.Tensor, src_len: torch.Tensor, *, train=False, generator=None):
        b, t = src.shape
        x = self.embedding[src]
        last = (src_len.long() - 1) % t  # flax indexes seq_len - 1 the same way
        rows = torch.arange(b, device=src.device)
        if self.bidirectional:  # flax flip_sequences: position i reads (len - 1 - i) mod T
            flip = (torch.arange(t - 1, -1, -1, device=src.device)[None, :]
                    + src_len.long()[:, None]) % t
            flip = flip[:, :, None]
        finals = []
        per_layer = 2 if self.bidirectional else 1
        for i in range(len(self.cells) // per_layer):
            if i > 0:  # flax drops out between layers, not after the last
                x = dropout(x, self.dropout, train, generator)
            out, (c, h) = self._run(self.cells[per_layer * i], x, last, rows)
            if self.bidirectional:
                idx = flip.expand(b, t, x.shape[-1])
                bw, (cb, hb) = self._run(self.cells[2 * i + 1], torch.gather(x, 1, idx), last, rows)
                bw = torch.gather(bw, 1, flip.expand(b, t, self.width))
                out = torch.cat([out, bw], dim=-1)
                c, h = torch.cat([c, cb], dim=-1), torch.cat([h, hb], dim=-1)
            x = out
            finals.append((c, h))
        return x, tuple(finals)


class LuongAttention(nn.Module):
    """score 'dot': h_t · h_s ; 'general': h_t · (h_s @ linear_in);
    ``attn_h = tanh([context; h_t] @ linear_out)``."""

    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        if cfg.attn_type not in ("general", "dot"):
            raise ValueError(f"unknown attn_type {cfg.attn_type!r}")
        self.linear_in = (
            nn.Parameter(torch.empty(cfg.hidden, cfg.hidden))
            if cfg.attn_type == "general" else None
        )
        self.linear_out = nn.Parameter(torch.empty(2 * cfg.hidden, cfg.hidden))

    def forward(self, h_t, enc_out, enc_mask):
        keys = enc_out @ self.linear_in if self.linear_in is not None else enc_out
        scores = torch.einsum("bh,bth->bt", h_t, keys)
        scores = torch.where(enc_mask, scores, torch.full_like(scores, -1e9))
        align = torch.softmax(scores, dim=-1)
        context = torch.einsum("bt,bth->bh", align, enc_out)
        attn_h = torch.tanh(torch.cat([context, h_t], dim=-1) @ self.linear_out)
        return attn_h, align


class DecoderStep(nn.Module):
    """One decoder time step: stacked LSTM on ``[y_emb; input_feed]``, then
    attention; the attention output is the next input feed."""

    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.cells = nn.ModuleList(
            LSTMCell(cfg.embed_dim + cfg.hidden if i == 0 else cfg.hidden, cfg.hidden)
            for i in range(cfg.num_layers)
        )
        self.attn = LuongAttention(cfg)
        self.dropout = cfg.dropout

    def forward(self, carry: DecoderState, y_emb, enc_out, enc_mask, *, train=False,
                generator=None):
        states, input_feed = carry
        x = torch.cat([y_emb, input_feed], dim=-1)
        new_states = []
        for cell, s in zip(self.cells, states):
            c, h = cell(s, x)
            new_states.append((c, h))
            x = dropout(h, self.dropout, train, generator)  # flax drop_{i}
        attn_h, align = self.attn(x, enc_out, enc_mask)
        attn_h = dropout(attn_h, self.dropout, train, generator)  # flax drop_out
        return (tuple(new_states), attn_h), (attn_h, align)


class Seq2Seq(nn.Module):
    """NMTModel analog: encode, decode (stepwise or teacher-forced),
    generate. Built on ``device`` with seeded random weights; load trained
    ones with :meth:`load_params`."""

    def __init__(self, cfg: Seq2SeqConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.tgt_embed = nn.Parameter(torch.empty(cfg.tgt_vocab, cfg.embed_dim))
        self.decoder = DecoderStep(cfg)
        self.generator_kernel = nn.Parameter(torch.empty(cfg.hidden, cfg.tgt_vocab))
        self.generator_bias = nn.Parameter(torch.empty(cfg.tgt_vocab))
        self.requires_grad_(False)
        self.eval()
        self.init_weights(seed)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.tgt_embed.device

    def init_weights(self, seed: int) -> None:
        """Random weights from ``seed`` (drawn on the CPU, so a seed gives the
        same weights on every device): kernels N(0, 1/fan_in), embeddings
        N(0, 1/embed_dim), biases 0."""
        g = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if p.dim() == 1:
                val = torch.zeros(p.shape)
            else:
                fan_in = p.shape[1] if "embed" in name else p.shape[0]
                val = torch.randn(p.shape, generator=g) / fan_in ** 0.5
            _copy(p, val)

    def load_params(self, params) -> "Seq2Seq":
        """Copy a flax-layout parameter tree (see :mod:`..convert`) in."""
        enc, dec = params["encoder"], params["decoder"]
        _copy(self.encoder.embedding, enc["embed"]["embedding"])
        for i, cell in enumerate(self.encoder.cells):
            cell.load(enc[f"OptimizedLSTMCell_{i}"])
        for i, cell in enumerate(self.decoder.cells):
            cell.load(dec[f"lstm_{i}"])
        if self.decoder.attn.linear_in is not None:
            _copy(self.decoder.attn.linear_in, dec["attn"]["linear_in"]["kernel"])
        _copy(self.decoder.attn.linear_out, dec["attn"]["linear_out"]["kernel"])
        _copy(self.tgt_embed, params["tgt_embed"]["embedding"])
        _copy(self.generator_kernel, params["generator"]["kernel"])
        _copy(self.generator_bias, params["generator"]["bias"])
        return self

    def generator(self, attn_h: torch.Tensor) -> torch.Tensor:
        return attn_h @ self.generator_kernel + self.generator_bias

    def encode(self, src, src_len, *, train=False, generator=None):
        """→ (enc_out [B,T,H], enc_mask [B,T], initial DecoderState)."""
        enc_out, finals = self.encoder(src, src_len, train=train, generator=generator)
        t = torch.arange(src.shape[1], device=src.device)[None, :]
        enc_mask = t < src_len[:, None]
        input_feed = enc_out.new_zeros((src.shape[0], self.cfg.hidden))
        return enc_out, enc_mask, (finals, input_feed)

    def decode(self, state: DecoderState, tgt_in, enc_out, enc_mask, *, train=False,
               generator=None):
        """Teacher-forced decode → (final state, logits [B, T_tgt, V])."""
        y_emb = self.tgt_embed[tgt_in]
        outs = []
        for step in range(tgt_in.shape[1]):
            state, (attn_h, _) = self.decoder(
                state, y_emb[:, step], enc_out, enc_mask, train=train, generator=generator
            )
            outs.append(attn_h)
        return state, self.generator(torch.stack(outs, dim=1))

    def decode_step(self, state: DecoderState, token, enc_out, enc_mask):
        """One serving step → (state, logits [B, V])."""
        state, (attn_h, _) = self.decoder(state, self.tgt_embed[token], enc_out, enc_mask)
        return state, self.generator(attn_h)

    def decode_step_attn(self, state: DecoderState, token, enc_out, enc_mask):
        """:meth:`decode_step` that also returns the attention alignment →
        (state, logits [B, V], align [B, T_src]) (the coverage penalty and
        per-hypothesis attention read it)."""
        state, (attn_h, align) = self.decoder(state, self.tgt_embed[token], enc_out, enc_mask)
        return state, self.generator(attn_h), align

    def forward(self, src, src_len, tgt_in, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """Full forward: logits [B, T_tgt, V]. ``train=True`` applies dropout
        (``cfg.dropout`` > 0) drawn from ``generator``."""
        enc_out, enc_mask, state = self.encode(src, src_len, train=train, generator=generator)
        return self.decode(state, tgt_in, enc_out, enc_mask, train=train, generator=generator)[1]

    def forward_with(self, params: Mapping[str, torch.Tensor], src, src_len, tgt_in, *,
                     train: bool = False, generator: Optional[torch.Generator] = None):
        """:meth:`forward` on the weights ``params`` (``named_parameters()``
        names → tensors, e.g. fake-quantized ones) in place of the module's
        own; gradients flow to whatever ``params`` holds."""
        return functional_call(
            self, dict(params), (src, src_len, tgt_in), {"train": train, "generator": generator}
        )


def dropout(x: torch.Tensor, rate: float, train: bool, generator) -> torch.Tensor:
    """flax ``nn.Dropout``: in training, keep each element with probability
    ``1 - rate`` (a uniform draw from ``generator`` below it) and scale the
    kept ones by ``1 / (1 - rate)``; the identity otherwise."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode requires a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, dtype=x.dtype, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _copy(param: torch.Tensor, value) -> None:
    value = torch.as_tensor(value, dtype=torch.float32)
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"parameter shape {tuple(param.shape)} vs {tuple(value.shape)}")
    param.data.copy_(value)
