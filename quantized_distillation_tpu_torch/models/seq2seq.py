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
from ..kernels.lstm_cell import lstm_cell
from ..parallel.tensor import (
    ModelParallel,
    copy_to_model,
    gather_from_model,
    gather_to_split,
    local_columns,
    reduce_from_model,
    split_to_model,
    vocab_parallel_embedding,
)

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
        return lstm_gates(self.wh, self.bh, c, h, xw)

    def load(self, cell_params) -> None:
        wi, wh, bh = fuse_lstm_params(cell_params)
        _copy(self.wi, wi)
        _copy(self.wh, wh)
        _copy(self.bh, bh)


def lstm_gates(wh, bh, c, h, xw):
    """The cell's step on the recurrent input ``h``: ``z = (h @ wh + bh) +
    xw``, gate blocks i, f, g, o → ``(c', h')``. On a rank's shards
    (``wh`` [H, 4H/m], ``bh`` and ``xw`` its gate columns, ``c`` [B, H/m],
    ``h`` whole) it gives the rank's hidden units. The product is a
    ``torch.matmul``; the rest is :func:`..kernels.lstm_cell` (one kernel
    forward and one backward on the card)."""
    return lstm_cell(h @ wh, bh, xw, c)


def split_part(mp: Optional[ModelParallel], *names: str) -> Optional[ModelParallel]:
    """``mp`` where the parameters ``names`` are split over ``model`` (the
    tensor-parallel operators act), None where they are whole on every
    rank (the operators are the identity). Parameters that run together
    must be placed alike."""
    split = {mp.is_split(n) for n in names} if mp is not None else {False}
    if len(split) > 1:
        raise ValueError(f"parameters {names} must be all split or all whole over model")
    return mp if split.pop() else None


def cell_names(prefix: str) -> Tuple[str, str, str]:
    return (f"{prefix}.wi", f"{prefix}.wh", f"{prefix}.bh")


def run_lstm_tp(params, prefix: str, x, mp: Optional[ModelParallel], h0=None, c0=None):
    """One LSTM over time on a rank's shards of the cell ``prefix``, input
    ``x`` [B, T, in] whole on every rank → (h [B, T, H/m], c [B, T, H/m] at
    every step, the rank's hidden units; whole when ``mp`` is None). The
    recurrent input is all-gathered every step (reduce-scattered in the
    backward). ``h0`` (whole) and ``c0`` (the rank's units) start it, zeros
    when None; neither may need a gradient."""
    wi, wh, bh = (params[n] for n in cell_names(prefix))
    b, width = x.shape[0], wh.shape[1] // 4
    xw = copy_to_model(x, mp) @ wi
    c = c0 if c0 is not None else x.new_zeros((b, width))
    h_whole = h0 if h0 is not None else x.new_zeros((b, wh.shape[0]))
    hs, cs = [], []
    for step, xw_t in enumerate(xw.unbind(1)):
        if step:
            h_whole = gather_to_split(hs[-1], mp)
        c, h = lstm_gates(wh, bh, c, h_whole, xw_t)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, dim=1), torch.stack(cs, dim=1)


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
        for x_t in x.unbind(1):
            c, h = cell((c, h), x_t)
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
        outs = []
        for y_t in self.tgt_embed[tgt_in].unbind(1):
            state, (attn_h, _) = self.decoder(
                state, y_t, enc_out, enc_mask, train=train, generator=generator
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

    def logits_split(self, mp: Optional[ModelParallel]) -> bool:
        """Whether :meth:`forward_tp` returns this rank's vocab columns."""
        return mp is not None and mp.is_split("generator_kernel")

    def forward_tp(self, params: Mapping[str, torch.Tensor], src, src_len, tgt_in, *,
                   model_parallel: ModelParallel, train: bool = False,
                   generator: Optional[torch.Generator] = None):
        """Tensor-parallel :meth:`forward` on this rank's shards ``params``
        (name → local tensor, as ``parallel.place_params_seq2seq`` places
        :meth:`named_parameters`; ``model_parallel`` holds their specs) →
        logits [B, T_tgt, V/m], this rank's vocab columns, where
        :meth:`logits_split`, else [B, T_tgt, V].

        The layout is the JAX package's rules: embeddings row-split (a
        masked lookup, then ``psum``), each LSTM cell's gate columns split
        so the gate math stays on the rank's H/m hidden units and only the
        recurrent input is all-gathered a step, the attention's
        ``linear_in``/``linear_out`` column-split (scores summed over the
        split H), the generator vocab-split. A part whose parameters stay
        whole (a dim that does not divide the axis) runs whole. Dropout
        draws every mask whole, in :meth:`forward`'s order, from
        ``generator`` (the same on every rank of ``model``) and applies the
        rank's columns, so the masks are slices of the one-process ones."""
        mp = model_parallel
        cfg = self.cfg
        n_enc = len(self.encoder.cells)
        enc_mp = split_part(mp, *(n for i in range(n_enc)
                                  for n in cell_names(f"encoder.cells.{i}")))
        attn = ["decoder.attn.linear_out"] + (
            ["decoder.attn.linear_in"] if cfg.attn_type == "general" else [])
        dec_mp = split_part(mp, *attn, *(n for i in range(cfg.num_layers)
                                         for n in cell_names(f"decoder.cells.{i}")))
        enc_out, finals, local = self._encode_tp(params, mp, enc_mp, src, src_len, train,
                                                 generator)
        if local and dec_mp is None:
            raise ValueError("the encoder's cells are split over model and the decoder's are not")
        t = torch.arange(src.shape[1], device=src.device)[None, :]
        enc_mask = t < src_len[:, None]
        # the decoder's carry: (c as the rank's units, h whole)
        states = []
        for c, h in finals:
            if local:
                states.append((c, gather_to_split(h, dec_mp)))
            else:  # whole finals
                states.append((split_to_model(c, dec_mp), copy_to_model(h, dec_mp)))
        attn_h = self._decode_tp(params, mp, dec_mp, states, enc_out, enc_mask, tgt_in, train,
                                 generator)
        gen_mp = split_part(mp, "generator_kernel", "generator_bias")
        return copy_to_model(attn_h, gen_mp) @ params["generator_kernel"] + params["generator_bias"]

    def _encode_tp(self, p, mp, enc_mp, src, src_len, train, generator):
        """→ (enc_out [B, T, H] whole, per-layer final (c, h), whether the
        finals are the rank's units (else whole))."""
        cfg, enc = self.cfg, self.encoder
        b, t = src.shape
        x = vocab_parallel_embedding(p["encoder.embedding"], src,
                                     split_part(mp, "encoder.embedding"))
        last = (src_len.long() - 1) % t
        rows = torch.arange(b, device=src.device)
        per_layer = 2 if enc.bidirectional else 1
        if enc.bidirectional:
            flip = ((torch.arange(t - 1, -1, -1, device=src.device)[None, :]
                     + src_len.long()[:, None]) % t)[:, :, None]
        finals = []
        for i in range(cfg.num_layers):
            if i > 0:
                x = dropout(x, cfg.dropout, train, generator)
            out, cs = run_lstm_tp(p, f"encoder.cells.{per_layer * i}", x, enc_mp)
            c, h = cs[rows, last], out[rows, last]
            if enc.bidirectional:
                xb = torch.gather(x, 1, flip.expand(b, t, x.shape[-1]))
                bw, cb = run_lstm_tp(p, f"encoder.cells.{2 * i + 1}", xb, enc_mp)
                cb, hb = cb[rows, last], bw[rows, last]
                bw = torch.gather(bw, 1, flip.expand(b, t, bw.shape[-1]))
                out = torch.cat([gather_from_model(out, enc_mp), gather_from_model(bw, enc_mp)],
                                dim=-1)
                c = torch.cat([gather_from_model(c, enc_mp), gather_from_model(cb, enc_mp)], dim=-1)
                h = torch.cat([gather_from_model(h, enc_mp), gather_from_model(hb, enc_mp)], dim=-1)
            else:
                out = gather_from_model(out, enc_mp)
            x = out
            finals.append((c, h))
        return x, finals, enc_mp is not None and not enc.bidirectional

    def _decode_tp(self, p, mp, dec_mp, states, enc_out, enc_mask, tgt_in, train, generator):
        """Teacher-forced decode → the attention outputs [B, T_tgt, H],
        whole on every rank (the generator's input)."""
        cfg = self.cfg
        y_in = copy_to_model(vocab_parallel_embedding(p["tgt_embed"], tgt_in,
                                                      split_part(mp, "tgt_embed")), dec_mp)
        if cfg.attn_type == "general":
            keys = copy_to_model(enc_out, dec_mp) @ p["decoder.attn.linear_in"]
        else:
            keys = split_to_model(enc_out, dec_mp)
        b, steps = tgt_in.shape
        input_feed = enc_out.new_zeros((b, cfg.hidden))
        outs = []
        for step, y_t in enumerate(y_in.unbind(1)):
            x = torch.cat([y_t, input_feed], dim=-1)
            new_states = []
            for i, (c, h_whole) in enumerate(states):
                wi, wh, bh = (p[n] for n in cell_names(f"decoder.cells.{i}"))
                c, h = lstm_gates(wh, bh, c, h_whole, x @ wi)
                h_whole = gather_to_split(h, dec_mp)
                new_states.append((c, h_whole))
                mask = dropout_mask((b, cfg.hidden), cfg.dropout, train, generator, h)
                x = apply_dropout(h_whole, mask, cfg.dropout)  # flax drop_{i}
            states = new_states
            x_local = apply_dropout(h, local_columns(mask, dec_mp), cfg.dropout)
            scores = reduce_from_model(torch.einsum("bh,bth->bt", x_local, keys), dec_mp)
            scores = torch.where(enc_mask, scores, torch.full_like(scores, -1e9))
            align = torch.softmax(scores, dim=-1)
            context = torch.einsum("bt,bth->bh", align, enc_out)
            attn_h = torch.tanh(torch.cat([copy_to_model(context, dec_mp), x], dim=-1)
                                @ p["decoder.attn.linear_out"])
            mask = dropout_mask((b, cfg.hidden), cfg.dropout, train, generator, attn_h)
            attn_h = apply_dropout(attn_h, local_columns(mask, dec_mp), cfg.dropout)  # drop_out
            outs.append(attn_h)
            if step + 1 < steps:
                input_feed = gather_to_split(attn_h, dec_mp)
        return gather_from_model(torch.stack(outs, dim=1), dec_mp)


def dropout(x: torch.Tensor, rate: float, train: bool, generator) -> torch.Tensor:
    """flax ``nn.Dropout``: in training, keep each element with probability
    ``1 - rate`` (a uniform draw from ``generator`` below it) and scale the
    kept ones by ``1 / (1 - rate)``; the identity otherwise."""
    return apply_dropout(x, dropout_mask(x.shape, rate, train, generator, x), rate)


def dropout_mask(shape, rate: float, train: bool, generator, like: torch.Tensor):
    """The keep mask :func:`dropout` draws for a tensor of ``shape`` (dtype
    and device of ``like``), or None when it is the identity. The
    tensor-parallel forwards draw a whole activation's mask and apply its
    columns to the rank's slice."""
    if not train or rate == 0.0:
        return None
    if generator is None:
        raise ValueError("dropout in training mode requires a torch.Generator")
    u = torch.rand(tuple(shape), generator=generator, dtype=like.dtype, device=like.device)
    return u < 1.0 - rate


def apply_dropout(x: torch.Tensor, mask, rate: float) -> torch.Tensor:
    if mask is None:
        return x
    keep = 1.0 - rate
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _copy(param: torch.Tensor, value) -> None:
    value = torch.as_tensor(value, dtype=torch.float32)
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"parameter shape {tuple(param.shape)} vs {tuple(value.shape)}")
    param.data.copy_(value)
