"""Word-level LSTM language model (PyTorch port of the JAX package's
``models/lm.py``): embed → stacked LSTM → vocab generator, optionally with
tied input/output embeddings, usable as teacher or student.

Truncated-BPTT state is explicit: :meth:`LSTMLanguageModel.forward` takes
and returns the per-layer ``(c, h)`` carry, so the trainer can thread it
across windows (``train/tasks.py::lm_task(thread_carry=True)``). The cells
are the seq2seq family's :class:`.seq2seq.LSTMCell` (flax's
``OptimizedLSTMCell`` gate layout), named ``OptimizedLSTMCell_{i}`` at the
top level as flax names them; each layer's input products for the whole
window are one matmul, the time loop runs the recurrent part. Dropout sits
after the embedding and after every layer, as in flax.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from ._layers import Dense, FlaxModel
from .seq2seq import LSTMCell, dropout

# Per-layer LSTM carry: ((c, h), ...), the seq2seq family's convention.
LMCarry = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


@dataclass(frozen=True)
class LMConfig:
    vocab: int
    embed_dim: int = 650
    hidden: int = 650
    num_layers: int = 2
    dropout: float = 0.5
    tie_embeddings: bool = False


LM_PRESETS = {
    "teacher": dict(embed_dim=650, hidden=650, num_layers=2, dropout=0.5),
    "student_medium": dict(embed_dim=256, hidden=256, num_layers=2, dropout=0.3),
    "student_small": dict(embed_dim=128, hidden=128, num_layers=1, dropout=0.2),
}


class Embed(nn.Module):
    """flax ``nn.Embed``: an ``embedding`` table [vocab, dim]."""

    def __init__(self, vocab: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(vocab, dim))


class LSTMLanguageModel(FlaxModel):
    """Embed → stacked LSTM → logits over the vocabulary."""

    def __init__(self, cfg: LMConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        if cfg.tie_embeddings and cfg.embed_dim != cfg.hidden:
            raise ValueError("tie_embeddings requires embed_dim == hidden")
        self.cfg = cfg
        self.embed = Embed(cfg.vocab, cfg.embed_dim)
        for i in range(cfg.num_layers):
            self.add_module(f"OptimizedLSTMCell_{i}",
                            LSTMCell(cfg.embed_dim if i == 0 else cfg.hidden, cfg.hidden))
        self.generator = None if cfg.tie_embeddings else Dense(cfg.hidden, cfg.vocab)
        self._place(device, seed)

    def forward(self, tokens: torch.Tensor, carry: Optional[LMCarry] = None, *,
                train: bool = False, generator: Optional[torch.Generator] = None):
        """tokens [B, T] → (logits [B, T, V], final carry). ``carry=None``
        starts from zeros."""
        cfg = self.cfg
        x = dropout(self.embed.embedding[tokens], cfg.dropout, train, generator)
        finals = []
        for i in range(cfg.num_layers):
            cell = getattr(self, f"OptimizedLSTMCell_{i}")
            state = carry[i] if carry is not None else (
                x.new_zeros((x.shape[0], cfg.hidden)), x.new_zeros((x.shape[0], cfg.hidden)))
            xw = x @ cell.wi
            hs = []
            for t in range(x.shape[1]):
                state = cell.step(state, xw[:, t])
                hs.append(state[1])
            finals.append(state)
            x = dropout(torch.stack(hs, dim=1), cfg.dropout, train, generator)
        logits = x @ self.embed.embedding.T if self.generator is None else self.generator(x)
        return logits, tuple(finals)

    def forward_with(self, params: Mapping[str, torch.Tensor], tokens, carry=None, *,
                     train: bool = False, generator: Optional[torch.Generator] = None):
        """:meth:`forward` on the weights ``params`` (``named_parameters()``
        names → tensors) in place of the module's own."""
        return functional_call(self, dict(params), (tokens, carry),
                               {"train": train, "generator": generator})

    def initial_carry(self, batch_size: int) -> LMCarry:
        """Zeros on the model's device, each (c, h) its own buffer."""
        def z():
            return torch.zeros((batch_size, self.cfg.hidden), device=self.device)

        return tuple((z(), z()) for _ in range(self.cfg.num_layers))


def make_lm(preset: str, vocab: int, *, device="cuda", seed: int = 0,
            **overrides) -> LSTMLanguageModel:
    kw = dict(LM_PRESETS[preset])
    kw.update(overrides)
    return LSTMLanguageModel(LMConfig(vocab=vocab, **kw), device=device, seed=seed)
