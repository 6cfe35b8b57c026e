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

from ..parallel.comm import all_gather_dim
from ..parallel.mesh import MODEL_AXIS
from ..parallel.tensor import (
    ModelParallel,
    copy_to_model,
    gather_from_model,
    local_columns,
    vocab_parallel_embedding,
)
from ._layers import Dense, FlaxModel
from .seq2seq import LSTMCell, cell_names, dropout, run_lstm_tp, split_part

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
            for xw_t in xw.unbind(1):
                state = cell.step(state, xw_t)
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

    def logits_split(self, mp: Optional[ModelParallel]) -> bool:
        """Whether :meth:`forward_tp` returns this rank's vocab columns."""
        name = "embed.embedding" if self.generator is None else "generator.kernel"
        return mp is not None and mp.is_split(name)

    def forward_tp(self, params: Mapping[str, torch.Tensor], tokens, carry=None, *,
                   model_parallel: ModelParallel, train: bool = False,
                   generator: Optional[torch.Generator] = None):
        """Tensor-parallel :meth:`forward` on this rank's shards ``params``
        (``parallel.place_params_lm`` of :meth:`named_parameters`) →
        (logits [B, T, V/m], this rank's vocab columns where
        :meth:`logits_split`, else [B, T, V]; the final carry, whole and
        detached). ``carry`` is whole, as :meth:`forward` takes it. The
        layout is :meth:`..seq2seq.Seq2Seq.forward_tp`'s: the embedding
        row-split, each cell's gate columns split with the recurrent input
        all-gathered a step, the generator vocab-split (the tied embedding
        transposed); dropout masks are drawn whole, in :meth:`forward`'s
        order."""
        cfg, mp = self.cfg, model_parallel
        emb_mp = split_part(mp, "embed.embedding")
        x = dropout(vocab_parallel_embedding(params["embed.embedding"], tokens, emb_mp),
                    cfg.dropout, train, generator)
        finals = []
        for i in range(cfg.num_layers):
            cmp = split_part(mp, *cell_names(f"OptimizedLSTMCell_{i}"))
            c0 = h0 = None
            if carry is not None:
                c0, h0 = (t.detach() for t in carry[i])
                c0 = local_columns(c0, cmp).contiguous()
            out, cs = run_lstm_tp(params, f"OptimizedLSTMCell_{i}", x, cmp, h0=h0, c0=c0)
            with torch.no_grad():
                last = torch.stack([cs[:, -1], out[:, -1]])
                if cmp is not None:
                    last = all_gather_dim(last, cmp.mesh, MODEL_AXIS, -1)
            finals.append((last[0], last[1]))
            x = dropout(gather_from_model(out, cmp), cfg.dropout, train, generator)
        if self.generator is None:
            logits = copy_to_model(x, emb_mp) @ params["embed.embedding"].T
        else:
            gen_mp = split_part(mp, "generator.kernel", "generator.bias")
            logits = copy_to_model(x, gen_mp) @ params["generator.kernel"] + params["generator.bias"]
        return logits, tuple(finals)

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
