"""Batched beam-search decoding (PyTorch port of the JAX package's
``serve/beam.py``).

All B sentences x K beams step together: one ``decode_step`` on a [B*K]
batch per time step, a per-sentence top-k over the flattened candidates,
beam reordering as a gather of the decoder state, finished beams frozen by
emitting EOS at zero added score, and the GNMT length penalty at the end.
Histories are backpointers (``sym``/``parent`` time-major [T, B*K]),
reconstructed once at finalization.

Every top-k here has ``jax.lax.top_k``'s order (values descending, equal
values by ascending index), which beam results depend on: the candidate
path goes through the beam-advance kernel, the logits path through a
stable descending sort. A step advances the beam state in place (the
histories gain row ``t``; scores, flags, lengths and last tokens are
overwritten), where the JAX package returns a new state.

On the card a search runs as one captured CUDA graph (encode, every step,
finalization), the counterpart of the JAX package's ``lax.scan`` under
``jit``; see :mod:`..utils.graphs`. The coverage penalty and
per-hypothesis attention are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import torch

from .._device import resolve_device
from ..config import BeamConfig
from ..kernels.beam_combine import NEG_INF, beam_advance, record_step
from ..kernels.topk_fused import topk_sorted
from ..utils.graphs import GraphCache, signature

# Token ids of the JAX package's data/translation.py vocabulary.
PAD, BOS, EOS, UNK = 0, 1, 2, 3

PARENT_DTYPE = torch.int8
# captured searches on the card (beam_search and infer.beam_search_packed)
SEARCH_GRAPHS = GraphCache()


class BeamState(NamedTuple):
    """Beam carry. ``sym[t, b*K + k]`` is the token beam slot ``k`` of
    sentence ``b`` emitted at step ``t``, ``parent[t, b*K + k]`` the slot it
    extended; slot histories are not in beam order until
    :func:`reconstruct_tokens`."""

    decoder_state: Any  # [B*K, ...] tensors (tuple tree or FusedDecState)
    sym: torch.Tensor  # [T_max, B*K] int32, PAD-filled
    parent: torch.Tensor  # [T_max, B*K] int8, identity-filled
    last_token: torch.Tensor  # [B, K] int64
    scores: torch.Tensor  # [B, K] f32 cumulative log-prob
    finished: torch.Tensor  # [B, K] bool
    lengths: torch.Tensor  # [B, K] int32 emitted length (excl. EOS)


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every tensor of a tuple / dataclass tree."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, t) for t in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(
            tree, **{f.name: tree_map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)}
        )
    raise TypeError(f"unsupported state node {type(tree)}")


def init_beam_state(
    decoder_state, batch: int, beam_size: int, t_max: int, *,
    bos_id: int = BOS, pad_id: int = PAD, device=None,
) -> BeamState:
    """Fresh beam state: only beam 0 alive, histories PAD/identity-filled."""
    k = beam_size
    scores = torch.full((batch, k), NEG_INF, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    return BeamState(
        decoder_state=decoder_state,
        sym=torch.full((t_max, batch * k), pad_id, dtype=torch.int32, device=device),
        parent=torch.arange(k, dtype=PARENT_DTYPE, device=device).repeat(t_max, batch),
        last_token=torch.full((batch, k), bos_id, dtype=torch.int64, device=device),
        scores=scores,
        finished=torch.zeros((batch, k), dtype=torch.bool, device=device),
        lengths=torch.zeros((batch, k), dtype=torch.int32, device=device),
    )


def reconstruct_tokens(sym: torch.Tensor, parent: torch.Tensor, beam_size: int) -> torch.Tensor:
    """Follow backpointers: time-major [T, B*K] → ``[B, K, T]``; row ``k`` is
    the hypothesis of the beam now in slot ``k``."""
    t_max, rows = sym.shape
    k = beam_size
    b = rows // k
    sym3 = sym.reshape(t_max, b, k)
    par3 = parent.to(torch.int64).reshape(t_max, b, k)
    cur = torch.arange(k, device=sym.device).expand(b, k)
    toks = []
    for t in range(t_max - 1, -1, -1):
        toks.append(torch.gather(sym3[t], 1, cur))
        cur = torch.gather(par3[t], 1, cur)
    return torch.stack(toks[::-1], dim=2)


def _gather_rows(tree, flat_row: torch.Tensor):
    """Reorder a [B*K, ...] state tree: new row ``i`` is old row
    ``flat_row[i]``."""
    return tree_map(lambda t: t.index_select(0, flat_row), tree)


def length_penalty(lengths: torch.Tensor, alpha: float) -> torch.Tensor:
    """GNMT length normalization ((5+len)/6)^alpha; 1 when alpha == 0."""
    if alpha == 0.0:
        return torch.ones(lengths.shape, dtype=torch.float32, device=lengths.device)
    return torch.pow((5.0 + lengths.to(torch.float32)) / 6.0, alpha)


def step_beams(
    decode_step: Callable, state: BeamState, t: int, *,
    beam_size: int, eos_id: int = EOS, pad_id: int = PAD,
) -> BeamState:
    """Advance every sentence's beams one step from full logits, in place
    (see the module docstring).
    ``decode_step(state [B*K,...], tokens [B*K]) -> (state, logits [B*K, V])``."""
    b, k = state.scores.shape
    new_dec, logits = decode_step(state.decoder_state, state.last_token.reshape(-1))
    v = logits.shape[-1]
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1).reshape(b, k, v)
    eos_row = torch.full((v,), NEG_INF, dtype=torch.float32, device=logp.device)
    eos_row.narrow(0, eos_id, 1).fill_(0.0)  # `eos_row[eos_id] = 0.0` would sync (a host copy)
    logp = torch.where(state.finished[..., None], eos_row, logp)
    cand = state.scores[..., None] + logp
    new_scores, flat_idx = topk_sorted(cand.reshape(b, k * v), beam_size)
    flat_row = record_step(
        state.scores, state.finished, state.lengths, state.last_token, state.sym,
        state.parent, new_scores, flat_idx // v, flat_idx % v, t, eos_id=eos_id, pad_id=pad_id,
    )
    return state._replace(decoder_state=_gather_rows(new_dec, flat_row))


def step_beams_cand(
    decode_cand: Callable, state: BeamState, t: int, *,
    beam_size: int, eos_id: int = EOS, pad_id: int = PAD,
) -> BeamState:
    """Beam advance from per-beam top-k candidates
    ``decode_cand(state, tokens [B*K]) -> (state, (vals [B*K, kc],
    idx [B*K, kc], lse [B*K, 1]))`` (the fused generator's contract), in
    place (see the module docstring). Candidate scores, the per-sentence
    top-k over the [B, K*kc] candidates and the bookkeeping are one launch
    of the beam-advance kernel on the card (its plain version on the CPU);
    then the decoder state is reordered. Equivalent to :func:`step_beams`
    whenever kc >= beam_size."""
    new_dec, (vals, idx, lse) = decode_cand(state.decoder_state, state.last_token.reshape(-1))
    flat_row = beam_advance(
        vals, idx, lse, state.scores, state.finished, state.lengths, state.last_token,
        state.sym, state.parent, t, eos_id=eos_id, pad_id=pad_id,
    )
    return state._replace(decoder_state=_gather_rows(new_dec, flat_row))


def expand_to_beams(tree, beam_size: int):
    """[B, ...] tree → [B*K, ...] by repeating each row K times."""
    return tree_map(lambda t: t.repeat_interleave(beam_size, dim=0), tree)


def finalize_scores(state: BeamState, cfg: BeamConfig) -> torch.Tensor:
    """Normalized hypothesis scores [B, K] (length penalty)."""
    return state.scores / length_penalty(state.lengths, cfg.length_penalty)


def _check_cfg(cfg: BeamConfig, return_attention: bool = False) -> None:
    if not 1 <= cfg.n_best <= cfg.beam_size:
        raise ValueError(f"n_best={cfg.n_best} must be in [1, beam_size={cfg.beam_size}]")
    if cfg.coverage_penalty != 0.0:
        raise NotImplementedError("coverage penalty: later slice")
    if return_attention:
        raise NotImplementedError("return_attention: later slice")


def beam_decode(
    decode_step: Callable,
    dec_state_beams,
    batch: int,
    cfg: BeamConfig,
    *,
    bos_id: int = BOS,
    eos_id: int = EOS,
    pad_id: int = PAD,
    candidates: bool = False,
    return_attention: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backend-agnostic beam core: ``cfg.max_len`` steps over any decoder.

    Returns ``(tokens [B, T], score [B])`` when ``cfg.n_best == 1``, else
    the top ``n_best`` by normalized score, ``(tokens [B, n, T], scores
    [B, n])``. With ``candidates=True`` the decoder returns per-beam top-k
    candidates instead of logits."""
    _check_cfg(cfg, return_attention)
    k = cfg.beam_size
    leaves = []
    tree_map(leaves.append, dec_state_beams)
    device = leaves[0].device
    state = init_beam_state(
        dec_state_beams, batch, k, cfg.max_len, bos_id=bos_id, pad_id=pad_id, device=device
    )
    stepper = step_beams_cand if candidates else step_beams
    for t in range(cfg.max_len):
        state = stepper(decode_step, state, t, beam_size=k, eos_id=eos_id, pad_id=pad_id)
    norm = finalize_scores(state, cfg)
    tokens = reconstruct_tokens(state.sym, state.parent, k)
    rows = torch.arange(batch, device=device)
    if cfg.n_best == 1:
        best = torch.argmax(norm, dim=1)
        return tokens[rows, best], norm[rows, best]
    top_scores, order = topk_sorted(norm, cfg.n_best)
    return tokens[rows[:, None], order], top_scores


def run_search(search: Callable, inputs, dev: torch.device, eager: bool, key):
    """``search(*inputs)`` with the inputs moved to ``dev``: called as it is
    on the CPU or when ``eager``, else replayed from the CUDA graph cached
    under ``key`` (captured at the first call; ``key`` must name everything
    besides the inputs' shapes that fixes the search's work)."""
    inputs = tuple(x.to(dev) for x in inputs)
    if dev.type == "cpu" or eager:
        return search(*inputs)
    return SEARCH_GRAPHS.run(key, search, inputs)


def beam_search(
    model,
    src: torch.Tensor,
    src_len: torch.Tensor,
    cfg: BeamConfig,
    *,
    device="cuda",
    bos_id: int = BOS,
    eos_id: int = EOS,
    pad_id: int = PAD,
    return_attention: bool = False,
    _eager: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Translate a batch with the dense model: → (best tokens [B, max_len],
    best scores [B]) (or the n-best lists). ``model`` and the work live on
    ``device``. On the card the search runs as one CUDA graph, captured at
    the first call for this model, batch, source length and config
    (``_eager=True``: the eager step loop, for comparisons)."""
    _check_cfg(cfg, return_attention)
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model is on {model.device}, not {dev}")
    k = cfg.beam_size

    def search(src, src_len):
        with torch.no_grad():
            enc_out, enc_mask, dec_state = model.encode(src, src_len)
            enc_out_b = enc_out.repeat_interleave(k, dim=0)
            enc_mask_b = enc_mask.repeat_interleave(k, dim=0)

            def decode_step(state, tokens):
                return model.decode_step(state, tokens, enc_out_b, enc_mask_b)

            return beam_decode(
                decode_step, expand_to_beams(dec_state, k), src.shape[0], cfg,
                bos_id=bos_id, eos_id=eos_id, pad_id=pad_id,
            )

    key = ("beam_search", signature(model), cfg, bos_id, eos_id, pad_id)
    return run_search(search, (src, src_len), dev, _eager, key)
