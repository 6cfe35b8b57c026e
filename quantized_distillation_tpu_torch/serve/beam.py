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
``jit``; see :mod:`..utils.graphs`.

The GNMT coverage penalty (``BeamConfig.coverage_penalty``) and
per-hypothesis attention (``return_attention``) ride the decode step's
attention alignment: a [B, K, T_src] coverage accumulator gathered by
parent, and a [T, B*K, T_src] attention history backtraced like the
tokens. The continuous-batching engine (:mod:`.engine`) steps the same
core with a device ring position and an active-slot mask.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .._device import resolve_device
from ..config import BeamConfig
from ..kernels.beam_combine import NEG_INF, beam_advance, record_step, write_row
from ..kernels.topk_fused import topk_sorted
from ..utils.graphs import GraphCache, signature
from ..utils.tracing import spanned

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
    # attention mass each hypothesis accrued per source position [B, K,
    # T_src] f32; only with the coverage penalty
    coverage: Optional[torch.Tensor] = None
    # per-step attention history [T_max, B*K, T_src] f32, time-major like
    # sym/parent; only for per-hypothesis attention output
    attn: Optional[torch.Tensor] = None


# A history row: a host int (the offline loop's step) or an int32 [1]
# tensor on the device (the engine's ring position, advanced in a graph).
Row = Union[int, torch.Tensor]


def _row(t: Row) -> dict:
    return {"pos": t} if isinstance(t, torch.Tensor) else {"t": t}


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
    coverage_len: Optional[int] = None, attn_len: Optional[int] = None,
) -> BeamState:
    """Fresh beam state: only beam 0 alive, histories PAD/identity-filled.
    ``coverage_len`` / ``attn_len`` (= T_src) allocate the coverage
    accumulator / the per-step attention history."""
    k = beam_size
    scores = torch.full((batch, k), NEG_INF, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    f32 = dict(dtype=torch.float32, device=device)
    return BeamState(
        decoder_state=decoder_state,
        sym=torch.full((t_max, batch * k), pad_id, dtype=torch.int32, device=device),
        parent=torch.arange(k, dtype=PARENT_DTYPE, device=device).repeat(t_max, batch),
        last_token=torch.full((batch, k), bos_id, dtype=torch.int64, device=device),
        scores=scores,
        finished=torch.zeros((batch, k), dtype=torch.bool, device=device),
        lengths=torch.zeros((batch, k), dtype=torch.int32, device=device),
        coverage=None if coverage_len is None else torch.zeros((batch, k, coverage_len), **f32),
        attn=None if attn_len is None else torch.zeros((t_max, batch * k, attn_len), **f32),
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


def reconstruct_attention(attn: torch.Tensor, parent: torch.Tensor, beam_size: int) -> torch.Tensor:
    """Backtrace per-step attention histories [T, B*K, T_src] → ``[B, K, T,
    T_src]`` by the same parent walk as :func:`reconstruct_tokens`. Rows
    past a hypothesis' EOS are zeros (written that way)."""
    t_max, rows, t_src = attn.shape
    k = beam_size
    b = rows // k
    a4 = attn.reshape(t_max, b, k, t_src)
    par3 = parent.to(torch.int64).reshape(t_max, b, k)
    cur = torch.arange(k, device=attn.device).expand(b, k)
    out = []
    for t in range(t_max - 1, -1, -1):
        out.append(torch.gather(a4[t], 1, cur[:, :, None].expand(b, k, t_src)))
        cur = torch.gather(par3[t], 1, cur)
    return torch.stack(out[::-1], dim=2)


def unroll_ring(
    sym: torch.Tensor, parent: torch.Tensor, start_pos: torch.Tensor, t_len: torch.Tensor, *,
    beam_size: int, pad_id: int = PAD,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Align ring-buffer histories ``[T_ring, E*K]`` to step order for
    :func:`reconstruct_tokens`: slot ``e``, admitted at ring row
    ``start_pos[e]``, owns the window ``[start_pos, start_pos + t_len) mod
    T_ring``; rows outside it (other slots' epochs) become PAD symbols and
    identity parents."""
    tp, rows = sym.shape
    k = beam_size
    e = rows // k
    tpr = torch.arange(tp, device=sym.device)[:, None]
    src = (start_pos.to(torch.int64)[None, :] + tpr) % tp  # [T_ring, E]
    valid = (tpr < t_len.to(torch.int64)[None, :])[:, :, None]
    idx = src[:, :, None].expand(tp, e, k)
    sym_a = torch.gather(sym.reshape(tp, e, k), 0, idx)
    par_a = torch.gather(parent.reshape(tp, e, k), 0, idx)
    ident = torch.arange(k, dtype=parent.dtype, device=sym.device).expand(tp, e, k)
    sym_a = torch.where(valid, sym_a, torch.full_like(sym_a, pad_id))
    par_a = torch.where(valid, par_a, ident)
    return sym_a.reshape(tp, e * k), par_a.to(PARENT_DTYPE).reshape(tp, e * k)


def _gather_rows(tree, flat_row: torch.Tensor):
    """Reorder a [B*K, ...] state tree: new row ``i`` is old row
    ``flat_row[i]``."""
    return tree_map(lambda t: t.index_select(0, flat_row), tree)


def length_penalty(lengths: torch.Tensor, alpha: float) -> torch.Tensor:
    """GNMT length normalization ((5+len)/6)^alpha; 1 when alpha == 0."""
    if alpha == 0.0:
        return torch.ones(lengths.shape, dtype=torch.float32, device=lengths.device)
    return torch.pow((5.0 + lengths.to(torch.float32)) / 6.0, alpha)


def coverage_penalty(coverage: torch.Tensor, beta: float) -> torch.Tensor:
    """GNMT coverage penalty ``beta * sum_j log(min(cov_j, 1))`` → [B, K].
    Zero coverage is masked source padding (the attention softmax puts
    positive mass on every real position) and contributes 0."""
    safe = torch.where(coverage > 0, torch.clamp(coverage, max=1.0), torch.ones_like(coverage))
    return beta * torch.log(safe).sum(dim=-1)


def _tracks_alignment(state: BeamState) -> bool:
    return state.coverage is not None or state.attn is not None


def _split(ret, state: BeamState):
    """A decode step's return → (state, output, align or None)."""
    if _tracks_alignment(state):
        return ret
    return ret[0], ret[1], None


def _record_alignment(state: BeamState, align, parent_finished, flat_row, t: Row, active) -> None:
    """The step's alignment ``align`` [B*K, T_src] (rows before the
    reorder), taken by parent: coverage gathers by parent and accrues the
    parent's alignment while the parent had not finished (inactive
    sentences keep theirs); the attention history's row ``t`` holds it, and
    zeros past EOS. ``parent_finished`` is the [B, K] flags before the
    step."""
    b, k = state.scores.shape
    fin = parent_finished.reshape(-1).index_select(0, flat_row).reshape(b, k, 1)
    align_g = align.to(torch.float32).index_select(0, flat_row).reshape(b, k, -1)
    gained = torch.where(fin, torch.zeros_like(align_g), align_g)
    if state.coverage is not None:
        cov = state.coverage.reshape(b * k, -1).index_select(0, flat_row).reshape(b, k, -1)
        cov = cov + gained
        if active is not None:
            cov = torch.where(active[:, None, None], cov, state.coverage)
        state.coverage.copy_(cov)
    if state.attn is not None:
        write_row(state.attn, gained.reshape(b * k, -1), **_row(t))


def step_beams(
    decode_step: Callable, state: BeamState, t: Row, *,
    beam_size: int, eos_id: int = EOS, pad_id: int = PAD,
    active: Optional[torch.Tensor] = None,
) -> BeamState:
    """Advance every sentence's beams one step from full logits, in place
    (see the module docstring).
    ``decode_step(state [B*K,...], tokens [B*K]) -> (state, logits [B*K, V])``,
    with an extra ``align [B*K, T_src]`` when the state tracks coverage or
    attention. ``t``: a host int, or an int32 [1] device tensor holding
    the row; ``active`` ([B] bool): only those sentences step."""
    b, k = state.scores.shape
    new_dec, logits, align = _split(
        decode_step(state.decoder_state, state.last_token.reshape(-1)), state)
    v = logits.shape[-1]
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1).reshape(b, k, v)
    eos_row = torch.full((v,), NEG_INF, dtype=torch.float32, device=logp.device)
    eos_row.narrow(0, eos_id, 1).fill_(0.0)  # `eos_row[eos_id] = 0.0` would sync (a host copy)
    logp = torch.where(state.finished[..., None], eos_row, logp)
    cand = state.scores[..., None] + logp
    new_scores, flat_idx = topk_sorted(cand.reshape(b, k * v), beam_size)
    prev_fin = state.finished.clone() if align is not None else None
    flat_row = record_step(
        state.scores, state.finished, state.lengths, state.last_token, state.sym,
        state.parent, new_scores, flat_idx // v, flat_idx % v, eos_id=eos_id, pad_id=pad_id,
        active=active, **_row(t),
    )
    if align is not None:
        _record_alignment(state, align, prev_fin, flat_row, t, active)
    return state._replace(decoder_state=_gather_rows(new_dec, flat_row))


def step_beams_cand(
    decode_cand: Callable, state: BeamState, t: Row, *,
    beam_size: int, eos_id: int = EOS, pad_id: int = PAD,
    active: Optional[torch.Tensor] = None,
) -> BeamState:
    """Beam advance from per-beam top-k candidates
    ``decode_cand(state, tokens [B*K]) -> (state, (vals [B*K, kc],
    idx [B*K, kc], lse [B*K, 1]))`` (the fused generator's contract; with
    an extra ``align`` when the state tracks coverage or attention), in
    place (see the module docstring). Candidate scores, the per-sentence
    top-k over the [B, K*kc] candidates and the bookkeeping are one launch
    of the beam-advance kernel on the card (its plain version on the CPU);
    then the decoder state is reordered. ``t`` and ``active`` as in
    :func:`step_beams`. Equivalent to :func:`step_beams` whenever kc >=
    beam_size."""
    new_dec, (vals, idx, lse), align = _split(
        decode_cand(state.decoder_state, state.last_token.reshape(-1)), state)
    # the advance overwrites the flags: coverage needs the parents' own
    prev_fin = state.finished.clone() if align is not None else None
    flat_row = beam_advance(
        vals, idx, lse, state.scores, state.finished, state.lengths, state.last_token,
        state.sym, state.parent, eos_id=eos_id, pad_id=pad_id, active=active, **_row(t),
    )
    if align is not None:
        _record_alignment(state, align, prev_fin, flat_row, t, active)
    return state._replace(decoder_state=_gather_rows(new_dec, flat_row))


def expand_to_beams(tree, beam_size: int):
    """[B, ...] tree → [B*K, ...] by repeating each row K times."""
    return tree_map(lambda t: t.repeat_interleave(beam_size, dim=0), tree)


def finalize_scores(state: BeamState, cfg: BeamConfig) -> torch.Tensor:
    """Normalized hypothesis scores [B, K]: length and coverage penalties."""
    norm = state.scores / length_penalty(state.lengths, cfg.length_penalty)
    if cfg.coverage_penalty != 0.0:
        if state.coverage is None:
            raise ValueError("coverage_penalty set but coverage was not tracked: pass "
                             "coverage_len to beam_decode")
        norm = norm + coverage_penalty(state.coverage, cfg.coverage_penalty)
    return norm


def _check_cfg(cfg: BeamConfig) -> None:
    if not 1 <= cfg.n_best <= cfg.beam_size:
        raise ValueError(f"n_best={cfg.n_best} must be in [1, beam_size={cfg.beam_size}]")


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
    coverage_len: Optional[int] = None,
    return_attention: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Backend-agnostic beam core: ``cfg.max_len`` steps over any decoder.

    Returns ``(tokens [B, T], score [B])`` when ``cfg.n_best == 1``, else
    the top ``n_best`` by normalized score, ``(tokens [B, n, T], scores
    [B, n])``. With ``candidates=True`` the decoder returns per-beam top-k
    candidates instead of logits. With the coverage penalty or
    ``return_attention``, pass ``coverage_len`` (= T_src) and a decode step
    that also returns ``align [B*K, T_src]``; ``return_attention`` appends
    each returned hypothesis' per-step attention, ``[B, T, T_src]`` or
    ``[B, n, T, T_src]``."""
    _check_cfg(cfg)
    if cfg.coverage_penalty != 0.0 and coverage_len is None:
        raise ValueError("cfg.coverage_penalty requires coverage_len (T_src)")
    if return_attention and coverage_len is None:
        raise ValueError("return_attention requires coverage_len (T_src)")
    k = cfg.beam_size
    leaves = []
    tree_map(leaves.append, dec_state_beams)
    device = leaves[0].device
    state = init_beam_state(
        dec_state_beams, batch, k, cfg.max_len, bos_id=bos_id, pad_id=pad_id, device=device,
        coverage_len=coverage_len if cfg.coverage_penalty != 0.0 else None,
        attn_len=coverage_len if return_attention else None,
    )
    stepper = step_beams_cand if candidates else step_beams
    for t in range(cfg.max_len):
        state = stepper(decode_step, state, t, beam_size=k, eos_id=eos_id, pad_id=pad_id)
    norm = finalize_scores(state, cfg)
    tokens = reconstruct_tokens(state.sym, state.parent, k)
    attn = reconstruct_attention(state.attn, state.parent, k) if return_attention else None
    rows = torch.arange(batch, device=device)
    if cfg.n_best == 1:
        pick = torch.argmax(norm, dim=1)
        scores = norm[rows, pick]
    else:
        scores, pick = topk_sorted(norm, cfg.n_best)
        rows = rows[:, None]
    out = (tokens[rows, pick], scores)
    return out + ((attn[rows, pick],) if attn is not None else ())


def run_search(search: Callable, inputs, dev: torch.device, eager: bool, key):
    """``search(*inputs)`` with the inputs moved to ``dev``: called as it is
    on the CPU or when ``eager``, else replayed from the CUDA graph cached
    under ``key`` (captured at the first call; ``key`` must name everything
    besides the inputs' shapes that fixes the search's work)."""
    inputs = tuple(x.to(dev) for x in inputs)
    if dev.type == "cpu" or eager:
        return search(*inputs)
    return SEARCH_GRAPHS.run(key, search, inputs)


@spanned("serve.search")
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
) -> Tuple[torch.Tensor, ...]:
    """Translate a batch with the dense model: → (best tokens [B, max_len],
    best scores [B]) (or the n-best lists; ``return_attention`` appends the
    attention, see :func:`beam_decode`). ``model`` and the work live on
    ``device``. On the card the search runs as one CUDA graph, captured at
    the first call for this model, batch, source length and config
    (``_eager=True``: the eager step loop, for comparisons)."""
    _check_cfg(cfg)
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model is on {model.device}, not {dev}")
    k = cfg.beam_size
    with_align = cfg.coverage_penalty != 0.0 or return_attention

    def search(src, src_len):
        with torch.no_grad():
            enc_out, enc_mask, dec_state = model.encode(src, src_len)
            enc_out_b = enc_out.repeat_interleave(k, dim=0)
            enc_mask_b = enc_mask.repeat_interleave(k, dim=0)
            step = model.decode_step_attn if with_align else model.decode_step

            def decode_step(state, tokens):
                return step(state, tokens, enc_out_b, enc_mask_b)

            return beam_decode(
                decode_step, expand_to_beams(dec_state, k), src.shape[0], cfg,
                bos_id=bos_id, eos_id=eos_id, pad_id=pad_id, coverage_len=enc_out.shape[1],
                return_attention=return_attention,
            )

    key = ("beam_search", signature(model), cfg, return_attention, bos_id, eos_id, pad_id)
    return run_search(search, (src, src_len), dev, _eager, key)


def greedy_decode(
    model, src: torch.Tensor, src_len: torch.Tensor, max_len: int, *, device="cuda",
    bos_id: int = BOS, eos_id: int = EOS, pad_id: int = PAD,
) -> torch.Tensor:
    """Greedy decoding (beam size 1) with the dense model → tokens [B,
    max_len]."""
    cfg = BeamConfig(beam_size=1, max_len=max_len)
    tokens, _ = beam_search(model, src, src_len, cfg, device=device, bos_id=bos_id,
                            eos_id=eos_id, pad_id=pad_id)
    return tokens


def tokens_to_sentences(tokens, vocab, eos_id: int = EOS) -> list:
    """[B, T] token ids (a tensor or an array) → ``vocab.decode`` of each
    row up to its first EOS (any object with a ``decode(list of ids)``)."""
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.cpu().numpy()
    out = []
    for row in np.asarray(tokens):
        sent = []
        for tok in row:
            if tok == eos_id:
                break
            sent.append(int(tok))
        out.append(vocab.decode(sent))
    return out
