"""Beam combine and beam advance: per-sentence top-k of beam candidates.

PyTorch port of the JAX package's ``kernels/beam_combine.py``.

- :func:`beam_combine_topk`, the counterpart of the JAX public function,
  returns ``(scores [B, k] f32, pos [B, k] int32, token [B, k] int32)``,
  exactly ``jax.lax.top_k(cand, k)`` (ties to the lowest position) plus the
  winners' tokens.
- :func:`beam_advance` is the serving main path's form: one decode step's
  whole beam advance from the fused generator's per-beam candidates (the
  candidate scores, the per-sentence top-K in the same order, and the beam
  core's bookkeeping), leaving the beam state advanced in place. The
  continuous-batching engine gives it the history row as a device tensor
  ``pos`` (a captured CUDA graph replays the step while the row advances)
  and an ``active`` mask: an inactive sentence keeps its state.

Each runs its plain version (:func:`beam_combine_topk_reference`,
:func:`beam_advance_reference`) on a CPU tensor and, on a CUDA tensor, its
entry point of the hand-written one-warp-per-sentence kernel
``csrc/beam_combine.cu`` (or raises). ``beam_combine_topk.launches`` and
``beam_advance.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .topk_fused import topk_sorted

LANES = 128
ADVANCE_LANES = 64  # the advance kernel's K * kc limit (2 candidates a lane)
NEG_INF = -1e9  # a finished beam's non-EOS continuations
_P, _I = ctypes.c_void_p, ctypes.c_int
# qdt_beam_combine(cand, tok, B, n, k, out_v, out_pos, out_tok, stream)
_ARGTYPES = [_P, _P, _I, _I, _I, _P, _P, _P, _P]
# qdt_beam_advance(vals, idx, lse, scores, finished, lengths, last_token, sym,
#                  parent, flat_row, pos, active, B, K, kc, t, eos, pad, stream)
_ADVANCE_ARGTYPES = [_P] * 12 + [_I] * 6 + [_P]


def beam_combine_topk_reference(
    cand: torch.Tensor, cand_tok: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: stable descending sort, first k, token gather."""
    vals, pos = topk_sorted(cand, k)
    return vals, pos.to(torch.int32), torch.gather(cand_tok, 1, pos)


def beam_combine_topk(
    cand: torch.Tensor, cand_tok: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ ``(scores [B, k], pos [B, k], token [B, k])``; ``pos`` indexes the
    flattened candidate dim (the caller's parent beam is ``pos // kc``)."""
    b, n = cand.shape
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, candidate count {n}]")
    if cand_tok.shape != cand.shape:
        raise ValueError(f"tokens {tuple(cand_tok.shape)} vs candidates {tuple(cand.shape)}")
    if cand.device.type == "cpu":
        return beam_combine_topk_reference(cand, cand_tok.to(torch.int32), k)
    if cand.device.type != "cuda":
        raise ValueError(f"unsupported device {cand.device}")
    if n > LANES:
        raise ValueError(f"the combine kernel takes n <= {LANES} candidates, got {n}")
    if cand.dtype != torch.float32 or cand_tok.dtype != torch.int32:
        raise ValueError("candidates must be f32 and tokens int32")
    if cand_tok.device != cand.device:
        raise ValueError(f"operands on {cand_tok.device} and {cand.device}")
    if not (cand.is_contiguous() and cand_tok.is_contiguous()):
        raise ValueError("kernel operands must be contiguous")
    vals = torch.empty((b, k), dtype=torch.float32, device=cand.device)
    pos = torch.empty((b, k), dtype=torch.int32, device=cand.device)
    tok = torch.empty((b, k), dtype=torch.int32, device=cand.device)
    fn = _build.function("beam_combine", "qdt_beam_combine", _ARGTYPES)
    ptr = _build.ptr
    with _build.on(cand.device):
        err = fn(ptr(cand), ptr(cand_tok), b, n, k, ptr(vals), ptr(pos), ptr(tok),
                 _build.stream())
    _build.check(err, "beam_combine_topk")
    beam_combine_topk.launches += 1
    return vals, pos, tok


beam_combine_topk.launches = 0


def write_row(hist: torch.Tensor, row: torch.Tensor, t: Optional[int] = None,
              pos: Optional[torch.Tensor] = None) -> None:
    """``hist[t] = row`` for a host ``t``, or the row that the device int32
    [1] tensor ``pos`` holds (an index copy: reading ``pos`` on the host
    would be a sync, and a captured graph must see it change)."""
    if pos is None:
        hist[t] = row
    else:
        hist.index_copy_(0, pos.reshape(1).to(torch.int64), row[None])


def record_step(
    scores, finished, lengths, last_token, sym, parent, new_scores, parent_beam, token,
    t: Optional[int] = None, *, eos_id: int, pad_id: int,
    pos: Optional[torch.Tensor] = None, active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The beam core's bookkeeping after a step's top-K, in place: each new
    beam ``j`` of a sentence extends beam ``parent_beam[:, j]`` with
    ``token[:, j]`` (both [B, K] int64) at score ``new_scores``. Takes
    ``finished`` and ``lengths`` by parent, writes row ``t`` (or ``pos``,
    see :func:`write_row`) of the ``sym`` / ``parent`` histories (PAD where
    the parent had finished), tracks EOS and lengths, and stores the new
    scores and last tokens. With ``active`` ([B] bool), an inactive
    sentence keeps its scores, flags, lengths and last tokens. Returns the
    flat row ``b * K + parent`` [B*K] int64 each new beam reads its decoder
    state from (``b * K + k`` for an inactive sentence)."""
    b, k = scores.shape
    fin = torch.gather(finished, 1, parent_beam)
    lens = torch.gather(lengths, 1, parent_beam)
    write_row(sym, torch.where(fin, torch.full_like(token, pad_id), token).reshape(-1)
              .to(sym.dtype), t, pos)
    write_row(parent, parent_beam.reshape(-1).to(parent.dtype), t, pos)
    is_eos = token == eos_id
    new_lengths = lens + (~(fin | is_eos)).to(torch.int32)
    new_finished = fin | is_eos
    base = torch.arange(b, device=scores.device)[:, None] * k
    flat = base + parent_beam
    if active is not None:
        live = active[:, None]
        new_lengths = torch.where(live, new_lengths, lengths)
        new_finished = torch.where(live, new_finished, finished)
        new_scores = torch.where(live, new_scores, scores)
        token = torch.where(live, token, last_token)
        flat = torch.where(live, flat, base + torch.arange(k, device=scores.device))
    lengths.copy_(new_lengths)
    finished.copy_(new_finished)
    scores.copy_(new_scores)
    last_token.copy_(token)
    return flat.reshape(-1)


def beam_advance_reference(
    vals, idx, lse, scores, finished, lengths, last_token, sym, parent,
    t: Optional[int] = None, *, eos_id: int, pad_id: int,
    pos: Optional[torch.Tensor] = None, active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of :func:`beam_advance`: the candidate scores as the
    JAX package's ``step_beams_cand`` builds them, the combine's plain
    version, then :func:`record_step`."""
    b, k = scores.shape
    kc = vals.shape[-1]
    logp = (vals - lse).reshape(b, k, kc)
    cand_tok = idx.reshape(b, k, kc).to(torch.int32)
    # finished beams: a single EOS continuation at zero added score
    fin_logp = torch.full((kc,), NEG_INF, dtype=torch.float32, device=logp.device)
    fin_logp.narrow(0, 0, 1).fill_(0.0)  # `fin_logp[0] = 0.0` copies from the host: a sync
    fin = finished[..., None]
    logp = torch.where(fin, fin_logp, logp)
    cand_tok = torch.where(fin, torch.full_like(cand_tok, eos_id), cand_tok)
    cand = scores[..., None] + logp
    new_scores, cpos, token = beam_combine_topk_reference(
        cand.reshape(b, k * kc), cand_tok.reshape(b, k * kc), k
    )
    return record_step(
        scores, finished, lengths, last_token, sym, parent, new_scores,
        cpos.to(torch.int64) // kc, token.to(torch.int64), t, eos_id=eos_id, pad_id=pad_id,
        pos=pos, active=active,
    )


def beam_advance(
    vals: torch.Tensor,
    idx: torch.Tensor,
    lse: torch.Tensor,
    scores: torch.Tensor,
    finished: torch.Tensor,
    lengths: torch.Tensor,
    last_token: torch.Tensor,
    sym: torch.Tensor,
    parent: torch.Tensor,
    t: Optional[int] = None,
    *,
    eos_id: int,
    pad_id: int,
    pos: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One decode step's beam advance from per-beam candidates ``vals``,
    ``idx`` [B*K, kc] (f32, int32) and ``lse`` [B*K, 1] f32, in place:
    ``scores`` [B, K] f32, ``finished`` bool, ``lengths`` int32 and
    ``last_token`` int64 become the new beams', row ``t`` of ``sym`` [T,
    B*K] int32 and ``parent`` [T, B*K] int8 holds this step's symbols and
    backpointers. Returns the flat row ``b * K + parent`` [B*K] int64 each
    new beam reads its decoder state from. Exactly the JAX package's
    ``step_beams_cand`` tail (``lax.top_k`` tie order).

    The engine's form: ``pos`` (int32 [1], on the device; given in place
    of ``t``) is the history row, read by the kernel, and ``active`` ([B]
    bool) masks the sentences that step; an inactive one keeps its scores,
    flags, lengths and last tokens and gets the flat row ``b * K + k``. The
    kernel cannot check ``pos`` against the history's rows: the caller
    keeps it in range."""
    b, k = scores.shape
    kc = vals.shape[-1]
    rows = b * k
    if vals.shape != (rows, kc) or idx.shape != (rows, kc) or lse.shape != (rows, 1):
        raise ValueError(f"candidates {tuple(vals.shape)}, {tuple(idx.shape)}, lse "
                         f"{tuple(lse.shape)} do not match {b} x {k} beams")
    state = (finished, lengths, last_token)
    if any(x.shape != (b, k) for x in state):
        raise ValueError("scores, finished, lengths and last_token must all be [B, K]")
    if sym.shape != parent.shape or sym.dim() != 2 or sym.shape[1] != rows:
        raise ValueError(f"histories {tuple(sym.shape)}, {tuple(parent.shape)} vs {rows} rows")
    if (t is None) == (pos is None):
        raise ValueError("give the history row as exactly one of t and pos")
    if t is not None and not 0 <= t < sym.shape[0]:
        raise ValueError(f"step {t} outside the history's {sym.shape[0]} rows")
    if pos is not None and (pos.numel() != 1 or pos.dtype != torch.int32):
        raise ValueError(f"pos must be one int32 element, got {tuple(pos.shape)} {pos.dtype}")
    if active is not None and (active.shape != (b,) or active.dtype != torch.bool):
        raise ValueError(f"active must be [{b}] bool, got {tuple(active.shape)} {active.dtype}")
    if vals.device.type == "cpu":
        return beam_advance_reference(vals, idx, lse, scores, finished, lengths, last_token,
                                      sym, parent, t, eos_id=eos_id, pad_id=pad_id, pos=pos,
                                      active=active)
    if vals.device.type != "cuda":
        raise ValueError(f"unsupported device {vals.device}")
    if not (1 <= k <= 32 and k * kc <= ADVANCE_LANES):
        raise ValueError(f"the advance kernel takes K <= 32 and K * kc <= {ADVANCE_LANES}, "
                         f"got K={k}, kc={kc}")
    dtypes = ((vals, torch.float32), (idx, torch.int32), (lse, torch.float32),
              (scores, torch.float32), (finished, torch.bool), (lengths, torch.int32),
              (last_token, torch.int64), (sym, torch.int32), (parent, torch.int8))
    optional = tuple((x, x.dtype) for x in (pos, active) if x is not None)
    for x, dt in dtypes + optional:
        if x.dtype != dt:
            raise ValueError(f"beam_advance operand of dtype {x.dtype}, expected {dt}")
        if x.device != vals.device:
            raise ValueError(f"operands on {x.device} and {vals.device}")
        if not x.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    flat_row = torch.empty(rows, dtype=torch.int64, device=vals.device)
    fn = _build.function("beam_combine", "qdt_beam_advance", _ADVANCE_ARGTYPES)
    ptr = _build.ptr
    with _build.on(vals.device):
        err = fn(ptr(vals), ptr(idx), ptr(lse), ptr(scores), ptr(finished), ptr(lengths),
                 ptr(last_token), ptr(sym), ptr(parent), ptr(flat_row), ptr(pos), ptr(active),
                 b, k, kc, 0 if t is None else t, eos_id, pad_id, _build.stream())
    _build.check(err, "beam_advance")
    beam_advance.launches += 1
    return flat_row


beam_advance.launches = 0
