"""Continuous-batching beam-search serving engine.

PyTorch port of the JAX package's ``serve/engine.py``, with its names and
public API. A fixed grid of ``max_slots`` sentences x ``beam_size`` beams
decodes in lockstep; sentences join and leave between chunks of decode
steps without any change of shape.

- All decode state lives in preallocated device tensors: the decoder state
  ([S*K, ...], a ``FusedDecState`` on the packed path), the per-slot
  encoder tensors ([S, T_src, ...]; the packed decode body folds the beams
  of a slot itself, the dense model gets them row-expanded inside the
  step), and the beam bookkeeping ([S, K] scores, flags, lengths, last
  tokens; the optional [S, K, T_src] coverage accumulator).
- Histories are a flat ``[T_hist, S*K]`` ring: every slot writes its
  backpointers at one shared ring row per inner step, so a slot admitted at
  global step ``g0`` owns the window ``[g0, g0 + t) mod T_hist``, unrolled
  at extraction (:func:`.beam.unroll_ring`). ``T_hist = max_tgt_len +
  max(64, chunk_steps, chunk_steps_busy)``: the headroom covers the steps a
  finished slot can wait for its extraction.
- Each slot sits at its own depth ``t_vec[s]``; inactive slots keep their
  beam state (the beam core's ``active`` mask). A slot is done when all its
  beams have finished or ``t_vec + 1 >= max_tgt_len``, read from ``t_vec``
  before it advances.
- Admission is batched: up to ``admit_batch`` queued sentences are encoded
  at that one width and their real rows scattered into free slots
  (``index_copy_`` with the slots the host chose; the padding rows of the
  batch are never written). ``stage_ahead`` pre-encodes batches before
  slots free up.
- Stepping is chunked. The decode step over the grid's tensors, with the
  ring row ``pos``, ``t_vec``, the active mask, the done flags and the
  emitted-token count in device tensors that the step itself updates, is
  captured once as a CUDA graph on the card (at construction, on the empty
  grid with every slot inactive), and a chunk of ``n`` steps is ``n``
  replays. The host uploads the slot bookkeeping once before a chunk and
  reads the done flags, ``t_vec`` and the count back once after it; the
  replays run under ``torch.cuda.set_sync_debug_mode("error")``, so a host
  sync inside a chunk raises. On the CPU the same step runs eagerly.
- Extraction reconstructs, ranks and returns only the done slots'
  ``[E, n_best, T]`` hypotheses (``topk_sorted``, ``lax.top_k``'s order),
  with the length and coverage penalties.

Three decode backends, as in the JAX package: the dense model
(``decode_step``, or ``decode_step_attn`` with the coverage penalty), the
packed logits path (``beam_size > KMAX``), and the packed candidate path
(the fused generator kernel, then the beam-advance kernel).

On a mesh (``mesh=``, one process per rank, see :mod:`..parallel`) the slot
grid splits over ``data`` and the generator over ``model``
(``sharded.shard_decoder``): every rank runs the same host bookkeeping
(queue, admission, slot table) on the same submitted requests and holds
device tensors for its own ``max_slots / dp`` slots only; its decode step
is the sharded one (``sharded.make_sharded_decode_step_topk``). The
once-a-chunk readback of done flags, depths and emitted tokens and the
extracted hypotheses are gathered over ``data``, so every rank returns the
same completions. On NCCL the step is a CUDA graph with its collectives
inside; on gloo it runs eagerly.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..config import ServeConfig
from ..kernels.topk_fused import KMAX, topk_sorted
from ..parallel.comm import all_gather, capturable, warm_up
from ..parallel.mesh import DATA_AXIS, axis_index, axis_size
from ..utils.graphs import CapturedStep, host_syncs_raise, signature
from .beam import (
    BOS,
    EOS,
    NEG_INF,
    PAD,
    PARENT_DTYPE,
    BeamState,
    coverage_penalty,
    length_penalty,
    reconstruct_tokens,
    run_search,
    step_beams,
    step_beams_cand,
    tree_map,
    unroll_ring,
)
from .infer import check_whole_vocab, encode_packed, packed_decode_step, packed_decode_step_topk
from .sharded import make_sharded_decode_step_topk


@dataclass
class Completion:
    request_id: int
    tokens: np.ndarray  # best hypothesis [max_tgt_len] int32, PAD after EOS
    score: float
    # with cfg.beam.n_best > 1: the n-best list, best first
    nbest_tokens: Optional[np.ndarray] = None  # [n_best, max_tgt_len]
    nbest_scores: Optional[np.ndarray] = None  # [n_best]


def _leaf_pairs(dst, src):
    """The (``dst``, ``src``) leaf pairs of two trees of one structure
    (tensors, tuples, dataclasses)."""
    if isinstance(dst, torch.Tensor):
        yield dst, src
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src):
            yield from _leaf_pairs(d, s)
    else:
        for f in dataclasses.fields(dst):
            yield from _leaf_pairs(getattr(dst, f.name), getattr(src, f.name))


class TranslationEngine:
    """Host-side orchestrator around the slot grid and its decode step.

    ``model`` (the port's ``Seq2Seq``) holds the weights; ``packed_decoder``
    (from ``infer.pack_decoder``) serves the decode steps on packed weights
    when given. Both live on ``device`` (default the card; ``"cpu"`` runs
    the plain versions). ``mesh`` (with a decoder from
    ``sharded.shard_decoder``) serves the grid sharded, slots over ``data``
    and the generator over ``model``; ``cfg.max_slots`` must divide the
    data axis and the beam fit the fused generator (``beam_size <=
    KMAX``)."""

    def __init__(
        self,
        model,
        cfg: ServeConfig,
        packed_decoder=None,
        *,
        device="cuda",
        mesh=None,
    ):
        self.dev = resolve_device(device)
        if model.device != self.dev or (
            packed_decoder is not None and packed_decoder.device != self.dev
        ):
            raise ValueError(f"model and decoder must live on {self.dev}")
        if not 1 <= cfg.beam.n_best <= cfg.beam.beam_size:
            raise ValueError(f"n_best={cfg.beam.n_best} must be in [1, beam_size]")
        self.mesh = mesh
        if mesh is None:
            if packed_decoder is not None:
                check_whole_vocab(packed_decoder)
            self._lo, self._s_loc = 0, cfg.max_slots
        else:
            dp = axis_size(mesh, DATA_AXIS)
            if cfg.max_slots % dp:
                raise ValueError(f"max_slots {cfg.max_slots} must divide data axis {dp}")
            if packed_decoder is not None and cfg.beam.beam_size > KMAX:
                raise ValueError(f"sharded serving requires beam_size <= {KMAX}")
            # this rank's slots: [lo, lo + s_loc) of the grid
            self._s_loc = cfg.max_slots // dp
            self._lo = axis_index(mesh, DATA_AXIS) * self._s_loc
        self.model = model
        self.cfg = cfg
        self.dec = packed_decoder
        # GNMT coverage penalty: a [S, K, T_src] accumulator, reset on
        # admission, gathered by parent in the beam core, applied at extraction
        self._cov = cfg.beam.coverage_penalty != 0.0
        self._next_id = 0
        self._poisoned = False  # set by drive_chunks(force_active=True)
        self._queue: List[Tuple[int, np.ndarray, int]] = []
        # encoded-but-not-admitted batches: their tensors and the (row,
        # request id) pairs still waiting for a slot
        self._staged: List[Dict[str, Any]] = []
        self._slot_req: List[Optional[int]] = [None] * cfg.max_slots
        self._slot_t = np.zeros(cfg.max_slots, np.int32)
        self._chunk_cap = max(64, cfg.chunk_steps, cfg.chunk_steps_busy or 0)
        self._t_hist = cfg.max_tgt_len + self._chunk_cap
        self._slot_g0 = np.zeros(cfg.max_slots, np.int32)  # admission ring row
        self._results: List[Completion] = []
        self.steps_run = 0
        self.tokens_emitted = 0
        self._build()

    # ---- the grid and its programs ----
    def _build(self):
        cfg, dev, model, dec, mesh = self.cfg, self.dev, self.model, self.dec, self.mesh
        s, k = self._s_loc, cfg.beam.beam_size  # the grid: this rank's slots
        t_src, t_max, t_hist = cfg.max_src_len, cfg.max_tgt_len, self._t_hist
        cov = self._cov

        def encode(src, src_len):
            with torch.no_grad():
                if dec is not None:
                    return encode_packed(model, dec, src, src_len)
                enc_out, enc_mask, state = model.encode(src, src_len)
                return enc_out, enc_out, enc_mask, state

        enc_key = ("engine_encode", signature(model), signature(dec))
        self._encode = lambda src, src_len: run_search(
            encode, (src, src_len), dev, False, enc_key)

        # probe encode at the admission width: the grid's shapes, and the
        # encoder's graph captured before the first request
        a = cfg.admit_batch
        probe = torch.full((a, t_src), PAD, dtype=torch.int64)
        probe[:, 0] = BOS
        keys, enc_out, _, state = self._encode(probe, torch.ones(a, dtype=torch.int64))
        self._enc_keys = torch.zeros((s, t_src, keys.shape[-1]), dtype=keys.dtype, device=dev)
        self._enc_out = torch.zeros((s, t_src, enc_out.shape[-1]), dtype=enc_out.dtype,
                                    device=dev)
        self._enc_mask = torch.zeros((s, t_src), dtype=torch.bool, device=dev)
        self._beam = BeamState(
            decoder_state=tree_map(
                lambda x: torch.zeros((s * k,) + x.shape[1:], dtype=x.dtype, device=dev), state),
            sym=torch.full((t_hist, s * k), PAD, dtype=torch.int32, device=dev),
            parent=torch.arange(k, dtype=PARENT_DTYPE, device=dev).repeat(t_hist, s),
            last_token=torch.full((s, k), BOS, dtype=torch.int64, device=dev),
            scores=torch.full((s, k), NEG_INF, dtype=torch.float32, device=dev),
            finished=torch.ones((s, k), dtype=torch.bool, device=dev),
            lengths=torch.zeros((s, k), dtype=torch.int32, device=dev),
            coverage=(torch.zeros((s, k, t_src), dtype=torch.float32, device=dev)
                      if cov else None),
        )
        self._init_scores = torch.full((k,), NEG_INF, dtype=torch.float32, device=dev)
        self._init_scores.narrow(0, 0, 1).fill_(0.0)  # only beam 0 alive at admission
        self._beam_iota = torch.arange(k, device=dev)
        # the step's control state, on the device: ring row, per-slot depth,
        # the slots stepping, the chunk's done flags and emitted tokens
        i32 = dict(dtype=torch.int32, device=dev)
        self._ctrl = torch.zeros(2 * s + 1, **i32)  # upload buffer: t_vec | active | pos
        self._pos = torch.zeros(1, **i32)
        self._t_vec = torch.zeros(s, **i32)
        self._active0 = torch.zeros(s, dtype=torch.bool, device=dev)
        self._active = torch.zeros(s, dtype=torch.bool, device=dev)
        self._done = torch.zeros(s, dtype=torch.bool, device=dev)
        self._emitted = torch.zeros(1, **i32)

        use_cand = dec is not None and k <= KMAX
        enc_keys, enc_out, enc_mask = self._enc_keys, self._enc_out, self._enc_mask
        if dec is not None and mesh is not None:
            sharded_step = make_sharded_decode_step_topk(dec, mesh, k, with_align=cov)

            def decode_step(st, tokens):
                return sharded_step(st, tokens, enc_keys, enc_out, enc_mask)
        elif dec is not None:
            if use_cand:
                def decode_step(st, tokens):
                    return packed_decode_step_topk(dec, st, tokens, enc_keys, enc_out, enc_mask,
                                                   k, with_align=cov)
            else:
                def decode_step(st, tokens):
                    return packed_decode_step(dec, st, tokens, enc_keys, enc_out, enc_mask,
                                              with_align=cov)
        else:
            model_step = model.decode_step_attn if cov else model.decode_step

            def decode_step(st, tokens):
                # the grid keeps encoder tensors per slot; the dense model's
                # attention takes them row-expanded
                return model_step(st, tokens, enc_out.repeat_interleave(k, dim=0),
                                  enc_mask.repeat_interleave(k, dim=0))

        stepper = step_beams_cand if use_cand else step_beams
        # locals, not self: the step holds no reference back to the engine
        beam, active, t_vec, pos = self._beam, self._active, self._t_vec, self._pos
        done_acc, emitted = self._done, self._emitted

        def one_step():
            with torch.no_grad():
                new = stepper(decode_step, beam, pos, beam_size=k, eos_id=EOS, pad_id=PAD,
                              active=active)
                # an inactive slot's decoder state is left stepped: it is
                # garbage until its next admission overwrites it
                for dst, src in _leaf_pairs(beam.decoder_state, new.decoder_state):
                    dst.copy_(src)
                done = active & (beam.finished.all(dim=1) | (t_vec + 1 >= t_max))
                emitted.add_(active.sum())
                t_vec.add_(active.to(torch.int32))
                done_acc.logical_or_(done)
                active.logical_and_(~done)
                pos.add_(1).remainder_(t_hist)

        self._one_step = one_step
        # every slot is inactive here, so the capture's warm-up step changes
        # nothing that extraction reads; a gloo mesh steps eagerly
        on_graph = dev.type == "cuda" and (mesh is None or capturable(mesh, dev))
        if on_graph and mesh is not None:
            warm_up(mesh)
        self._graph = CapturedStep(one_step) if on_graph else None

    def _replay(self, n: int) -> None:
        if self._graph is not None:
            self._graph.replay(n)
        else:
            for _ in range(n):
                self._one_step()

    def _mine(self, slots) -> np.ndarray:
        """The grid's ``slots`` that this rank holds."""
        slots = np.asarray(slots, np.int64)
        return slots[(slots >= self._lo) & (slots < self._lo + self._s_loc)]

    def _drive(self, active0: np.ndarray, n: int, n_chunks: int):
        """Upload the slot depths, ``active0`` and the ring row (one copy),
        run ``n_chunks`` chunks of ``n`` steps (each starts from
        ``active0``), then read back once: (the last chunk's done flags,
        ``t_vec``, its emitted tokens), of every slot of the grid (on a mesh
        gathered over ``data``)."""
        s, lo = self._s_loc, self._lo
        ctrl = np.concatenate([self._slot_t[lo:lo + s], active0[lo:lo + s].astype(np.int32),
                               [self.steps_run % self._t_hist]]).astype(np.int32)
        self._ctrl.copy_(torch.from_numpy(ctrl))
        self._t_vec.copy_(self._ctrl[:s])
        self._active0.copy_(self._ctrl[s:2 * s] != 0)
        self._pos.copy_(self._ctrl[2 * s:])
        with host_syncs_raise() if self._graph is not None else contextlib.nullcontext():
            for _ in range(n_chunks):
                self._active.copy_(self._active0)
                self._done.zero_()
                self._emitted.zero_()
                self._replay(n)
        back = torch.cat([self._done.to(torch.int32), self._t_vec, self._emitted])
        if self.mesh is not None:
            back = all_gather(back, self.mesh, DATA_AXIS)
        back = back.reshape(-1, 2 * s + 1).cpu().numpy()
        self.steps_run += n * n_chunks
        return (back[:, :s].reshape(-1).astype(bool), back[:, s:2 * s].reshape(-1).copy(),
                int(back[:, 2 * s].sum()))

    def _insert(self, tensors, rows: List[int], slots: List[int]) -> None:
        """Rows ``rows`` of an encoded admission batch into slots ``slots``:
        encoder tensors, the decoder state (repeated over the beams) and a
        fresh beam state; only those rows are written."""
        keys, enc_out, enc_mask, state = tensors
        k = self.cfg.beam.beam_size
        lo, hi = self._lo, self._lo + self._s_loc
        mine = [(r, sl - lo) for r, sl in zip(rows, slots) if lo <= sl < hi]
        if not mine:
            return
        rows, slots = [r for r, _ in mine], [sl for _, sl in mine]
        idx = torch.tensor([rows, slots], dtype=torch.int64).to(self.dev)
        src, dst = idx[0], idx[1]
        for grid, new in ((self._enc_keys, keys), (self._enc_out, enc_out),
                          (self._enc_mask, enc_mask)):
            grid.index_copy_(0, dst, new.index_select(0, src))
        beam = self._beam
        beam_rows = (dst[:, None] * k + self._beam_iota).reshape(-1)
        for grid, new in _leaf_pairs(beam.decoder_state, state):
            grid.index_copy_(0, beam_rows, new.index_select(0, src).repeat_interleave(k, dim=0))
        beam.last_token.index_fill_(0, dst, BOS)
        beam.scores.index_copy_(0, dst, self._init_scores.expand(len(slots), k))
        beam.finished.index_fill_(0, dst, False)
        beam.lengths.index_fill_(0, dst, 0)
        if beam.coverage is not None:
            beam.coverage.index_fill_(0, dst, 0.0)
        # the ring needs no reset: a slot's window starts at its admission row

    def _extract_all(self, slots: np.ndarray):
        """The done ``slots``' hypotheses → (tokens [E, n_best, max_tgt_len],
        scores [E, n_best]) on the host, extracted ``admit_batch`` slots at a
        time; on a mesh each rank extracts its own and the results are
        gathered over ``data``."""
        e = self.cfg.admit_batch
        if self.mesh is None:
            parts = [self._extract(slots[i:i + e]) for i in range(0, len(slots), e)]
            return np.concatenate([t for t, _ in parts]), np.concatenate([v for _, v in parts])
        cfg, s = self.cfg, self._s_loc
        toks = torch.zeros((s, cfg.beam.n_best, cfg.max_tgt_len), dtype=torch.int64,
                           device=self.dev)
        scores = torch.zeros((s, cfg.beam.n_best), dtype=torch.float32, device=self.dev)
        mine = self._mine(slots)
        for i in range(0, len(mine), e):
            part = mine[i:i + e]
            t, v = self._extract(part, host=False)
            at = torch.from_numpy(part - self._lo).to(self.dev)
            toks.index_copy_(0, at, t.to(torch.int64))
            scores.index_copy_(0, at, v)
        toks = all_gather(toks, self.mesh, DATA_AXIS).flatten(0, 1).cpu().numpy()
        scores = all_gather(scores, self.mesh, DATA_AXIS).flatten(0, 1).cpu().numpy()
        return toks[slots], scores[slots]

    def _extract(self, slots: np.ndarray, host: bool = True):
        """Reconstruct and rank the done slots' hypotheses (this rank's) on
        the device → (tokens [E, n_best, max_tgt_len], scores [E, n_best]),
        on the host unless ``host`` is False."""
        cfg = self.cfg
        k, t_max = cfg.beam.beam_size, cfg.max_tgt_len
        idx = torch.from_numpy(np.stack([slots - self._lo, self._slot_g0[slots],
                                         self._slot_t[slots]]).astype(np.int64)).to(self.dev)
        sl, g0, t_len = idx[0], idx[1], idx[2]
        beam = self._beam
        cols = (sl[:, None] * k + self._beam_iota).reshape(-1)
        sym, par = unroll_ring(beam.sym.index_select(1, cols), beam.parent.index_select(1, cols),
                               g0, t_len, beam_size=k, pad_id=PAD)
        # rows past a slot's depth are PAD / identity: the first max_tgt_len
        # rows backtrace to the same hypotheses as the whole ring
        toks = reconstruct_tokens(sym[:t_max], par[:t_max], k)
        norm = beam.scores[sl] / length_penalty(beam.lengths[sl], cfg.beam.length_penalty)
        if beam.coverage is not None:
            norm = norm + coverage_penalty(beam.coverage[sl], cfg.beam.coverage_penalty)
        top, order = topk_sorted(norm, cfg.beam.n_best)
        toks = torch.gather(toks, 1, order[:, :, None].expand(-1, -1, t_max))
        return (toks.cpu().numpy(), top.cpu().numpy()) if host else (toks, top)

    # ---- public API ----
    def submit(self, src_tokens) -> int:
        """Queue a tokenized source sentence; returns the request id."""
        rid = self._next_id
        self._next_id += 1
        arr = np.full(self.cfg.max_src_len, PAD, np.int64)
        n = min(len(src_tokens), self.cfg.max_src_len)
        arr[:n] = np.asarray(src_tokens[:n], np.int64)
        self._queue.append((rid, arr, n))
        return rid

    @property
    def pending(self) -> int:
        return len(self._queue) + sum(len(b["pending"]) for b in self._staged)

    @property
    def active_slots(self) -> int:
        return sum(r is not None for r in self._slot_req)

    def _encode_queued(self, take: int):
        """Encode the next ``take`` queued sentences at the admission width
        → (tensors, [(row, request id)])."""
        cfg = self.cfg
        src = np.full((cfg.admit_batch, cfg.max_src_len), PAD, np.int64)
        src[:, 0] = BOS  # filler rows, never admitted
        lens = np.ones(cfg.admit_batch, np.int64)
        pending = []
        for j in range(take):
            rid, arr, n = self._queue.pop(0)
            src[j], lens[j] = arr, n
            pending.append((j, rid))
        return self._encode(torch.from_numpy(src), torch.from_numpy(lens)), pending

    def _stage(self):
        """Pre-encode queued sentences into admission batches (up to
        ``cfg.stage_ahead`` of them), whether or not a slot is free."""
        while self._queue and len(self._staged) < self.cfg.stage_ahead:
            tensors, pending = self._encode_queued(min(len(self._queue), self.cfg.admit_batch))
            self._staged.append({"tensors": tensors, "pending": pending})

    def _book_admissions(self, admitted):
        for slot, rid in admitted:
            self._slot_req[slot] = rid
            self._slot_t[slot] = 0
            # the slot's ring window starts at the next inner step
            self._slot_g0[slot] = self.steps_run % self._t_hist

    def _admit_rows(self, tensors, pending, free):
        """Admit staged rows into free slots, in order, as far as they go."""
        take = min(len(pending), len(free))
        rows, slots, admitted = [], [], []
        for _ in range(take):
            row, rid = pending.pop(0)
            slot = free.pop(0)
            rows.append(row)
            slots.append(slot)
            admitted.append((slot, rid))
        self._insert(tensors, rows, slots)
        self._book_admissions(admitted)

    def _admit(self):
        free = [i for i, r in enumerate(self._slot_req) if r is None]
        # staged batches first (FIFO); a partly admitted batch stays staged
        while self._staged and free:
            batch = self._staged[0]
            self._admit_rows(batch["tensors"], batch["pending"], free)
            if not batch["pending"]:
                self._staged.pop(0)
        while self._queue and free:
            tensors, pending = self._encode_queued(
                min(len(self._queue), len(free), self.cfg.admit_batch))
            self._admit_rows(tensors, pending, free)

    def step(self, chunk_steps: Optional[int] = None) -> List[Completion]:
        """Admit pending work, run one decode chunk, pop completed slots.

        One chunk = ``chunk_steps`` decode steps with one readback at its
        end; the counters count inner steps. Default: ``cfg.chunk_steps``,
        or ``cfg.chunk_steps_busy`` while requests wait in the queue (a
        completion strands its slot only until the chunk ends)."""
        if self._poisoned:
            raise RuntimeError(
                "engine state was force-advanced by drive_chunks(force_active=True): "
                "empty slots were stepped from garbage; build a fresh TranslationEngine "
                "to serve"
            )
        self._admit()
        self._stage()  # pre-encode the next arrivals
        active = np.array([r is not None for r in self._slot_req])
        if not active.any():
            return []
        if chunk_steps is None:
            busy = self.cfg.chunk_steps_busy or self.cfg.chunk_steps
            chunk_steps = busy if self._queue else self.cfg.chunk_steps
        if chunk_steps > self._chunk_cap:
            raise ValueError(
                f"chunk_steps {chunk_steps} exceeds the ring-history headroom "
                f"{self._chunk_cap} (a finished slot's window would be overwritten before "
                "extraction)"
            )
        done, self._slot_t, emitted = self._drive(active, chunk_steps, 1)
        self.tokens_emitted += emitted
        out: List[Completion] = []
        done_slots = np.where(done)[0]
        n_best = self.cfg.beam.n_best
        if len(done_slots):
            toks, scores = self._extract_all(done_slots)
        for j, slot in enumerate(done_slots):
            comp = Completion(request_id=self._slot_req[slot], tokens=toks[j, 0].copy(),
                              score=float(scores[j, 0]))
            if n_best > 1:
                comp.nbest_tokens = toks[j].copy()
                comp.nbest_scores = scores[j].copy()
            out.append(comp)
            self._slot_req[slot] = None
            self._slot_t[slot] = 0
        self._results.extend(out)
        return out

    def drive_chunks(
        self, n_chunks: int, force_active: bool = True, chunk_steps: Optional[int] = None
    ) -> int:
        """Advance the whole grid ``n_chunks`` chunks with no readback
        between them, then read back once and return the last chunk's
        emitted tokens (the timing entry point).

        ``force_active=True`` steps every slot, live or not (a full grid
        decoding forever); completions are not extracted and empty slots
        step from garbage, so the engine is poisoned for :meth:`step`. With
        ``force_active=False`` only live slots step and their depths are
        kept, so :meth:`step` stays usable."""
        s = self.cfg.max_slots
        active = (np.ones(s, bool) if force_active
                  else np.array([r is not None for r in self._slot_req]))
        n = chunk_steps or self.cfg.chunk_steps
        if n > self._chunk_cap:
            raise ValueError(f"chunk_steps {n} exceeds the ring-history headroom "
                             f"{self._chunk_cap}")
        if not force_active and n_chunks * n > self._chunk_cap:
            # a slot done in the first chunk waits, unextracted, for the whole
            # drive: past the headroom its ring window would be overwritten
            raise ValueError(
                f"drive_chunks(force_active=False): n_chunks*chunk_steps {n_chunks * n} "
                f"exceeds the ring-history headroom {self._chunk_cap}; interleave step() "
                "to extract, or drive fewer chunks"
            )
        _, t_vec, emitted = self._drive(active, n, n_chunks)
        if force_active:
            self._poisoned = True
        else:
            self._slot_t = t_vec
        return emitted

    def run_until_drained(self, max_steps: int = 100000) -> List[Completion]:
        """Drive until queue and slots are empty; returns all completions."""
        out: List[Completion] = []
        steps = 0
        while (self.pending or self.active_slots) and steps < max_steps:
            out.extend(self.step())
            steps += 1
        return out
