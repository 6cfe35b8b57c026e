"""Multi-card smoke of the port's mesh paths: one NCCL rank a card, every
path graphed, each held to the one-process port.

The parent builds the kernels once, then spawns ``--cards`` ranks
(:func:`..parallel.launch.run_ranks`, NCCL, rank ``r`` on card ``r``
through :func:`..parallel.launch.rank_device`). With ``--device cuda`` and
fewer cards than ``--cards`` it raises: NCCL takes one rank a card, and
nothing here falls back to gloo. ``--device cpu`` runs the same checks over
gloo with the kernels' plain versions (at small widths, for the tests): no
kernel launches there, and no path is graphed. Every rank runs, on every
mesh ``(data, model)`` with ``data * model = cards``, in this order:

1. the sharded packed search (``shard_decoder`` → ``beam_search_sharded``),
   uniform f32 and bf16 and exact-LUT f32, on a capturing call and a
   replay: launches 3 / 1 / 1 a step a rank, ``3 T + 2`` all-gathers a
   search, graphed equal to eager, every rank's tokens and scores equal;
   the f32 tokens equal the one-process ``beam_search_packed`` on card 0
   except in sentences where that search had a candidate within
   ``TIE_ULPS`` ulps of a beam's last place (or of the best final score):
   the sharded logsumexp sums the shards' in another order. Before it,
   the sharded decode step against the unsharded one on the same state
   (indices equal, values and lse within ``F32_TOL``) and each kernel at this
   rank's shapes against its plain version (rtol = atol = ``F32_TOL``; the
   beam advance bit-exact);
2. on meshes with ``data`` > 1, ``TranslationEngine(mesh=)``: ``--requests``
   requests, the first alone (so the other ranks' slots are all empty for
   a chunk), each result equal to the offline sharded search on the same
   mesh, every rank replaying the same chunks;
3. the graphed KD steps (``make_train_step``), each three eager runs and a
   graphed one of ``--train-steps`` SGD steps from copies of one state
   (:func:`graph_leg`, which ``chip_smoke.py``'s graphed steps run too):
   bit-equal where the eager runs are, else within twice their gap; one
   capture; the eager step's collectives at every replay; one fake-quant
   launch a rank a step (none in ``joint``). The first step is held to the
   one-process step on the whole batch (loss ``LOSS_RTOL``, weights
   ``W_RTOL`` / ``W_ATOL``; the bf16 reduce ``BF16_W_RTOL`` /
   ``BF16_W_ATOL``; a tensor-parallel rank's shards to the slices of the
   whole step's): seq2seq data parallel at ``(cards, 1)`` (f32 and bf16
   reduce), seq2seq tensor parallel at every mesh with ``model`` > 1 (modes
   ``weights`` and ``joint``), the LM tensor parallel at ``(cards / 2, 2)``
   with its carry threaded, WRN-28-10 → WRN-16-4 data parallel at
   ``(cards, 1)`` under deterministic cuDNN (its running statistics are the
   shards' mean, so no one-process step);

then the parent runs ``graft_entry.dryrun_multichip(cards)`` (no smoke
subprocess; on the card held to the same dry run on the CPU: tokens equal,
scores and losses within ``F32_TOL``). Batches are ``--train-batch``
(``--lm-batch``, ``--vision-batch``) rows a data slice.

The harness checks and does not time: the four-card step's speed is the
benchmark's (``portbench``, cell ``nmt-kd-train-dp4``).

The last line is one JSON object, ``{"ok": true, "cards": N, ...}``; any
failed check prints it and exits 1 without that line. ``--out PATH``
writes the whole report (tokens included) as JSON.

    python -m quantized_distillation_tpu_torch.scripts.multicard_smoke --cards 4
    python -m quantized_distillation_tpu_torch.scripts.multicard_smoke --cards 4 --device cpu \\
        --preset student_small --teacher student_small --vocab 12388 --batch 8 --beam 3 \\
        --src-len 4 --train-batch 4 --train-steps 1 --lm-teacher student_small \\
        --lm-student student_small --lm-vocab 40 --lm-batch 2 --lm-bptt 4 \\
        --wrn-teacher student_small --wrn-student student_small --vision-batch 2 \\
        --vision-size 8 --requests 8
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import torch

from .. import graft_entry
from ..config import BeamConfig, DistillSpec, QuantSpec, ServeConfig, TrainConfig
from ..convert import params_to_numpy
from ..kernels import (
    LAUNCH_COUNTERS,
    _build,
    beam_advance,
    beam_advance_reference,
    dequant_matmul,
    dequant_matmul_reference,
    dequant_matmul_topk,
    dequant_matmul_topk_reference,
    launch_counts,
    pick_generator_group,
    set_launch_counts,
)
from ..models import SEQ2SEQ_PRESETS, make_lm, make_seq2seq, make_wrn
from ..parallel import (
    DATA_AXIS,
    ModelParallel,
    make_mesh,
    place_batch,
    place_params_lm,
    place_params_seq2seq,
    placed_pspecs,
)
from ..parallel.comm import capturable, collective_budget
from ..parallel.launch import rank_device, run_ranks
from ..parallel.mesh import axis_index, axis_size
from ..serve import (
    TranslationEngine,
    beam_search_packed,
    encode_packed,
    expand_to_beams,
    make_sharded_decode_step_topk,
    pack_decoder,
    packed_decode_step_topk,
    shard_decoder,
)
from ..serve.beam import BOS, EOS, NEG_INF, PAD, finalize_scores, init_beam_state, step_beams_cand
from ..serve.sharded import beam_search_sharded
from ..train import (
    build_optimizer,
    create_train_state,
    lm_initial_carry,
    lm_task,
    make_train_step,
    nmt_task,
    vision_task,
)
from ..train.trainer import _clone_state, _leaves, _state_tensors

F32_TOL = 1e-4  # rtol = atol, as tests/test_kernels.py states for f32 compute
BF16_TIE = 4 * 2.0 ** -8  # bf16 tie band (TestCrossKernelNumerics), times max(|logit|, 1)
LOSS_RTOL, W_RTOL, W_ATOL = 1e-5, 1e-5, 1e-6  # the mesh step against the one-process step
BF16_W_RTOL, BF16_W_ATOL = 0.05, 1e-4  # weights after a bf16 gradient reduce
TIE_ULPS = 2  # a candidate this close to a beam's last place may swap under the sharded lse
STEP_CHECKS = 4  # decode steps of the sharded step against the unsharded one
SGD = TrainConfig(learning_rate=1e-2, optimizer="sgd")  # SGD: Adam's first step is lr * sign(g)
SEARCHES = ("f32", "bf16", "lut_f32")


class Checks:
    """Failed checks, in order; the run fails if any."""

    def __init__(self):
        self.failed = []

    def require(self, ok: bool, what: str) -> bool:
        if not ok:
            self.failed.append(what)
            print(f"CHECK FAILED: {what}", file=sys.stderr, flush=True)
        return bool(ok)


def meshes(cards: int) -> list:
    """Every (data, model) mesh of ``cards`` ranks, model widest first."""
    return [(cards // m, m) for m in range(cards, 0, -1) if cards % m == 0]


def lm_mesh(cards: int) -> tuple:
    return (cards // 2, 2) if cards % 2 == 0 else (cards, 1)


def tp_meshes(cards: int) -> list:
    return [m for m in meshes(cards) if m[1] > 1] or [(cards, 1)]


def serve_inputs(args):
    """The serving phases' seeded sources: B sentences of ``src_len``
    tokens."""
    gen = torch.Generator().manual_seed(args.seed + 1)
    src = torch.randint(4, args.vocab, (args.batch, args.src_len), generator=gen)
    return src, torch.full((args.batch,), args.src_len, dtype=torch.int64)


def engine_sources(a):
    """``--requests`` seeded sentences of 2 to ``src_len`` tokens, padded
    into a batch → (sentences, src, src_len)."""
    gen = torch.Generator().manual_seed(a.seed + 60)
    lens = torch.randint(2, a.src_len + 1, (a.requests,), generator=gen)
    sents = [torch.randint(4, a.vocab, (int(n),), generator=gen).tolist() for n in lens]
    src = torch.zeros((a.requests, a.src_len), dtype=torch.int64)
    for i, s in enumerate(sents):
        src[i, :len(s)] = torch.tensor(s)
    return sents, src, lens.to(torch.int64)


def lut_points(bits: int, gen) -> torch.Tensor:
    """A trained-looking codebook: out of order, partly outside [0, 1]."""
    return torch.rand(1 << bits, generator=gen) * 1.2 - 0.1


def decoders(a, model, dev) -> dict:
    """The packed decoders of the three searches."""
    params = params_to_numpy(model)
    kw = dict(generator_group=pick_generator_group(a.batch * a.beam), device=dev)
    points = lut_points(a.bits, torch.Generator().manual_seed(a.seed + 3))
    return {"f32": pack_decoder(params, model.cfg, a.bits, compute_dtype=torch.float32, **kw),
            "bf16": pack_decoder(params, model.cfg, a.bits, compute_dtype=torch.bfloat16, **kw),
            "lut_f32": pack_decoder(params, model.cfg, a.bits, compute_dtype=torch.float32,
                                    points=points, lut_mode="exact", **kw)}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def zero_counts() -> None:
    set_launch_counts({name: 0 for name in LAUNCH_COUNTERS})


# The LSTM cell's kernels launch wherever a model's LSTM runs on the card, as
# often as its layers and time steps say; the path checks hold the serving
# and train kernels (chip_smoke.phase_lstm_kernel holds the cell's).
CELL_COUNTERS = ("lstm_cell", "lstm_cell_backward")


def path_counts(counts: dict) -> dict:
    """``counts`` without the LSTM cell's counters."""
    return {name: n for name, n in counts.items() if name not in CELL_COUNTERS}


def expected(on_card: bool, **counts) -> dict:
    """Every counter but the cell's at 0 except those given; all 0 off the
    card, where the plain versions run and no kernel launches."""
    return path_counts({name: counts.get(name, 0) if on_card else 0 for name in LAUNCH_COUNTERS})


def search_launches(on_card: bool, steps: int, layers: int, lut: bool) -> dict:
    """A search's launches: each step one dequant-matmul a layer and one for
    ``attn_out``, one generator, one advance."""
    dm, gen = ("dequant_matmul_lut", "dequant_matmul_topk_lut") if lut else (
        "dequant_matmul", "dequant_matmul_topk")
    return expected(on_card, **{dm: (layers + 1) * steps, gen: steps, "beam_advance": steps})


# ------------------------------------------------------------ kernel checks


def check_values(checks, name, got, want) -> float:
    """|got - want| <= F32_TOL * (1 + |want|) → the max abs error. That
    holds f32 compute, and bf16 compute as the GPU tests do: kernel and
    plain version round the same operands to bf16 and sum products that are
    exact in f32, so only the summation order differs."""
    err = (got - want).abs()
    ok = bool((err <= F32_TOL * (1 + want.abs())).all())
    checks.require(ok, f"{name}: values outside tolerance (max abs err {float(err.max())})")
    return float(err.max())


def check_topk_indices(checks, name, v, i, rv, ri, cd):
    """Index lists equal, except where the disagreeing values lie within the
    tie band of the compute type. Returns (rows equal, rows in the band)."""
    rows_equal = (i == ri).all(dim=1)
    scale = rv.abs().amax(dim=1, keepdim=True).clamp_min(1.0)
    band = (BF16_TIE if cd == torch.bfloat16 else F32_TOL) * scale
    in_band = ((v - rv).abs() <= band).all(dim=1) & ~rows_equal
    ok = bool((rows_equal | in_band).all())
    checks.require(ok, f"{name}: top-k indices differ outside the tie band")
    return int(rows_equal.sum()), int(in_band.sum())


def check_topk(checks, name, x, g, k_top, cd) -> dict:
    """The generator against its plain version on one input: values and lse
    at F32_TOL for both compute types (at bf16 both round the same operands
    and sum products exact in f32), indices up to the tie band, no index at
    or past the logical width."""
    v, i, lse = dequant_matmul_topk(x, g, k_top, compute_dtype=cd)
    rv, ri, rlse = dequant_matmul_topk_reference(x, g, k_top, compute_dtype=cd)
    err = max(check_values(checks, f"{name}/{cd}/values", v, rv),
              check_values(checks, f"{name}/{cd}/lse", lse, rlse))
    eq, band = check_topk_indices(checks, f"{name}/{cd}", v, i, rv, ri, cd)
    checks.require(0 <= int(i.min()) and int(i.max()) < g.shape[1],
                   f"{name}: an index outside [0, N) was chosen")
    return {"max_abs_err": err, "rows_equal": eq, "rows_in_tie_band": band}


def check_dequant_matmul(checks, name, x, q) -> dict:
    """The dequant-matmul kernel against its plain version on one input, f32
    and bf16 compute, at F32_TOL (see :func:`check_values`) → the max abs
    error of each compute type."""
    out = {}
    for cd in (torch.float32, torch.bfloat16):
        got = dequant_matmul(x, q, compute_dtype=cd)
        want = dequant_matmul_reference(x, q, compute_dtype=cd)
        out[str(cd)] = check_values(checks, f"{name}/{cd}", got, want)
    return out


def decode_matrices(dec):
    """The dequant-matmul weights of a decode step (each LSTM layer's gates,
    then ``attn_out``) and the dtype of the activation each gets."""
    return tuple((f"lstm_{i}", cell.w, torch.bfloat16)  # [x_emb; feed; h] arrives in bf16
                 for i, cell in enumerate(dec.cells)) + (
        ("attn_out", dec.attn_out, torch.float32),)  # [context f32; h]


def advance_inputs(b, k, kc, t_max, gen, dev="cuda"):
    """A decode step's candidates and a beam state as the beam advance gets
    them, on ``dev``: values on a coarse grid (exact ties within and across
    beams; half the sentences share one lse, so whole blocks tie), EOS among
    the candidates, NEG_INF blocks, a third of the beams finished."""
    vals = -torch.sort(torch.randint(0, 6, (b * k, kc), generator=gen).float() * 0.5,
                       dim=1).values
    vals[torch.rand(b * k, generator=gen) < 0.15] = NEG_INF
    idx = torch.randint(4, 32000, (b * k, kc), generator=gen, dtype=torch.int32)
    idx[torch.rand(b * k, kc, generator=gen) < 0.2] = EOS
    lse = torch.rand(b * k, 1, generator=gen) * 1.5 + 0.5
    lse[(torch.rand(b, generator=gen) < 0.5).repeat_interleave(k)] = 1.25
    state = (
        -torch.randint(0, 8, (b, k), generator=gen).float(),  # scores
        torch.rand(b, k, generator=gen) < 0.3,  # finished
        torch.randint(0, 5, (b, k), generator=gen, dtype=torch.int32),  # lengths
        torch.zeros(b, k, dtype=torch.int64),  # last_token
        torch.randint(0, 32000, (t_max, b * k), generator=gen, dtype=torch.int32),  # sym
        torch.zeros(t_max, b * k, dtype=torch.int8),  # parent
    )
    return tuple(x.to(dev) for x in (vals, idx, lse)), tuple(x.to(dev) for x in state)


def check_advance(checks, name, b, k, kc, t, t_max, gen, dev="cuda") -> bool:
    """The beam-advance kernel against its plain version on the inputs of
    :func:`advance_inputs` at step ``t``: bit-exact in every output (the new
    beam state, the history rows, the flat parent rows)."""
    cand, state = advance_inputs(b, k, kc, t_max, gen, dev)
    mine, ref = [x.clone() for x in state], [x.clone() for x in state]
    rows = beam_advance(*cand, *mine, t, eos_id=EOS, pad_id=PAD)
    want = beam_advance_reference(*cand, *ref, t, eos_id=EOS, pad_id=PAD)
    ok = torch.equal(rows, want) and all(torch.equal(x, y) for x, y in zip(mine, ref))
    checks.require(ok, f"{name} B={b} K={k} kc={kc} t={t}: not bit-exact")
    return ok


def rank_kernels(c, tag, a, sdecs, rows, dev) -> dict:
    """Each kernel of the sharded search at this rank's shapes against its
    plain version: the generator shard (uniform f32 and bf16 compute, LUT
    f32), the dequant-matmuls of a decode step at ``rows`` rows (uniform and
    LUT), the beam advance on this rank's sentences at the first and last
    step, bit-exact."""
    gen = torch.Generator().manual_seed(a.seed + 40)
    out = {"rows": rows, "shard_width": sdecs["f32"].generator.shape[1]}
    x = torch.randn(rows, sdecs["f32"].generator.shape[0], generator=gen).to(dev)
    out["generator"] = {
        f"{label}/{cd}": check_topk(c, f"{tag} generator {label}", x, sdecs[label].generator,
                                    a.beam, cd)["max_abs_err"]
        for label, cds in (("f32", (torch.float32, torch.bfloat16)), ("lut_f32", (torch.float32,)))
        for cd in cds}
    out["dequant_matmul"] = {}
    for label in ("f32", "lut_f32"):
        for mat, q, xdt in decode_matrices(sdecs[label]):
            xm = torch.randn(rows, q.shape[0], generator=gen).to(dev, xdt)
            out["dequant_matmul"][f"{label}/{mat}"] = check_dequant_matmul(
                c, f"{tag} {label}/{mat}", xm, q)
    b = rows // a.beam
    out["beam_advance_bit_exact"] = all(
        check_advance(c, f"{tag} advance", b, a.beam, a.beam, t, a.src_len, gen, dev)
        for t in (0, a.src_len - 1))
    return out


def sharded_step_check(checks, name, model, dec, sdec, mesh, src, src_len, k, steps) -> dict:
    """The sharded decode step beside the unsharded one on this rank's rows
    (its data slice of the sentences, ``k`` beams each): from the encoder's
    state, then ``steps - 1`` more steps along the unsharded step's top-1
    tokens. Indices equal, values and lse within F32_TOL. Both steps run the
    same state, so no tie broken apart upstream can hide a fault of the
    merge."""
    dp, d = axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS)
    bl, dev = src.shape[0] // dp, dec.device
    step = make_sharded_decode_step_topk(sdec, mesh, k)
    idx_equal, err = True, 0.0
    with torch.no_grad():
        keys, enc_out, enc_mask, st = encode_packed(
            model, dec, src[d * bl:(d + 1) * bl].to(dev), src_len[d * bl:(d + 1) * bl].to(dev))
        state = expand_to_beams(st, k)
        tokens = torch.full((bl * k,), BOS, dtype=torch.int64, device=dev)
        for _ in range(steps):
            _, (sv, si, slse) = step(state, tokens, keys, enc_out, enc_mask)
            state, (v, i, lse) = packed_decode_step_topk(dec, state, tokens, keys, enc_out,
                                                         enc_mask, k)
            idx_equal = idx_equal and torch.equal(si, i)
            err = max(err, float((sv - v).abs().max()), float((slse - lse).abs().max()))
            tokens = i[:, 0].long()
    checks.require(idx_equal and err <= F32_TOL,
                   f"{name}: the sharded step differs from the unsharded one (indices equal "
                   f"{idx_equal}, values and lse {err} apart)")
    return {"rows": bl * k, "steps": steps, "idx_equal": idx_equal, "max_abs_err": err}


def near_ties(model, dec, src, src_len, cfg) -> np.ndarray:
    """Per sentence, whether the one-process search (eager, on ``dec``'s
    device) ever had a candidate within ``TIE_ULPS`` ulps of a beam's last
    place (the K-th best of the step's candidates against the K+1-th), or
    two final scores within ``TIE_ULPS`` ulps of each other at the top."""
    dev, b, k = dec.device, src.shape[0], cfg.beam_size

    def close(hi, lo):
        ulp = torch.nextafter(hi.abs(), torch.full_like(hi, math.inf)) - hi.abs()
        return torch.isfinite(hi) & torch.isfinite(lo) & (hi - lo <= TIE_ULPS * ulp)

    with torch.no_grad():
        keys, enc_out, enc_mask, st = encode_packed(model, dec, src.to(dev), src_len.to(dev))
        state = init_beam_state(expand_to_beams(st, k), b, k, cfg.max_len, device=dev)
        tie = torch.zeros(b, dtype=torch.bool, device=dev)
        for t in range(cfg.max_len):
            seen = {}

            def decode(s, tokens):
                out = packed_decode_step_topk(dec, s, tokens, keys, enc_out, enc_mask, k)
                seen["cand"] = out[1]
                return out

            scores, finished = state.scores.clone(), state.finished.clone()
            state = step_beams_cand(decode, state, t, beam_size=k)
            vals, _, lse = seen["cand"]
            live = scores[..., None] + (vals - lse).reshape(b, k, k)
            eos = torch.full_like(live, NEG_INF)
            eos[..., 0] = scores
            cand = torch.where(finished[..., None], eos, live).reshape(b, k * k)
            top = torch.sort(cand, dim=1, descending=True).values
            tie |= close(top[:, k - 1], top[:, k])
        final = torch.sort(finalize_scores(state, cfg), dim=1, descending=True).values
        if k > 1:
            tie |= close(final[:, 0], final[:, 1])
    return tie.cpu().numpy()


# ----------------------------------------------------------------- serving


def serve_mesh(c, a, dev, on_card, mesh, model, decs, gen_w) -> dict:
    """Item 1 on one mesh: kernels, the sharded step, the three searches
    (capture, replay, eager); item 2, the engine, where ``data`` > 1."""
    shape = tuple(mesh.shape)
    tag = f"{shape} rank {torch.distributed.get_rank()}"
    sdecs = {label: shard_decoder(d, mesh, *gen_w) for label, d in decs.items()}
    src, src_len = serve_inputs(a)
    cfg = BeamConfig(beam_size=a.beam, max_len=a.src_len)
    steps = cfg.max_len
    out = {"kernels": rank_kernels(c, tag, a, sdecs, a.batch * a.beam // shape[0], dev),
           "step": sharded_step_check(c, f"{tag} step", model, decs["f32"], sdecs["f32"], mesh,
                                      src, src_len, a.beam, STEP_CHECKS),
           "graphed": capturable(mesh, dev)}
    c.require(out["graphed"] == on_card, f"{tag}: graphed {out['graphed']} on {dev.type}")
    for label in SEARCHES:
        want = search_launches(on_card, steps, model.cfg.num_layers, label.startswith("lut"))
        res = {}
        for call in ("capture", "replay"):
            zero_counts()
            with collective_budget(mesh) as budget:
                toks, scores = beam_search_sharded(model, sdecs[label], src, src_len, cfg, mesh,
                                                   device=dev)
            _sync(dev)
            launches = path_counts(launch_counts())
            gathers = budget.count("all-gather")
            c.require(launches == want, f"{tag} {label} ({call}): launches {launches}, "
                                        f"expected {want}")
            c.require(gathers == 3 * steps + 2, f"{tag} {label} ({call}): {gathers} all-gathers")
            res[call] = {"launches": launches, "all_gathers": gathers}
        e_toks, e_scores = beam_search_sharded(model, sdecs[label], src, src_len, cfg, mesh,
                                               device=dev, _eager=True)
        res["graph_equals_eager"] = torch.equal(toks, e_toks) and torch.equal(scores, e_scores)
        c.require(res["graph_equals_eager"], f"{tag} {label}: graphed search differs from eager")
        res["tokens"], res["scores"] = toks.cpu().numpy(), scores.cpu().numpy()
        out[label] = res
    if shape[0] > 1 or torch.distributed.get_world_size() == 1:
        out["engine"] = engine_mesh(c, a, tag, mesh, model, sdecs["f32"], dev, on_card)
    return out


def engine_mesh(c, a, tag, mesh, model, sdec, dev, on_card) -> dict:
    """``TranslationEngine(mesh=)`` over 8 slots (``8 / data`` a rank):
    request 0 alone first, then the rest two calls later; each completion
    equal to the offline sharded search's tokens; the launches 3 / 1 / 1 a
    step; per chunk the engine replays, its steps and the live slots of
    each data slice at its start (the host's active mask, the same on every
    rank)."""
    sents, esrc, elen = engine_sources(a)
    cfg = BeamConfig(beam_size=a.beam, max_len=a.src_len)
    o_toks, _ = beam_search_sharded(model, sdec, esrc, elen, cfg, mesh, device=dev)
    o_toks = o_toks.cpu().numpy()
    slots, dp = 8, axis_size(mesh, DATA_AXIS)
    ecfg = ServeConfig(max_slots=slots, max_src_len=a.src_len, max_tgt_len=a.src_len, beam=cfg,
                       admit_batch=slots, chunk_steps=4)
    eng = TranslationEngine(model, ecfg, sdec, mesh=mesh, device=dev)
    chunks, drive, per = [], eng._drive, slots // dp

    def recorded(active0, n, n_chunks):
        chunks.append({"steps": n * n_chunks,
                       "live": [int(active0[s * per:(s + 1) * per].sum()) for s in range(dp)]})
        return drive(active0, n, n_chunks)

    eng._drive = recorded
    zero_counts()
    arrival = {0: [0], 2: list(range(1, len(sents)))}
    res, rids, call = {}, {}, 0
    with collective_budget(mesh) as budget:
        while len(res) < len(sents):
            for i in arrival.get(call, []):
                rids[eng.submit(sents[i])] = i
            for done in eng.step():
                res[rids[done.request_id]] = done.tokens
            call += 1
            if call > 10000:
                raise RuntimeError("the engine did not drain")
    _sync(dev)
    launches = path_counts(launch_counts())
    equal = all(np.array_equal(res[i], o_toks[i]) for i in range(len(sents)))
    c.require(equal, f"{tag} engine: tokens differ from the offline sharded search")
    k = launches["dequant_matmul_topk"]
    want = expected(on_card, dequant_matmul=(model.cfg.num_layers + 1) * k, dequant_matmul_topk=k,
                    beam_advance=k)
    c.require(launches == want and (k > 0) == on_card, f"{tag} engine launches {launches}")
    graphed = eng._graph is not None
    c.require(graphed == on_card, f"{tag} engine: graphed {graphed}")
    return {"requests": len(sents), "tokens_equal_offline": equal, "launches": launches,
            "all_gathers": budget.count("all-gather"), "graphed": graphed,
            "chunks": chunks}


# ---------------------------------------------------------------- training


def kd_seq2seq(a, dev, rows: int, seed: int):
    """(student, task, batch on the host) of a KD step, dropout 0."""
    v, L = a.vocab, a.src_len
    teacher = make_seq2seq(a.teacher, v, v, dropout=0.0, device=dev, seed=seed)
    student = make_seq2seq(a.preset, v, v, dropout=0.0, device=dev, seed=seed + 1)
    g = torch.Generator().manual_seed(seed + 2)
    batch = {"src": torch.randint(4, v, (rows, L), generator=g),
             "src_len": torch.full((rows,), L),
             "tgt_in": torch.randint(4, v, (rows, L), generator=g),
             "tgt_out": torch.randint(4, v, (rows, L), generator=g),
             "tgt_mask": torch.ones(rows, L)}
    return student, nmt_task(student, teacher, device=dev), batch


def kd_lm(a, dev, rows: int, seed: int):
    teacher = make_lm(a.lm_teacher, a.lm_vocab, dropout=0.0, device=dev, seed=seed)
    student = make_lm(a.lm_student, a.lm_vocab, dropout=0.0, device=dev, seed=seed + 1)
    g = torch.Generator().manual_seed(seed + 2)
    batch = {"input": torch.randint(0, a.lm_vocab, (rows, a.lm_bptt), generator=g),
             "target": torch.randint(0, a.lm_vocab, (rows, a.lm_bptt), generator=g)}
    return student, teacher, batch


def state_tensors(state) -> list:
    """Every tensor of a train state: parameters, moments, running
    statistics, codebooks, carry."""
    return _state_tensors(state) + _leaves(state.carry)


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms inside the block (the setting is
    restored after). Its default backward convolutions add with atomics in
    no fixed order, so two eager runs of a convolutional step part within a
    few steps and a graphed run could be held only within their spread,
    one draw of which a fourth run exceeds now and then (1 of 158 WRN
    tensors past twice the gap of three eager runs); deterministic, the
    eager runs agree bit for bit and the graphed run must equal them."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


def graph_parity(eager_states, eager_losses, graph_state, graph_losses) -> tuple:
    """The graphed run against eager runs from copies of one state: each
    tensor of ``graph_state`` and each step's loss of ``graph_losses`` must
    equal the first eager run's bit for bit where the eager runs are equal
    bit for bit, and lie within twice the eager-against-eager gap elsewhere
    (a tensor's largest gap between any two eager runs; a loss's, the
    largest over the steps whose eager losses differ). ``eager_states``:
    one list of tensors a run; ``eager_losses``: one list of 0-d tensors a
    run → (the record, how many tensors and losses are past their bound)."""
    record, over = {}, 0
    for what, eager, graphed in (("state", eager_states, graph_state),
                                 ("loss", eager_losses, graph_losses)):
        with torch.no_grad():
            gap_e = [max(float((x - y).abs().max()) for x, y in itertools.combinations(ts, 2))
                     for ts in zip(*eager, strict=True)]
            gap_g = [float((x - y).abs().max()) for x, y in zip(eager[0], graphed, strict=True)]
        if what == "loss":  # one number a step: the bound is the largest gap of the run
            gap_e = [e and max(gap_e) for e in gap_e]
        bad = sum(d > (0.0 if e == 0.0 else 2 * e) for e, d in zip(gap_e, gap_g))
        over += bad
        record[what] = {
            "tensors": len(graphed), "eager_bit_equal": sum(e == 0.0 for e in gap_e),
            "graph_bit_equal": sum(d == 0.0 for d in gap_g),
            "eager_eager_max_abs_gap": max(gap_e), "graph_eager_max_abs_gap": max(gap_g),
            "largest_gap_ratio": max((d / e for e, d in zip(gap_e, gap_g) if e), default=0.0),
            "graph_over_bound": bad}
    return record, over


def graph_leg(c, name, task, tx, state, batch, seed, steps, dev, *, quant, mode="weights",
              fq_per_step=1, mesh=None, control=False, ref=None, local=None, **mesh_kw) -> dict:
    """The graphed train step against the eager one (``_eager=True``): from
    four copies of ``state``, three eager runs and one graphed run of
    ``steps`` steps on ``batch`` at ``seed``, held to each other by
    :func:`graph_parity`. On the card the graphed run launches
    ``fq_per_step`` fake-quant kernels a step and captures one graph, and
    an eager step and a graphed one more on its state capture none; off the
    card no kernel launches and nothing is graphed. On a ``mesh`` (with
    ``param_specs`` or ``grad_reduce_dtype`` in ``mesh_kw``) each step's
    collectives (``collective_budget``: kind, bytes, axis, group size) in
    the graphed run, the capturing call's and every replay's, must equal
    the first eager run's step for step. With ``control``, one graphed step
    at ``seed + 1`` (a step object of its own) must give another loss (the
    student's dropout masks follow the seed). With ``ref`` (the
    one-process step's loss, parameters and codebooks) the graphed run's
    first step is held to it (``local(name, whole)``: this rank's slice of
    a whole parameter). → the record."""
    on_card = dev.type == "cuda"
    kw = dict(quant=quant, distill=DistillSpec(), mode=mode, device=dev, mesh=mesh, **mesh_kw)
    eager = make_train_step(task, tx, _eager=True, **kw)
    graph = make_train_step(task, tx, **kw)
    c.require(graph.graphed == on_card, f"{name}: graphed {graph.graphed} on {dev.type}")
    runs, first = [], None
    for step in (eager, eager, eager, graph):
        st, losses, budgets = _clone_state(state), [], []
        zero_counts()
        for i in range(steps):
            with collective_budget(mesh) as budget:
                st, m = step(st, batch, seed)
            losses.append(m["loss"])
            budgets.append([dataclasses.astuple(op) for op in budget.ops])
            if step is graph and i == 0 and ref is not None:
                first = (float(m["loss"]), {n: t.detach().clone() for n, t in st.params.items()},
                         None if st.codebooks is None else
                         {n: t.detach().clone() for n, t in st.codebooks.items()})
        _sync(dev)
        runs.append((st, torch.stack(losses), path_counts(launch_counts()), budgets))
    g, lg, launches, g_budgets = runs.pop()
    want = expected(on_card, fake_quant_buckets=fq_per_step * steps)
    c.require(launches == want, f"{name}: graphed launches {launches}, expected {want}")
    c.require(graph.captures == int(on_card), f"{name}: {graph.captures} captures")
    parity, over = graph_parity([state_tensors(r[0]) for r in runs], [list(r[1]) for r in runs],
                                state_tensors(g), list(lg))
    c.require(over == 0, f"{name}: graphed against eager past the eager-eager bound {parity}")
    record = {"launches": launches, "captures": graph.captures, "losses": [float(x) for x in lg],
              "losses_eager": [float(x) for x in runs[0][1]], **parity}
    if mesh is not None:
        same = g_budgets == runs[0][3]
        c.require(same and bool(g_budgets[0]), f"{name}: the graphed steps' collectives differ "
                                               "from the eager steps'")
        kinds = {}
        for kind, _, axis, _ in g_budgets[0]:
            kinds[f"{kind}@{axis}"] = kinds.get(f"{kind}@{axis}", 0) + 1
        record.update(collectives_a_step=kinds, bytes_a_step=sum(op[1] for op in g_budgets[0]))
    for step in (eager, graph):  # on the graphed run's state: the graph replays
        step(g, batch, seed)
    _sync(dev)
    c.require(graph.captures == int(on_card),
              f"{name}: {graph.captures} captures after an eager and a graphed step more")
    if control:
        _, m = make_train_step(task, tx, **kw)(_clone_state(state), batch, seed + 1)
        record["loss_other_seed"] = float(m["loss"])
        c.require(record["loss_other_seed"] != record["losses"][0],
                  f"{name}: another seed gave the same loss (dropout off?)")
    if ref is not None:
        loss, params, books = first
        rtol, atol = ref.get("w_tol", (W_RTOL, W_ATOL))
        excess = max(float(((t - local(n, ref["params"][n])).abs()
                            - rtol * local(n, ref["params"][n]).abs()).max())
                     for n, t in params.items())
        if books is not None:
            excess = max([excess] + [float(((t - ref["codebooks"][n]).abs()
                                            - rtol * ref["codebooks"][n].abs()).max())
                                     for n, t in books.items()])
        c.require(abs(loss - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"]),
                  f"{name}: loss {loss} vs the one-process step's {ref['loss']}")
        c.require(excess <= atol, f"{name}: weights {excess} past rtol {rtol} of the one-process "
                                  "step's")
        record["one_process"] = {"loss": loss, "one_process_loss": ref["loss"],
                                 "weights_excess_over_rtol": excess, "rtol": rtol, "atol": atol}
    return record


def one_process_step(task, student, batch, seed, dev, quant, mode="weights", carry=None) -> dict:
    """The one-process SGD step (eager) of ``student`` on the whole batch →
    loss, parameters and codebooks on the device; the student's own
    parameters are left as they were."""
    params = dict(student.named_parameters())
    before = {n: t.detach().clone() for n, t in params.items()}
    tx = build_optimizer(SGD)
    state = create_train_state(params, tx, quant=quant, mode=mode, carry=carry, device=dev)
    state, m = make_train_step(task, tx, quant=quant, distill=DistillSpec(), mode=mode,
                               device=dev, _eager=True)(state, as_dev(batch, dev), seed)
    out = {"loss": float(m["loss"]),
           "params": {n: t.detach().clone() for n, t in state.params.items()},
           "codebooks": None if state.codebooks is None else
           {n: t.detach().clone() for n, t in state.codebooks.items()}}
    with torch.no_grad():
        for n, t in params.items():
            t.copy_(before[n])
    return out


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def train_dp(c, a, dev, mesh) -> dict:
    """Seq2seq data parallel on ``mesh`` (cards, 1), f32 and bf16 reduce."""
    cards = torch.distributed.get_world_size()
    quant = QuantSpec(bits=a.bits)
    out = {}
    for label, reduce in (("dp_f32", None), ("dp_bf16", torch.bfloat16)):
        seed = a.seed + 10
        student, task, batch = kd_seq2seq(a, dev, a.train_batch * cards, seed)
        ref = one_process_step(task, student, batch, a.seed, dev, quant)
        if reduce is not None:
            ref["w_tol"] = (BF16_W_RTOL, BF16_W_ATOL)
        tx = build_optimizer(SGD)
        state = create_train_state(dict(student.named_parameters()), tx, quant=quant, device=dev)
        name = f"{label} {(cards, 1)}"
        out[name] = graph_leg(c, name, task, tx, state, place_batch(batch, mesh, device=dev),
                              a.seed, a.train_steps, dev, quant=quant, mesh=mesh,
                              grad_reduce_dtype=reduce, ref=ref, local=lambda n, t: t)
        del student, task, state, ref
        _free(dev)
    return out


def as_dev(batch, dev) -> dict:
    return {k: v.to(dev) for k, v in batch.items()}


def train_tp(c, a, dev, mesh) -> dict:
    """Seq2seq tensor parallel on ``mesh``, modes ``weights`` and
    ``joint``; each rank's shards held to the one-process step's slices."""
    shape = tuple(mesh.shape)
    out = {}
    for mode, quant, fq in (("weights", QuantSpec(bits=a.bits), 1),
                            ("joint", QuantSpec(bits=a.bits, method="codebook"), 0)):
        seed = a.seed + 70
        student, task, batch = kd_seq2seq(a, dev, a.train_batch * shape[0], seed)
        ref = one_process_step(task, student, batch, a.seed, dev, quant, mode)
        whole = dict(student.named_parameters())
        specs = placed_pspecs(whole, mesh)
        mp = ModelParallel(mesh, specs)
        tx = build_optimizer(SGD)
        state = create_train_state(place_params_seq2seq(whole, mesh, device=dev), tx, quant=quant,
                                   mode=mode, mesh=mesh, param_specs=specs, device=dev)
        name = f"tp_{mode} {shape}"
        out[name] = graph_leg(c, name, task, tx, state, place_batch(batch, mesh, device=dev),
                              a.seed, a.train_steps, dev, quant=quant, mode=mode,
                              fq_per_step=fq, mesh=mesh, param_specs=specs, ref=ref,
                              local=mp.local)
        out[name]["split"] = sum(mp.is_split(n) for n in whole)
        c.require(out[name]["split"] > 0 or shape[1] == 1, f"{name}: no parameter split over "
                                                           "model")
        del student, task, state, ref
        _free(dev)
    return out


def train_lm(c, a, dev, mesh) -> dict:
    """The LM tensor parallel on ``mesh`` with its carry threaded."""
    shape = tuple(mesh.shape)
    quant = QuantSpec(bits=a.bits)
    student, teacher, batch = kd_lm(a, dev, a.lm_batch * shape[0], a.seed + 75)
    task = lm_task(student, teacher, thread_carry=True, device=dev)
    ref = one_process_step(task, student, batch, a.seed, dev, quant,
                           carry=lm_initial_carry(student, a.lm_batch * shape[0], teacher))
    whole = dict(student.named_parameters())
    specs = placed_pspecs(whole, mesh)
    mp = ModelParallel(mesh, specs)
    tx = build_optimizer(SGD)
    state = create_train_state(place_params_lm(whole, mesh, device=dev), tx, quant=quant,
                               carry=lm_initial_carry(student, a.lm_batch, teacher), device=dev)
    name = f"lm_tp {shape}"
    out = {name: graph_leg(c, name, task, tx, state, place_batch(batch, mesh, device=dev),
                           a.seed, a.train_steps, dev, quant=quant, mesh=mesh,
                           param_specs=specs, ref=ref, local=mp.local)}
    del student, teacher, task, state, ref
    _free(dev)
    return out


def train_wrn(c, a, dev, mesh) -> dict:
    """WRN teacher → student data parallel on ``mesh`` (cards, 1),
    deterministic cuDNN, running statistics averaged over ``data`` in the
    step."""
    cards = torch.distributed.get_world_size()
    quant = QuantSpec(bits=a.bits)
    teacher = make_wrn(a.wrn_teacher, 100, device=dev, seed=a.seed + 20)
    student = make_wrn(a.wrn_student, 100, device=dev, seed=a.seed + 21)
    g = torch.Generator().manual_seed(a.seed + 22)
    n, s = a.vision_batch * cards, a.vision_size
    batch = {"image": torch.randn(n, s, s, 3, generator=g),
             "label": torch.randint(0, 100, (n,), generator=g)}
    tx = build_optimizer(SGD)
    state = create_train_state(dict(student.named_parameters()), tx,
                               batch_stats=dict(student.named_buffers()), quant=quant, device=dev)
    name = f"wrn_dp {(cards, 1)}"
    with cudnn_deterministic():
        out = {name: graph_leg(c, name, vision_task(student, teacher, device=dev), tx, state,
                               place_batch(batch, mesh, device=dev), a.seed, a.train_steps, dev,
                               quant=quant, mesh=mesh)}
    del teacher, student, state
    _free(dev)
    return out


# -------------------------------------------------------------------- ranks


def _rank(rank: int, world: int, spec: dict) -> dict:
    """One rank: items 1-3 on every mesh (see the module docstring) →
    its failed checks and results."""
    dev = rank_device(spec["device"], rank)
    torch.backends.cudnn.allow_tf32 = False
    on_card = dev.type == "cuda"
    a = SimpleNamespace(**spec["args"])
    c = Checks()
    out = {"device": str(dev), "card": torch.cuda.get_device_name(dev) if on_card else None}
    model = make_seq2seq(a.preset, a.vocab, a.vocab, device=dev, seed=a.seed)
    decs = decoders(a, model, dev)
    gen_w = [torch.from_numpy(params_to_numpy(model)["generator"][k]) for k in ("kernel", "bias")]
    cfg = BeamConfig(beam_size=a.beam, max_len=a.src_len)
    if rank == 0:  # the one-process searches on card 0 and their near ties
        src, src_len = serve_inputs(a)
        out["one_process"] = {}
        for label in ("f32", "lut_f32"):
            toks, scores = beam_search_packed(model, decs[label], src, src_len, cfg, device=dev)
            out["one_process"][label] = {
                "tokens": toks.cpu().numpy(), "scores": scores.cpu().numpy(),
                "near_ties": near_ties(model, decs[label], src, src_len, cfg)}
    mesh = {shape: make_mesh(*shape) for shape in meshes(world)}  # one group per axis each
    out["serve"] = {str(shape): serve_mesh(c, a, dev, on_card, m, model, decs, gen_w)
                    for shape, m in mesh.items()}
    del model, decs
    _free(dev)
    train = train_dp(c, a, dev, mesh[(world, 1)])
    for shape in tp_meshes(world):
        train.update(train_tp(c, a, dev, mesh[shape]))
    train.update(train_lm(c, a, dev, mesh[lm_mesh(world)]))
    train.update(train_wrn(c, a, dev, mesh[(world, 1)]))
    out["train"] = train
    out["failed"] = c.failed
    return out


# ------------------------------------------------------------------- parent


def card_lines() -> list:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    one line a card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()


def require_cards(device, cards: int) -> None:
    """Raise unless ``device`` is the CPU or PyTorch sees ``cards`` cards:
    NCCL takes one rank a card, and the harness never falls back to gloo."""
    if torch.device(device).type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device cuda needs {cards} cards and PyTorch sees no card")
    if torch.cuda.device_count() < cards:
        raise RuntimeError(f"--device cuda needs {cards} cards (one NCCL rank a card); PyTorch "
                           f"sees {torch.cuda.device_count()}")


def emit(obj) -> None:
    print(json.dumps(obj, default=_json), flush=True)


def _json(x):
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.integer, np.floating, np.bool_)):
        return x.item()
    return str(x)


def check_searches(c, ranks) -> dict:
    """Across ranks, per mesh and search: tokens and scores equal on every
    rank; the f32 searches' tokens against the one-process search on card
    0 up to its near ties."""
    one = ranks[0]["one_process"]
    out = {}
    for key in ranks[0]["serve"]:
        per = [r["serve"][key] for r in ranks]
        res = {}
        for label in SEARCHES:
            equal = all(np.array_equal(p[label]["tokens"], per[0][label]["tokens"])
                        and np.array_equal(p[label]["scores"], per[0][label]["scores"])
                        for p in per)
            c.require(equal, f"{key} {label}: the ranks return different results")
            res[label] = {"ranks_equal": equal,
                          "launches_a_rank": [p[label]["replay"]["launches"] for p in per],
                          "all_gathers": per[0][label]["replay"]["all_gathers"]}
            if label in one:
                diff = ~(per[0][label]["tokens"] == one[label]["tokens"]).all(axis=1)
                ties = one[label]["near_ties"]
                res[label].update(sentences=len(diff), differing=int(diff.sum()),
                                  differing_near_ties=int((diff & ties).sum()),
                                  near_ties=int(ties.sum()))
                c.require(not (diff & ~ties).any(),
                          f"{key} {label}: sentences {np.flatnonzero(diff & ~ties).tolist()} "
                          "differ from the one-process search without a near tie")
        res["kernels"] = [p["kernels"] for p in per]
        res["step"] = [p["step"] for p in per]
        if "engine" in per[0]:
            chunks = [p["engine"]["chunks"] for p in per]
            c.require(all(x == chunks[0] for x in chunks),
                      f"{key} engine: the ranks ran different chunks")
            idle = any(0 in ch["live"] and sum(ch["live"]) > 0 for ch in chunks[0])
            c.require(idle or len(ranks) == 1, f"{key} engine: no chunk ran with a data slice "
                                               "empty")
            res["engine"] = {**{k: v for k, v in per[0]["engine"].items() if k != "chunks"},
                             "chunks": len(chunks[0]), "chunk_with_an_empty_slice": idle,
                             "launches_a_rank": [p["engine"]["launches"] for p in per]}
        out[key] = res
    return out


def dryrun(c, cards: int, dev_type: str) -> dict:
    """``graft_entry.dryrun_multichip(cards)`` without its smoke, at dropout
    0; on the card held to the same dry run on the CPU."""
    with contextlib.redirect_stdout(sys.stderr):
        report = graft_entry.dryrun_multichip(cards, device=dev_type, dropout=0.0,
                                              dcn_smoke=False)
    on_card = dev_type == "cuda"
    c.require(report["backend"] == ("nccl" if on_card else "gloo"),
              f"dryrun: backend {report['backend']}")
    c.require(report["graphed"] == [on_card] * cards, f"dryrun: graphed {report['graphed']}")
    steps = graft_entry.SEARCH.max_len
    layers = SEQ2SEQ_PRESETS["student_small"]["num_layers"] + 1
    want = {"f32": {"fake_quant_buckets": 1}, "reduced": {"fake_quant_buckets": 1},
            "search": {"dequant_matmul": layers * steps, "dequant_matmul_topk": steps,
                       "beam_advance": steps},
            "decode_step": {"dequant_matmul": layers, "dequant_matmul_topk": 1}}
    want = {stage: counts if on_card else {} for stage, counts in want.items()}
    for r, launches in enumerate(report["launches"]):
        launches = {stage: path_counts(counts) for stage, counts in launches.items()}
        c.require(launches == want, f"dryrun rank {r}: launches {launches}, expected {want}")
    out = {"n": report["n"], "mesh": report["mesh"], "backend": report["backend"],
           "graphed": report["graphed"], "losses": report["losses"]}
    if on_card:
        with contextlib.redirect_stdout(sys.stderr):
            cpu = graft_entry.dryrun_multichip(cards, device="cpu", dropout=0.0, dcn_smoke=False)
        pairs = list(zip(report["search"], cpu["search"]))
        out["vs_cpu"] = {
            "tokens_equal": all(np.array_equal(g["tokens"], h["tokens"]) for g, h in pairs),
            "scores_max_abs": max(float(np.abs(g["scores"] - h["scores"]).max()) for g, h in pairs),
            "losses_max_abs": max(abs(x - y) for key in ("f32", "reduced")
                                  for x, y in zip(report["losses"][key], cpu["losses"][key]))}
        c.require(out["vs_cpu"]["tokens_equal"], "dryrun: the card's tokens differ from the CPU's")
        c.require(all(np.allclose(g["scores"], h["scores"], rtol=F32_TOL, atol=F32_TOL)
                      for g, h in pairs),
                  f"dryrun: scores card vs CPU {out['vs_cpu']['scores_max_abs']}")
        c.require(all(math.isclose(x, y, rel_tol=F32_TOL, abs_tol=F32_TOL)
                      for key in ("f32", "reduced")
                      for x, y in zip(report["losses"][key], cpu["losses"][key])),
                  f"dryrun: losses card vs CPU {report['losses']} vs {cpu['losses']}")
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=4, choices=(1, 2, 4, 8))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--preset", default="student_medium")
    ap.add_argument("--teacher", default="teacher")
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--beam", type=int, default=5)
    ap.add_argument("--src-len", type=int, default=24)
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--train-batch", type=int, default=128, help="rows a data slice")
    ap.add_argument("--train-steps", type=int, default=4)
    ap.add_argument("--lm-teacher", default="teacher")
    ap.add_argument("--lm-student", default="student_medium")
    ap.add_argument("--lm-vocab", type=int, default=10000)
    ap.add_argument("--lm-batch", type=int, default=256, help="rows a data slice")
    ap.add_argument("--lm-bptt", type=int, default=35)
    ap.add_argument("--wrn-teacher", default="teacher")
    ap.add_argument("--wrn-student", default="student_medium")
    ap.add_argument("--vision-batch", type=int, default=256, help="images a data slice")
    ap.add_argument("--vision-size", type=int, default=32)
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds a collective may wait")
    ap.add_argument("--out", default=None, help="write the whole report here as JSON")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    a = parse_args(argv)
    if a.requests % a.cards or a.batch % a.cards:
        raise ValueError(f"--requests {a.requests} and --batch {a.batch} must divide --cards "
                         f"{a.cards}: the offline searches split sentences over data")
    require_cards(a.device, a.cards)
    on_card = a.device == "cuda"
    cards = card_lines() if on_card else []
    for line in cards:
        print(line, flush=True)
    if on_card:
        _build.build_all()  # once, before the ranks load the kernels
    spec = {"device": a.device, "args": vars(a)}
    ranks = run_ranks(_rank, a.cards, args=(spec,), backend="nccl" if on_card else "gloo",
                      timeout=a.timeout, join_timeout=6 * a.timeout)
    c = Checks()
    for r in ranks:
        c.failed += r["failed"]
    searches = check_searches(c, ranks)
    emit({"item": "sharded_search", **searches, "cards": cards})
    train = ranks[0]["train"]
    for leg, rec in train.items():
        losses = [r["train"][leg]["losses"] for r in ranks]
        c.require(all(x == losses[0] for x in losses) and all(map(math.isfinite, losses[0])),
                  f"{leg}: the ranks' losses {losses} differ or are not finite")
    emit({"item": "train", "legs": train, "cards": cards})
    dry = dryrun(c, a.cards, a.device)
    emit({"item": "dryrun_multichip", **dry, "cards": cards})
    report = {"cards": a.cards, "device": a.device, "nvidia_smi": cards,
              "searches": searches, "one_process": ranks[0]["one_process"],
              "tokens": {key: {label: s[label]["tokens"] for label in SEARCHES}
                         for key, s in ranks[0]["serve"].items()},
              "train": train, "dryrun": dry, "failed": c.failed}
    if a.out:
        with open(a.out, "w") as f:
            json.dump(report, f, default=_json)
    if c.failed:
        print(f"{len(c.failed)} check(s) failed", file=sys.stderr)
        return 1
    emit({"ok": True, "cards": a.cards, "device": a.device,
          "meshes": [list(m) for m in meshes(a.cards)], "nvidia_smi": cards})
    return 0


if __name__ == "__main__":
    sys.exit(main())
