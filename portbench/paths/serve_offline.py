"""Offline batch translation through the port's serving entry,
``serve.infer.beam_search_packed`` on a 4-bit packed decoder
(``serve.infer.pack_decoder``).

Set-up makes the weights on the device from the seed, loads them into the
port's model, packs the decoder, makes the mix's cycle of batches in pinned
host memory and runs every bucket's search twice (the first call captures
its CUDA graph). The window then sends batch after batch of the cycle: the
sources are uploaded, the search runs, its tokens and scores are copied
back to the host and read there, as a job reads them; the host runs up to
``RING`` batches ahead of the card and syncs only to reuse a read-back
buffer and at the window's end. ``decode_tokens_per_s`` is every
finished search's sentences times decode steps over the window's seconds.

Once the window has closed: a sample of the finished requests, drawn from
the seed, with the longest request in it, is held against the plain
reference (``portbench.checks``): teacher-forced over each served
hypothesis, and by its own beam search over each sampled source.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from .. import checks, traffic, weights
from ..harness import Cell, Outcome
from ..reference.numerics import no_tf32
from ..reference.serve import beam_search, deployed_weights, served_logits
from ..trace import record, traced

RING = 3


def _program(cell: Cell, w: Dict[str, torch.Tensor], dev: torch.device):
    from quantized_distillation_tpu_torch.config import BeamConfig
    from quantized_distillation_tpu_torch.convert import params_to_numpy
    from quantized_distillation_tpu_torch.kernels import pick_generator_group
    from quantized_distillation_tpu_torch.models import make_seq2seq
    from quantized_distillation_tpu_torch.serve import beam_search_packed, pack_decoder

    cfg, tr, st = cell.config, cell.traffic, cell.config["student"]
    model = make_seq2seq("student_medium", cfg["vocab"], cfg["vocab"], device=dev,
                         dropout=cfg["dropout"], **st)
    weights.load_into(model, w)
    dec = pack_decoder(params_to_numpy(model), model.cfg, cfg["quant"]["bits"],
                       compute_dtype=getattr(torch, cfg["serve"]["compute_dtype"]),
                       generator_group=pick_generator_group(tr["batch_size"] * tr["beam"]),
                       device=dev)
    beams = {L: BeamConfig(beam_size=tr["beam"], max_len=L) for L in tr["buckets"]}

    def search(src, src_len):
        return beam_search_packed(model, dec, src, src_len, beams[src.shape[1]], device=dev)

    return search


class Sample:
    """A reservoir of ``size`` requests drawn from the seed over every
    finished request, and the longest request besides."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng = size, np.random.default_rng(weights.stream_seed(seed, 7))
        self.kept: List[tuple] = []
        self.seen = 0
        self.longest = None

    def offer(self, src, src_len, tokens, scores) -> None:
        n = src.shape[0]
        idx = self.seen + np.arange(1, n + 1)
        take = self.rng.random(n) < self.size / idx
        for r in np.nonzero(take)[0]:
            item = (src[r].copy(), int(src_len[r]), tokens[r].copy(), float(scores[r]))
            if len(self.kept) < self.size:
                self.kept.append(item)
            else:
                self.kept[int(self.rng.integers(self.size))] = item
        self.seen += n
        r = int(np.argmax(src_len))
        if self.longest is None or (tokens.shape[1], src_len[r]) > (self.longest[2].size,
                                                                      self.longest[1]):
            self.longest = (src[r].copy(), int(src_len[r]), tokens[r].copy(), float(scores[r]))

    def requests(self) -> List[tuple]:
        return self.kept + [self.longest]


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, started: float,
        control: str = None) -> Outcome:
    """One run of the cell (see the module docstring). ``control`` (a
    format of ``reference.numerics``) also reads the control on the same
    requests into ``Outcome.notes``."""
    dev = torch.device(device)
    no_tf32()
    cfg, tr, st = cell.config, cell.traffic, cell.config["student"]
    shapes = weights.seq2seq_shapes(cfg["vocab"], st["embed_dim"], st["hidden"], st["num_layers"])
    w = weights.make(shapes, weights.stream_seed(seed, 0), dev)
    search = _program(cell, w, dev)
    pin = dev.type == "cuda"
    cycle = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(torch.int64) for k, v in b.items()}
             for b in traffic.sources(tr, cfg["vocab"], seed)]
    if pin:
        cycle = [{k: v.pin_memory() for k, v in b.items()} for b in cycle]
    ring = [{L: (torch.empty((tr["batch_size"], L), dtype=torch.int64, pin_memory=pin),
                 torch.empty(tr["batch_size"], dtype=torch.float32, pin_memory=pin))
             for L in tr["buckets"]} for _ in range(RING)]
    pending: List[tuple] = [None] * RING
    sample = Sample(tr["check_sample"], seed)
    failed = 0

    def send(i: int):
        b = cycle[i % len(cycle)]
        slot = i % RING
        if pending[slot] is not None:
            read(slot)
        with record_function("portbench.upload"):
            src = b["src"].to(dev, non_blocking=True)
            src_len = b["src_len"].to(dev, non_blocking=True)
        with record_function("portbench.search"):
            tokens, scores = search(src, src_len)
        with record_function("portbench.readback"):
            tok_h, sc_h = ring[slot][src.shape[1]]
            tok_h.copy_(tokens, non_blocking=True)
            sc_h.copy_(scores, non_blocking=True)
            done = torch.cuda.Event() if pin else None
            if done is not None:
                done.record()
        pending[slot] = (b, tok_h, sc_h, done)
        return src.shape[0] * src.shape[1]

    def read(slot: int):
        nonlocal failed
        b, tok_h, sc_h, done = pending[slot]
        with record_function("portbench.read"):
            if done is not None:
                done.synchronize()
            scores = sc_h.numpy()
            failed += int((~np.isfinite(scores)).sum())
            sample.offer(b["src"].numpy(), b["src_len"].numpy(), tok_h.numpy(), scores)
        pending[slot] = None

    def drain():
        for slot in range(RING):
            if pending[slot] is not None:
                read(slot)

    # warm-up: every bucket's search twice (capture, then a replay)
    first = {}
    for i, b in enumerate(cycle):
        first.setdefault(b["src"].shape[1], i)
    for i in first.values():
        for _ in range(2):
            send(i)
    drain()
    sample = Sample(tr["check_sample"], seed)
    failed = 0
    _sync(dev)
    setup_s = time.perf_counter() - started

    positions = sent = 0
    rec = None
    t0 = time.perf_counter()
    if trace:
        n = tr["trace_units"]
        with traced(dev) as prof:
            shapes_traced = []
            for _ in range(n):
                b = cycle[sent % len(cycle)]
                shapes_traced.append({"rows": b["src"].shape[0], "beam": tr["beam"],
                                      "src_len": b["src"].shape[1], "steps": b["src"].shape[1]})
                positions += send(sent)
                sent += 1
            drain()
        rec = record(prof)
        rec.update(units=n, unit_shapes=shapes_traced)
    while time.perf_counter() - t0 < seconds:
        positions += send(sent)
        sent += 1
    drain()
    _sync(dev)
    window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    del search
    _free(dev)
    requests = sample.requests()
    readings = checks.over_requests(_judge(cell, w, requests, dev))
    notes = {}
    if control is not None:
        notes = checks.over_requests(_judge(cell, w, requests, dev, control))
    return Outcome(
        setup_s=setup_s, rates={"decode_tokens_per_s": positions / window},
        attempted=sent * tr["batch_size"], failed=failed, memory_peak_bytes=int(peak),
        checks=[(k, readings[k], cell.limits[k])
                for k in ("token_gap", "score_gap", "beam_gap")],
        record=_with_context(rec, cell), busy_s=rec and rec["busy_s"],
        window_s=rec and rec["window_s"], notes=notes)


def _judge(cell: Cell, w, requests, dev, control: str = None):
    """Each request's readings against the reference; with ``control`` (a
    format of ``reference.numerics``) the control's readings instead, and
    those of two searches broken in the reference put in the program's
    place: ``greedy`` (beam 1) and ``last`` (the last of the K finals)."""
    cfg = cell.config
    layers, beam = cfg["student"]["num_layers"], cell.traffic["beam"]
    wq = deployed_weights(w, layers, cfg["quant"]["bits"])
    out = []
    for src, src_len, tokens, score in requests:
        s = torch.from_numpy(src)[None].to(dev)
        sl = torch.tensor([src_len], device=dev)
        t = torch.from_numpy(tokens).to(dev)
        finals = beam_search(wq, s, sl, beam, t.numel(), layers)
        hyps = [t, finals[0]]
        if control is not None:
            hyps += [beam_search(wq, s, sl, beam, t.numel(), layers, control)[0],
                     beam_search(wq, s, sl, 1, t.numel(), layers)[0], finals[-1]]
        hyps = torch.stack(hyps)
        n = hyps.shape[0]
        ref = served_logits(wq, s.expand(n, -1), sl.expand(n), hyps, layers)
        best = checks.log_prob(ref[1], hyps[1])
        if control is None:
            out.append(checks.served_gaps(ref[0], t, score, beam, best))
        else:
            ctrl = served_logits(wq, s, sl, t[None], layers, control)[0]
            got = checks.control_gaps(ref[0], ctrl, t, beam, best, ref[2], hyps[2])
            got["greedy.beam_gap"] = checks.beam_gap(best, ref[3], hyps[3])
            got["last.beam_gap"] = checks.beam_gap(best, ref[4], hyps[4])
            out.append(got)
    return out


def _with_context(rec, cell: Cell):
    if rec is not None:
        rec.update(config=cell.config, traffic=cell.traffic, peaks=cell.peaks, cards=1)
    return rec


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _free(dev: torch.device) -> None:
    """Drop the program's captured graphs and cached blocks."""
    from quantized_distillation_tpu_torch.utils.graphs import release_graphs

    release_graphs()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
