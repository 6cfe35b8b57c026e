"""Device time by kernel over one run on the card, and a profile of the
serving search.

    python -m quantized_distillation_tpu_torch.utils.search_profile [--reps 7]

profiles one packed beam search at the serving shape (student_medium,
V = 32000, B = 256, beam 5, 24 steps, 4-bit, bf16 compute; weights random
from ``--seed``) on the card: kernels launched per search, device ms,
the device's busy share, host seconds and tokens/s, for the eager step
loop and the captured CUDA graph in turns (a version of the package without
the graph has the eager leg only). It prints one JSON line per leg. The
file also runs by path against another checkout of the package
(``PYTHONPATH=<checkout> python <this file>``), which profiles a parent
commit beside a change in one process's conditions.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import sys
import time

import torch


def device_profile(run, median_s: float = None) -> dict:
    """``run()`` once to warm up, then once under ``torch.profiler``: wall
    ms of that call (synchronized; inflated by the profiler's host cost),
    device ms summed over its kernels, memory copies and sets
    (``device_ms``), the kernel launches (``kernels``; copies and sets in
    ``device_ops`` besides), the device's busy share of that wall time and,
    given ``median_s``, of a median unprofiled run; ``by_kernel``: (name,
    device ms, calls), largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[1],
    )
    device_ms = sum(ms for _, ms, _ in by_kernel)
    copies = ("Memcpy", "Memset")
    out = {
        "wall_ms": wall * 1e3, "device_ms": device_ms,
        "kernels": sum(n for k, _, n in by_kernel if not k.startswith(copies)),
        "device_ops": sum(n for _, _, n in by_kernel),
        "device_busy_share": device_ms / (wall * 1e3),
        "by_kernel": by_kernel,
    }
    if median_s is not None:
        out["device_busy_share_of_median_run"] = device_ms / (median_s * 1e3)
    return out


def span_ms(run) -> float:
    """Milliseconds between CUDA events recorded before and after one call
    on the current stream (a replayed graph's device span; for eager calls
    it includes the device's idle gaps)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def main(argv=None) -> int:
    from quantized_distillation_tpu_torch.config import BeamConfig
    from quantized_distillation_tpu_torch.convert import params_to_numpy
    from quantized_distillation_tpu_torch.kernels import pick_generator_group
    from quantized_distillation_tpu_torch.models import make_seq2seq
    from quantized_distillation_tpu_torch.serve import beam_search_packed, pack_decoder

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="student_medium")
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--beam", type=int, default=5)
    ap.add_argument("--len", type=int, default=24)
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 2

    model = make_seq2seq(args.preset, args.vocab, args.vocab, device="cuda", seed=args.seed)
    group = pick_generator_group(args.batch * args.beam)
    dec = pack_decoder(params_to_numpy(model), model.cfg, args.bits,
                       compute_dtype=torch.bfloat16, generator_group=group, device="cuda")
    gen = torch.Generator().manual_seed(args.seed + 1)
    src = torch.randint(4, args.vocab, (args.batch, args.len), generator=gen)
    src_len = torch.full((args.batch,), args.len, dtype=torch.int64)
    cfg = BeamConfig(beam_size=args.beam, max_len=args.len)
    legs = {"eager": {}}
    if "_eager" in inspect.signature(beam_search_packed).parameters:
        legs = {"eager": {"_eager": True}, "graph": {}}
    runs = {name: (lambda kw=kw: beam_search_packed(model, dec, src, src_len, cfg,
                                                    device="cuda", **kw))
            for name, kw in legs.items()}
    times = {name: [] for name in runs}
    for run in runs.values():
        run()
    torch.cuda.synchronize()
    for i in range(args.reps):  # in turns, so drift on the host hits every leg alike
        for name in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    smi = torch.cuda.get_device_name(0)
    for name, run in runs.items():
        med = statistics.median(times[name])
        prof = device_profile(run, med)
        print(json.dumps({
            "leg": name, "device": smi, "batch": args.batch, "beam": args.beam,
            "max_len": args.len, "host_seconds": times[name],
            "tokens_per_s": args.batch * args.len / med, "span_ms": span_ms(run),
            **{k: v for k, v in prof.items() if k != "by_kernel"},
            "top": [[k[:90], ms, n] for k, ms, n in prof["by_kernel"][:15]],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
