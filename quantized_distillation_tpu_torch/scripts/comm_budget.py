"""Per-step communication budget of the tensor- and data-parallel KD train
step, and the 1→2 host scaling projection (the PyTorch port's counterpart
of the JAX package's ``scripts/comm_budget.py``).

The JAX script lowers the full-size 4-bit KD step (teacher 2x500 →
``student_medium``, vocab 32k) over a ('data' 4 x 'model' 2) CPU mesh and
reads the collectives out of the compiled HLO. The port has no HLO: it
spawns the mesh's ranks (``parallel.launch.run_ranks``, gloo), runs the
step once on placed parameters (``make_train_step(mesh=, param_specs=)``,
teacher whole on every rank) inside ``parallel.comm.collective_budget``,
and prints, from rank 0's budget:

- wire bytes per step by mesh axis ('data' = the inter-host direction,
  'model' = inside a host),
- with ``--train-tokens-per-s`` (a measured 1-chip KD rate), the analytic
  1→2-host data-parallel efficiency at ``--dcn-gbps``,

and, as the last line, JSON with the JAX script's keys
(``wire_bytes_by_axis``; ``serialized`` and ``overlapped`` with a rate).
On the card every rank puts its tensors on it (gloo stages each collective
through the host: the step's seconds, printed too, are a correctness run,
not a scaling figure).

  python -m quantized_distillation_tpu_torch.scripts.comm_budget --train-tokens-per-s <N>
  python -m quantized_distillation_tpu_torch.scripts.comm_budget --device cpu \\
      --batch 8 --len 4 --vocab 64 --preset student_small
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..config import DistillSpec, QuantSpec, TrainConfig
from ..models import make_seq2seq
from ..parallel import make_mesh, place_batch, place_params_seq2seq, placed_pspecs
from ..parallel.comm import CollectiveOp, CommBudget, collective_budget, format_budget, scaling_estimate
from ..parallel.launch import rank_device, run_ranks

TIMEOUT = 600.0  # seconds a collective may wait: 8 ranks may share one card
from ..train import build_optimizer, create_train_state, make_train_step, nmt_task


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--len", type=int, default=24)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--preset", default="student_medium")
    ap.add_argument("--train-tokens-per-s", type=float, default=0.0,
                    help="measured 1-chip KD-step throughput; 0 = report bytes only")
    ap.add_argument("--dcn-gbps", type=float, default=25.0, help="assumed per-host DCN GB/s")
    ap.add_argument("--data", type=int, default=4)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="where each rank's tensors live")
    return ap.parse_args(argv)


def kd_batch(b: int, length: int) -> dict:
    """The JAX script's batch: every token 1, every length full."""
    ones = torch.ones((b, length), dtype=torch.int64)
    return {"src": ones, "src_len": torch.full((b,), length), "tgt_in": ones, "tgt_out": ones,
            "tgt_mask": torch.ones((b, length))}


def _rank(rank, world, a):
    dev = rank_device(a["device"], rank)
    mesh = make_mesh(a["data"], a["model"])
    v = a["vocab"]
    teacher = make_seq2seq("teacher", v, v, dropout=0.0, device=dev, seed=1)
    student = make_seq2seq(a["preset"], v, v, dropout=0.0, device=dev, seed=0)
    whole = dict(student.named_parameters())
    specs = placed_pspecs(whole, mesh)
    local = place_params_seq2seq(whole, mesh, device=dev)
    quant = QuantSpec(bits=4)
    tx = build_optimizer(TrainConfig(learning_rate=1e-3, clip_norm=5.0))
    state = create_train_state(local, tx, quant=quant, device=dev)
    step = make_train_step(nmt_task(student, teacher, device=dev), tx, quant=quant,
                           distill=DistillSpec(), mesh=mesh, param_specs=specs, device=dev)
    batch = place_batch(kd_batch(a["batch"], a["len"]), mesh, device=dev)
    with collective_budget(mesh) as budget:
        t0 = time.perf_counter()
        state, metrics = step(state, batch, 0)
        loss = float(metrics["loss"])  # reads the device: the step has ended
        seconds = time.perf_counter() - t0
    return {"ops": [(op.kind, op.bytes, op.axis, op.group_size) for op in budget.ops],
            "seconds": seconds, "loss": loss}


def measure(args) -> tuple:
    """Run the step on the mesh's ranks → (rank 0's budget, each rank's
    result)."""
    ranks = run_ranks(_rank, args.data * args.model, args=(vars(args),), timeout=TIMEOUT,
                      join_timeout=3 * TIMEOUT)
    ops = ranks[0]["ops"]
    if any(r["ops"] != ops for r in ranks):
        raise RuntimeError("the ranks issued different collectives")
    return CommBudget([CollectiveOp(*op) for op in ops]), ranks


def main(argv=None) -> int:
    args = parse_args(argv)
    print(f"running the sharded KD step on a ({args.data}, {args.model}) mesh ...", flush=True)
    budget, ranks = measure(args)
    print(format_budget(budget))
    print("step seconds per rank (one step, gloo: a correctness run, not scaling): "
          + " ".join(f"{r['seconds']:.3f}" for r in ranks) + f"; loss {ranks[0]['loss']:.6f}")
    out = {"wire_bytes_by_axis": budget.bytes_by_axis(wire=True)}
    if args.train_tokens_per_s > 0:
        t_step = args.batch * args.len / args.train_tokens_per_s
        for overlap in (False, True):
            est = scaling_estimate(budget, t_step, hosts=2, dcn_bytes_per_s=args.dcn_gbps * 1e9,
                                   overlap=overlap)
            key = "overlapped" if overlap else "serialized"
            out[key] = est
            print(f"1->2 hosts ({key} comm, {args.dcn_gbps:.0f} GB/s DCN): "
                  f"dcn {est['dcn_bytes_per_step'] / 1e6:.2f} MB/step, "
                  f"t_comm {est['t_comm_s'] * 1e3:.3f} ms vs t_step {t_step * 1e3:.3f} ms "
                  f"-> efficiency {est['efficiency']:.3f}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
