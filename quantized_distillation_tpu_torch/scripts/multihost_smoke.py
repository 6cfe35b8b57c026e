"""Multi-process smoke of the sharded KD train step and sharded serving
(the PyTorch port's counterpart of the JAX package's
``scripts/multihost_smoke.py``).

The JAX script spawns N processes of 2 devices each, builds a ('data' N,
'model' 2) mesh whose ``data`` axis spans the processes, and runs three
stages; the port runs one process per rank, ``2 N`` of them, on the same
mesh: rank ``r`` sits at ``(r // 2, r % 2)``, so the two ``model`` ranks
of a data group are neighbours (and share a host when a node holds whole
groups), as JAX keeps ``model`` inside a process. The stages, with the
JAX script's assertions:

  1. a ``psum`` over every rank (over ``model``, then ``data``);
  2. ONE tensor- and data-parallel fake-quant KD step
     (``make_train_step(mesh=, param_specs=)`` on
     ``place_params_seq2seq`` shards, the batch over ``data``): the same
     finite loss on every rank;
  3. FOUR chained ``make_sharded_decode_step_topk`` steps (rows over
     ``data``, the generator's vocab over ``model``), each rank's tokens
     equal to the one-process packed step's on its rows.

Launch: by default it spawns the ``2 * --procs`` ranks on this host
(``parallel.launch.run_ranks``). Across hosts, each node runs it with
``--nnodes``, ``--node-rank``, ``--master-addr`` and ``--master-port``
(``parallel.launch.run_node``: a TCP rendezvous, node 0 serving it), or
``torchrun`` starts one process per rank and each joins from its
environment (``env://``). ``--device cuda`` puts each rank's tensors on
card ``local rank % cards``: over NCCL where every local rank has a card
of its own, else over gloo through the host.

  python -m quantized_distillation_tpu_torch.scripts.multihost_smoke --device cpu
  python -m quantized_distillation_tpu_torch.scripts.multihost_smoke --procs 4 --device cuda
  torchrun --nnodes 2 --nproc-per-node 2 --rdzv-endpoint HOST:PORT \\
      -m quantized_distillation_tpu_torch.scripts.multihost_smoke --procs 2
"""

from __future__ import annotations

import argparse
import sys
from datetime import timedelta
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from ..config import DistillSpec, QuantSpec, TrainConfig
from ..convert import params_from_numpy, params_to_numpy
from ..models import make_seq2seq
from ..parallel import make_mesh, place_batch, place_params_seq2seq, placed_pspecs
from ..parallel.comm import all_gather, psum
from ..parallel.launch import env_rank, local_backend, rank_device, run_node, run_ranks
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_index, axis_size
from ..serve import (
    encode_packed,
    expand_to_beams,
    make_sharded_decode_step_topk,
    pack_decoder,
    packed_decode_step_topk,
    shard_decoder,
)
from ..train import build_optimizer, create_train_state, make_train_step, nmt_task
from .comm_budget import kd_batch

MODEL = 2  # ranks per data group, JAX's devices per process
KBEAM, DECODE_STEPS = 2, 4
TIMEOUT = 300.0  # seconds a collective may wait
TOY_VOCAB, TOY_HIDDEN, TOY_EMBED, TOY_LEN = 64, 32, 32, 6
QUANT = QuantSpec(bits=4)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2, help="data groups of 2 ranks")
    ap.add_argument("--device", default="cuda", help="where each rank's tensors live")
    ap.add_argument("--nnodes", type=int, default=1)
    ap.add_argument("--node-rank", type=int, default=0)
    ap.add_argument("--master-addr", default="localhost")
    ap.add_argument("--master-port", type=int, default=0, help="0: a free port (one node)")
    return ap.parse_args(argv)


def toy_setup(mesh, dev, batch: int, *, dropout=None, params=None) -> SimpleNamespace:
    """The toy KD workload of the mesh smokes on ``dev``: the
    ``student_small`` student (V 64, hidden 32, embed 32) and its hidden-64
    teacher, seeded or loaded from ``params`` (``{"student": tree,
    "teacher": tree}`` of numpy arrays in the flax layout), ``dropout``
    None the preset's; the ``batch`` x 6 KD batch placed over ``data``; the
    student's 4-bit packed decoder (f32 compute) and its shards over
    ``mesh``; and ``train_step(grad_reduce_dtype)`` → a fresh 4-bit train
    state on a copy of the placed shards (the student's own weights stay as
    they are) and the tensor- and data-parallel KD step (Adam 1e-3, clip
    5)."""
    drop = {} if dropout is None else {"dropout": dropout}
    student = make_seq2seq("student_small", TOY_VOCAB, TOY_VOCAB, hidden=TOY_HIDDEN,
                           embed_dim=TOY_EMBED, device=dev, seed=0, **drop)
    teacher = make_seq2seq("student_small", TOY_VOCAB, TOY_VOCAB, hidden=2 * TOY_HIDDEN,
                           embed_dim=TOY_EMBED, device=dev, seed=1, **drop)
    if params is not None:
        student.load_params(params_from_numpy(params["student"]))
        teacher.load_params(params_from_numpy(params["teacher"]))
    whole = dict(student.named_parameters())
    specs = placed_pspecs(whole, mesh)
    tx = build_optimizer(TrainConfig(learning_rate=1e-3, clip_norm=5.0))
    task = nmt_task(student, teacher, device=dev)
    host = params_to_numpy(student)
    dec = pack_decoder(host, student.cfg, 4, compute_dtype=torch.float32, device=dev)
    sdec = shard_decoder(dec, mesh, host["generator"]["kernel"], host["generator"]["bias"])

    def train_step(grad_reduce_dtype=None):
        local = {n: x.clone() for n, x in place_params_seq2seq(whole, mesh, device=dev).items()}
        state = create_train_state(local, tx, quant=QUANT, device=dev)
        step = make_train_step(task, tx, quant=QUANT, distill=DistillSpec(), mesh=mesh,
                               param_specs=specs, grad_reduce_dtype=grad_reduce_dtype,
                               device=dev)
        return state, step

    return SimpleNamespace(student=student, dec=dec, sdec=sdec, train_step=train_step,
                           batch=place_batch(kd_batch(batch, TOY_LEN), mesh, device=dev))


def worker(rank: int, world: int, spec: dict) -> str:
    """The three stages on this rank → its closing line."""
    nprocs = world // MODEL
    dev = rank_device(spec["device"], spec.get("local_rank", rank))
    mesh = make_mesh(nprocs, MODEL)

    # 1. psum sanity across the whole mesh
    x = torch.arange(world * 4, dtype=torch.float32).reshape(world, 4)
    total = psum(psum(x[rank].sum().to(dev), mesh, MODEL_AXIS), mesh, DATA_AXIS)
    expect = float(np.sum(np.arange(world * 4)))
    if float(total) != expect:
        raise AssertionError(f"psum {float(total)} != {expect}")

    # 2. one tensor- and data-parallel fake-quant KD step (tiny shapes)
    b, t = 2 * nprocs, TOY_LEN
    toy = toy_setup(mesh, dev, b)
    state, step = toy.train_step()
    state, metrics = step(state, toy.batch, 0)
    loss = float(metrics["loss"])
    losses = all_gather(metrics["loss"].reshape(1), mesh, DATA_AXIS)
    if not np.isfinite(loss) or not bool((all_gather(losses, mesh, MODEL_AXIS) == loss).all()):
        raise AssertionError(f"KD step loss {loss} not finite or not the same on every rank")

    # 3. sharded serving decode: vocab over model, sentence x beam rows over
    # data; each rank's rows against the one-process packed step
    student, dec, sdec = toy.student, toy.dec, toy.sdec
    src = torch.from_numpy(np.random.default_rng(7).integers(3, TOY_VOCAB, (b, t))).to(dev)
    sl = torch.full((b,), t, device=dev)
    dp, d = axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS)
    bl = b // dp
    with torch.no_grad():
        keys, enc_out, enc_mask, st0 = encode_packed(student, dec, src, sl)
        st_ref, tok_ref = expand_to_beams(st0, KBEAM), torch.full((b * KBEAM,), 2, device=dev)
        ref = []
        for _ in range(DECODE_STEPS):
            st_ref, (_, idx, _) = packed_decode_step_topk(dec, st_ref, tok_ref, keys, enc_out,
                                                          enc_mask, KBEAM)
            tok_ref = idx[:, 0].long()
            ref.append(tok_ref[d * bl * KBEAM:(d + 1) * bl * KBEAM])
        rows = slice(d * bl, (d + 1) * bl)
        keys_l, enc_l, mask_l, st_l = encode_packed(student, dec, src[rows], sl[rows])
        st_sh, tok_sh = expand_to_beams(st_l, KBEAM), torch.full((bl * KBEAM,), 2, device=dev)
        sstep = make_sharded_decode_step_topk(sdec, mesh, KBEAM)
        for i in range(DECODE_STEPS):
            st_sh, (_, idx_sh, _) = sstep(st_sh, tok_sh, keys_l, enc_l, mask_l)
            tok_sh = idx_sh[:, 0].long()
            if not torch.equal(tok_sh, ref[i]):
                raise AssertionError(f"decode step {i}: tokens {tok_sh.tolist()} != "
                                     f"{ref[i].tolist()}")
    return (f"[rank {rank}/{world}] mesh {{'data': {nprocs}, 'model': {MODEL}}} psum OK, "
            f"KD step loss {loss:.4f} OK, sharded decode x{DECODE_STEPS} token-parity OK "
            f"(rows {b * KBEAM} over data, vocab-TP {MODEL})")


def main(argv=None) -> int:
    args = parse_args(argv)
    spec = {"device": args.device}
    env = env_rank()
    if env is not None:  # torchrun: this process is one rank
        rank, world, spec["local_rank"], local_world = env
        dist.init_process_group(local_backend(args.device, local_world), init_method="env://",
                                timeout=timedelta(seconds=TIMEOUT))
        try:
            # one write: the ranks share the output stream
            print(worker(rank, world, spec) + "\n", end="", flush=True)
            dist.barrier()  # every rank passed
        finally:
            dist.destroy_process_group()
        if rank == 0:
            print(closing_line(world // MODEL))
        return 0
    world = MODEL * args.procs
    local = world // args.nnodes
    backend = local_backend(args.device, local)
    if args.nnodes == 1 and not args.master_port:
        lines = run_ranks(worker, world, args=(spec,), backend=backend, timeout=TIMEOUT,
                          join_timeout=3 * TIMEOUT)
    else:
        lines = run_node(worker, world, nnodes=args.nnodes, node_rank=args.node_rank,
                         master_addr=args.master_addr, master_port=args.master_port,
                         args=(spec,), backend=backend, timeout=TIMEOUT,
                         join_timeout=3 * TIMEOUT)
    for line in lines:
        print(line, flush=True)
    print(closing_line(args.procs))
    return 0


def closing_line(procs: int) -> str:
    """The JAX script's last line."""
    return (f"multihost smoke: {procs} processes x {MODEL} devices OK "
            "(KD train step + sharded decode x4 token parity)")


if __name__ == "__main__":
    sys.exit(main())
