"""The port's ``scripts/comm_budget.py`` and ``scripts/multihost_smoke.py``
(``python -m quantized_distillation_tpu_torch.scripts.<name>``) on the
CPU, at tiny shapes.

- ``comm_budget`` prints the JAX script's JSON keys, and its ``data``-axis
  wire bytes are within 2% of the JAX script's gradient all-reduce at the
  same shape, its budget taken in this process from
  ``collective_budget(step.lower(...).compile(), mesh)`` on the 8 CPU
  devices, as the JAX script takes it. Only the gradient all-reduce: XLA
  also partitions part of the forward pass over ``data`` (the teacher's
  embedding gather, a few KB), which the port's step, whose teacher runs
  whole on every rank, does not do. The backward collectives are the HLO
  lines XLA names ``transpose(jvp(...))``.
- ``multihost_smoke --procs 2 --device cpu`` runs its three stages on 4
  ranks and prints the JAX script's closing line, and so does the same run
  as two nodes of 2 ranks joined over TCP on this host (``--nnodes 2``),
  and under ``torchrun`` (one process a rank, ``env://``).
"""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from quantized_distillation_tpu_torch.scripts import comm_budget, multihost_smoke

torch.set_num_threads(2)

TINY = ["--batch", "8", "--len", "4", "--vocab", "64", "--preset", "student_small"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port_budget():
    from contextlib import redirect_stdout
    from io import StringIO

    out = StringIO()
    with redirect_stdout(out):
        rc = comm_budget.main(TINY + ["--device", "cpu", "--train-tokens-per-s", "1000"])
    return rc, out.getvalue().strip().splitlines()


def _jax_grad_reduce_wire_bytes():
    """The JAX script's step at TINY's shape on a (4, 2) mesh: the
    ``data``-axis wire bytes of its backward all-reduces, and of all its
    ``data``-axis collectives."""
    import jax
    import jax.numpy as jnp

    from quantized_distillation_tpu.config import DistillSpec, QuantSpec, TrainConfig
    from quantized_distillation_tpu.models import make_seq2seq
    from quantized_distillation_tpu.parallel import make_mesh, place_batch, place_params_seq2seq
    from quantized_distillation_tpu.parallel.comm import collective_budget
    from quantized_distillation_tpu.train import (
        build_optimizer,
        create_train_state,
        make_train_step,
        nmt_task,
    )

    vocab, b, l = 64, 8, 4
    mesh = make_mesh(model=2)
    teacher = make_seq2seq("teacher", vocab, vocab, dropout=0.0)
    student = make_seq2seq("student_small", vocab, vocab, dropout=0.0)
    rng = jax.random.PRNGKey(0)
    src = jnp.ones((b, l), jnp.int32)
    sl = jnp.full((b,), l, jnp.int32)
    zeros = lambda v: jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), v)  # noqa: E731
    sv = zeros(jax.eval_shape(student.init, rng, src, sl, src))
    tv = zeros(jax.eval_shape(teacher.init, rng, src, sl, src))
    task = nmt_task(student, teacher, {"params": place_params_seq2seq(tv["params"], mesh)})
    tx = build_optimizer(TrainConfig(learning_rate=1e-3, clip_norm=5.0))
    state = create_train_state(place_params_seq2seq(sv["params"], mesh), tx, quant=QuantSpec(bits=4))
    step = make_train_step(task, tx, quant=QuantSpec(bits=4), distill=DistillSpec())
    batch = place_batch({"src": src, "src_len": sl, "tgt_in": src, "tgt_out": src,
                         "tgt_mask": jnp.ones((b, l), jnp.float32)}, mesh)
    rngs = jax.device_put(rng, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
    text = step.lower(state, batch, rngs).compile().as_text()
    backward = "\n".join(line for line in text.splitlines() if "transpose(jvp(" in line)
    grad = sum(op.wire_bytes() for op in collective_budget(backward, mesh).ops
               if op.axis == "data" and op.kind == "all-reduce")
    return grad, collective_budget(text, mesh).bytes_by_axis(wire=True)["data"]


def test_comm_budget_prints_the_jax_scripts_keys(port_budget):
    rc, lines = port_budget
    assert rc == 0
    out = json.loads(lines[-1])
    assert set(out) == {"wire_bytes_by_axis", "serialized", "overlapped"}
    assert set(out["wire_bytes_by_axis"]) == {"data", "model"}
    for key in ("serialized", "overlapped"):
        assert set(out[key]) == {"hosts", "dcn_bytes_per_step", "t_comm_s", "t_step_1host_s",
                                 "efficiency"}
    assert any(line.startswith("collectives: ") for line in lines)
    kinds = next(line for line in lines if "@model" in line)
    for k in ("all-gather@model", "reduce-scatter@model", "all-reduce@model", "all-reduce@data"):
        assert k in kinds


def test_comm_budget_data_bytes_match_the_jax_gradient_reduce(port_budget):
    port = json.loads(port_budget[1][-1])["wire_bytes_by_axis"]["data"]
    grad, jax_data = _jax_grad_reduce_wire_bytes()
    assert abs(port - grad) <= 0.02 * grad, (port, grad)
    assert jax_data >= grad  # XLA's data axis: the gradient reduce and a few forward collectives


def test_multihost_smoke_runs_its_three_stages():
    r = subprocess.run([sys.executable, "-m", "quantized_distillation_tpu_torch.scripts.multihost_smoke",
                        "--procs", "2", "--device", "cpu"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert lines[-1] == ("multihost smoke: 2 processes x 2 devices OK "
                         "(KD train step + sharded decode x4 token parity)")
    assert sum("psum OK, KD step loss" in line and "token-parity OK" in line
               for line in lines) == 4


def test_multihost_smoke_across_two_nodes():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "quantized_distillation_tpu_torch.scripts.multihost_smoke",
           "--procs", "2", "--device", "cpu", "--nnodes", "2", "--master-addr", "localhost",
           "--master-port", str(port)]
    procs = [subprocess.Popen(cmd + ["--node-rank", str(n)], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for n in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for n, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-3000:]
        lines = out.strip().splitlines()
        assert lines[-1].startswith("multihost smoke: 2 processes x 2 devices OK")
        ranks = [line.split("]")[0] for line in lines[:-1]]
        assert ranks == [f"[rank {2 * n + i}/4" for i in range(2)]


def test_multihost_smoke_under_torchrun():
    """``torchrun`` starts one process per rank; each joins from its
    environment and rank 0 prints the closing line."""
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", "4", "-m",
                        "quantized_distillation_tpu_torch.scripts.multihost_smoke", "--procs", "2",
                        "--device", "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert lines[-1] == multihost_smoke.closing_line(2), r.stdout
    ranks = sorted(line.split("]")[0] for line in lines if line.startswith("[rank "))
    assert ranks == [f"[rank {i}/4" for i in range(4)], r.stdout


def test_multihost_smoke_parses_the_rendezvous_flags():
    a = multihost_smoke.parse_args(["--nnodes", "2", "--node-rank", "1", "--master-addr", "h0",
                                    "--master-port", "29500", "--procs", "4"])
    assert (a.nnodes, a.node_rank, a.master_addr, a.master_port, a.procs) == (2, 1, "h0", 29500, 4)
    assert multihost_smoke.parse_args([]).device == "cuda"  # the card unless asked
