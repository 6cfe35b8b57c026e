"""The port's ``graft_entry`` (``entry`` and ``dryrun_multichip``) against
the repository root's ``__graft_entry__.py`` on the CPU.

- ``entry``: JAX's own ``entry()`` at full width (``student_medium``, V =
  8192, B = 8, 24 × 24, 4-bit STE) and the port's ``entry(device="cpu")``
  on the same weights (``convert.params_from_numpy``): logits within atol
  1e-5, the f32 tolerance of ``tests/test_torch_seq2seq.py``.
- ``dryrun_multichip(8, device="cpu", dropout=0.0, params=...)`` runs once
  for the module on 8 gloo ranks, mesh (4, 2), on JAX's initial weights;
  JAX's step is built here as ``__graft_entry__.py:55-98`` builds it, on
  the 8-device CPU mesh, at dropout 0:
  - the loss within rtol 1e-5 of JAX's;
  - the ``data``-axis wire bytes of the gradient all-reduce equal to
    JAX's f32 gradient all-reduce (the backward's HLO lines, as
    ``tests/test_torch_scripts_parallel.py`` reads them, less the f32
    scalars of the loss's backward that XLA bundles into one of them), and
    half of them with the 2-byte reduce;
  - the flagship payloads (f32, and at tp = 2) equal, as integers, to
    JAX's from ``jax.eval_shape`` and ``seq2seq_pspecs``;
  - the sharded decode step's all-gathers over ``model`` (count, payload
    and wire bytes) equal to JAX's compiled decode step's at the same mesh
    and shapes, and 0 B on ``data``;
  - the multi-process smoke's closing line; without a step time the
    projection prints "step not measured" and no efficiency; no line of
    output names ``bench_flagship_train.json`` or a TPU.

Tests marked ``gpu`` run on the card (``python -m pytest -m gpu
tests/test_torch_graft_entry.py``) and skip elsewhere: ``entry``'s CUDA
graph bit-equal to its eager call with one fake-quant launch each, and
``dryrun_multichip(1)`` over NCCL with its step and search graphed.
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from quantized_distillation_tpu_torch import graft_entry
from quantized_distillation_tpu_torch.convert import params_from_numpy
from quantized_distillation_tpu_torch.models import make_seq2seq
from quantized_distillation_tpu_torch.scripts import multihost_smoke

torch.set_num_threads(2)

N = 8
FORWARD_ATOL = 1e-5
LOSS_RTOL = 1e-5


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_toy():
    """JAX's toy student, teacher, mesh and batch of ``__graft_entry__.py``'s
    dry run at dropout 0 → (student, sv, tv, mesh, batch shapes)."""
    import jax
    import jax.numpy as jnp

    from quantized_distillation_tpu.models import make_seq2seq as jmake
    from quantized_distillation_tpu.parallel import make_mesh

    mesh = make_mesh(model=2, devices=jax.devices()[:N])
    v, h, e = multihost_smoke.TOY_VOCAB, multihost_smoke.TOY_HIDDEN, multihost_smoke.TOY_EMBED
    b, t = 2 * N, multihost_smoke.TOY_LEN
    student = jmake("student_small", v, v, hidden=h, embed_dim=e, dropout=0.0)
    teacher = jmake("student_small", v, v, hidden=2 * h, embed_dim=e, dropout=0.0)
    src = jnp.ones((b, t), jnp.int32)
    sl = jnp.full((b,), t, jnp.int32)
    sv = student.init(jax.random.PRNGKey(0), src, sl, src)
    tv = teacher.init(jax.random.PRNGKey(1), src, sl, src)
    return {"student": student, "teacher": teacher, "sv": sv, "tv": tv, "mesh": mesh,
            "src": src, "sl": sl}


@pytest.fixture(scope="module")
def dry(jax_toy):
    """The port's dry run on JAX's weights → (report, printed lines)."""
    out = io.StringIO()
    params = {"student": _np(jax_toy["sv"]["params"]), "teacher": _np(jax_toy["tv"]["params"])}
    with contextlib.redirect_stdout(out):
        report = graft_entry.dryrun_multichip(N, device="cpu", dropout=0.0, params=params)
    return report, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def jax_step(jax_toy):
    """JAX's KD step as ``__graft_entry__.py:55-98`` runs it → (loss, the
    ``data``-axis wire bytes of its backward all-reduces)."""
    import jax
    import jax.numpy as jnp

    from quantized_distillation_tpu.config import DistillSpec, QuantSpec, TrainConfig
    from quantized_distillation_tpu.parallel import place_batch, place_params_seq2seq
    from quantized_distillation_tpu.parallel.comm import collective_budget
    from quantized_distillation_tpu.train import (
        build_optimizer,
        create_train_state,
        make_train_step,
        nmt_task,
    )

    j = jax_toy
    mesh, src, sl = j["mesh"], j["src"], j["sl"]
    quant = QuantSpec(bits=4)
    task = nmt_task(j["student"], j["teacher"],
                    {"params": place_params_seq2seq(j["tv"]["params"], mesh)})
    tx = build_optimizer(TrainConfig(learning_rate=1e-3, clip_norm=5.0))
    state = create_train_state(place_params_seq2seq(j["sv"]["params"], mesh), tx, quant=quant)
    step = make_train_step(task, tx, quant=quant, distill=DistillSpec())
    batch = place_batch({"src": src, "src_len": sl, "tgt_in": src, "tgt_out": src,
                         "tgt_mask": jnp.ones(src.shape, jnp.float32)}, mesh)
    rng = jax.device_put(jax.random.PRNGKey(0),
                         jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
    compiled = step.lower(state, batch, rng).compile()
    _, metrics = compiled(state, batch, rng)
    grad = 0
    for line in compiled.as_text().splitlines():
        if "transpose(jvp(" not in line:
            continue
        for op in collective_budget(line, mesh).ops:
            if op.axis == "data" and op.kind == "all-reduce":
                # XLA bundles a few f32 scalars of the loss's backward into
                # a gradient all-reduce: no gradient is a scalar
                scalars = 4 * line.split("all-reduce(")[0].count("f32[]")
                grad += dataclasses.replace(op, bytes=op.bytes - scalars).wire_bytes()
    return float(metrics["loss"]), grad


@pytest.fixture(scope="module")
def jax_decode_budget(jax_toy):
    """JAX's sharded decode step's budget as ``__graft_entry__.py:198-266``
    compiles it."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from quantized_distillation_tpu.parallel.comm import collective_budget
    from quantized_distillation_tpu.serve import pack_decoder, shard_decoder
    from quantized_distillation_tpu.serve.beam import expand_to_beams
    from quantized_distillation_tpu.serve.infer import encode_packed
    from quantized_distillation_tpu.serve.sharded import make_sharded_decode_step_topk

    j = jax_toy
    mesh, sv, student = j["mesh"], j["sv"], j["student"]
    t = multihost_smoke.TOY_LEN
    dec = pack_decoder(sv["params"], student.cfg, 4, compute_dtype=jnp.float32,
                       use_pallas=False)
    sdec = shard_decoder(dec, mesh, sv["params"]["generator"]["kernel"],
                         sv["params"]["generator"]["bias"])
    bs = max(mesh.shape["data"], 2)
    src = jnp.ones((bs, t), jnp.int32)
    keys, enc_out, enc_mask, st0 = encode_packed(student, sv, sdec, src,
                                                 jnp.full((bs,), t, jnp.int32))
    k = graft_entry.KBEAM
    rows = NamedSharding(mesh, P("data"))
    put3 = NamedSharding(mesh, P("data", None, None))
    state = jax.tree.map(lambda x: jax.device_put(x, rows), expand_to_beams(st0, k))
    tokens = jax.device_put(jnp.ones((bs * k,), jnp.int32), rows)
    sstep = make_sharded_decode_step_topk(sdec, mesh, k)
    compiled = jax.jit(sstep).lower(
        state, tokens, jax.device_put(keys, put3), jax.device_put(enc_out, put3),
        jax.device_put(enc_mask, NamedSharding(mesh, P("data", None)))).compile()
    return collective_budget(compiled, mesh)


def test_entry_forward_matches_jax_entry():
    import __graft_entry__ as jentry
    import jax

    jfn, jargs = jentry.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    fn, (_, src, src_len, tgt_in) = graft_entry.entry(device="cpu")
    model = make_seq2seq("student_medium", graft_entry.ENTRY_VOCAB, graft_entry.ENTRY_VOCAB,
                         device="cpu").load_params(params_from_numpy(_np(jargs[0])))
    with torch.no_grad():
        got = fn(dict(model.named_parameters()), src, src_len, tgt_in).numpy()
    assert got.shape == want.shape == (graft_entry.ENTRY_B, graft_entry.ENTRY_LEN,
                                       graft_entry.ENTRY_VOCAB)
    np.testing.assert_allclose(got, want, rtol=0, atol=FORWARD_ATOL)


def test_dryrun_loss_matches_jax_step(dry, jax_step):
    report, lines = dry
    assert report["mesh"] == {"data": 4, "model": 2} and report["backend"] == "gloo"
    assert np.isfinite(report["loss"])
    assert all(loss == report["loss"] for losses in report["losses"].values()
               for loss in losses)
    np.testing.assert_allclose(report["loss"], jax_step[0], rtol=LOSS_RTOL)
    assert f"dryrun_multichip({N}): mesh {{'data': 4, 'model': 2}} loss" in "\n".join(lines)


def test_dryrun_gradient_bytes_match_jax(dry, jax_step):
    report, _ = dry
    data = [op for op in report["budgets"]["f32"].ops
            if op.axis == "data" and op.kind == "all-reduce"]
    # the gradients go in one flat buffer: the largest data all-reduce
    assert max(op.wire_bytes() for op in data) == jax_step[1]
    grad16 = max(op.wire_bytes() for op in report["budgets"]["reduced"].ops
                 if op.axis == "data")
    assert grad16 == jax_step[1] // 2  # 2 bytes an element on the wire


@pytest.mark.parametrize("key", ["f32, pure-DP upper bound", "bf16, pure-DP upper bound",
                                 "f32, tp=2 sharded", "bf16, tp=2 sharded"])
def test_flagship_payloads_equal_jax(dry, key):
    import jax
    import jax.numpy as jnp

    from quantized_distillation_tpu.models import make_seq2seq as jmake
    from quantized_distillation_tpu.parallel.sharding import seq2seq_pspecs

    v = graft_entry.FLAGSHIP_VOCAB
    shapes = jax.eval_shape(jmake("student_medium", v, v).init, jax.random.PRNGKey(0),
                            jnp.ones((1, 8), jnp.int32), jnp.ones((1,), jnp.int32),
                            jnp.ones((1, 8), jnp.int32))["params"]
    leaves = jax.tree.leaves(shapes)
    specs = jax.tree.leaves(seq2seq_pspecs(shapes))
    f32 = sum(4 * int(np.prod(x.shape)) for x in leaves)
    tp = sum(4 * int(np.prod(x.shape)) // (2 if "model" in tuple(s) else 1)
             for x, s in zip(leaves, specs))
    want = {"f32, pure-DP upper bound": f32, "bf16, pure-DP upper bound": f32 // 2,
            "f32, tp=2 sharded": tp, "bf16, tp=2 sharded": tp // 2}
    got = dry[0]["payloads"][key]
    assert isinstance(got, int) and got == want[key]


def test_decode_step_budget_matches_jax(dry, jax_decode_budget):
    report, lines = dry
    port = report["budgets"]["decode_step"]
    ops = port.ops
    want = jax_decode_budget
    assert [(op.kind, op.bytes, op.axis, op.group_size) for op in want.ops] == [
        (op.kind, op.bytes, op.axis, op.group_size) for op in ops]
    assert port.count("all-gather") == 3 and {op.axis for op in ops} == {"model"}
    assert port.bytes_by_axis()["model"] == want.bytes_by_axis()["model"]
    assert port.bytes_by_axis().get("data", 0) == want.bytes_by_axis().get("data", 0) == 0
    assert report["decode"]["tokens_shape"] == (4, graft_entry.SEARCH.max_len)
    assert np.isfinite(report["decode"]["scores"]).all()
    assert len(report["search"]) == N
    for rank in report["search"]:  # every rank holds the whole search's result
        np.testing.assert_array_equal(rank["tokens"], report["search"][0]["tokens"])
        np.testing.assert_array_equal(rank["scores"], report["decode"]["scores"])
    assert any(f"decode-step wire bytes: model {want.bytes_by_axis()['model']}B, data 0B" in line
               for line in lines)


def test_smoke_and_projection_without_a_step(dry):
    report, lines = dry
    assert report["smoke"] == multihost_smoke.closing_line(2)
    assert lines[-1].startswith("dryrun_multichip: multi-process step OK")
    proj = [line for line in lines if "1->2 host projection" in line]
    assert len(proj) == 4 and all(line.endswith("step not measured") for line in proj)
    assert not any("efficiency" in line for line in proj)
    assert all(row["serialized"] is None for row in report["projection"].values())
    assert any("step not measured" in line and "provenance" in line for line in lines)
    text = "\n".join(lines)
    assert "bench_flagship_train" not in text and "TPU" not in text


def test_step_from_the_port_bench_record(tmp_path, capsys):
    """``--step-from``: the 4-bit step of the record the port bench writes,
    and the card and workload it names, not this run's."""
    from quantized_distillation_tpu_torch import bench

    record = {"workload": "wmt13_kd_4bit_ste_train (teacher 2x500 -> student_medium, B=256, "
                          "L=24, V=32000)", "device": "a card", "card": "a card, 650.00 W",
              "train_step_seconds": 0.05, "fp32_step_seconds": 0.06,
              "grad_payload_f32_bytes": 1, "written_by": "python -m "
              "quantized_distillation_tpu_torch.bench --train --family seq2seq",
              "timestamp": "now"}
    path = tmp_path / bench.FLAGSHIP_FILE.name
    path.write_text(json.dumps(record))
    args = graft_entry.parse_args(["--step-from", str(path)])
    assert graft_entry.read_step(args.step_from) == record
    rows = graft_entry.projection({"f32, pure-DP upper bound": 100_000_000}, 0.05,
                                  "this run's card", graft_entry.read_step(path))
    assert rows["f32, pure-DP upper bound"]["serialized"] is not None
    out = capsys.readouterr().out
    assert "50.000 ms" in out and "B=256" in out and "bench --train --family seq2seq" in out
    assert "a card, 650.00 W" in out and "this run's card" not in out
    with pytest.raises(SystemExit):
        graft_entry.parse_args(["--step-from", str(path), "--measure-step"])


@pytest.mark.parametrize("step", [None, 0.0, -1.0, float("nan"), "0.05"])
def test_step_from_refuses_a_record_without_a_step(tmp_path, step):
    path = tmp_path / "record.json"
    path.write_text(json.dumps({"train_step_seconds": step}))
    with pytest.raises(ValueError, match="train_step_seconds"):
        graft_entry.read_step(path)


def test_projection_with_a_step_time(capsys):
    payloads = {"f32, pure-DP upper bound": 100_000_000, "bf16, tp=2 sharded": 25_000_000}
    rows = graft_entry.projection(payloads, 0.004, "a card, 700.00 W")
    t_comm = 100_000_000 / graft_entry.LINK_BYTES_PER_S
    assert rows["f32, pure-DP upper bound"]["serialized"] == pytest.approx(0.004 / (0.004 + t_comm))
    assert rows["f32, pure-DP upper bound"]["overlapped"] == pytest.approx(0.004 / t_comm)
    assert rows["bf16, tp=2 sharded"]["overlapped"] == 1.0
    out = capsys.readouterr().out
    assert "measured on a card, 700.00 W" in out and "assumed" in out
    assert out.count("serialized efficiency") == 2 and "TPU" not in out


def test_backend_rule(monkeypatch, dry):
    """NCCL one rank a card where the ranks fit on the cards, else gloo
    (``parallel.launch.local_backend``, the rule ``scripts.multihost_smoke``
    follows too); the dry run prints the rule it took."""
    from quantized_distillation_tpu_torch.parallel.launch import local_backend

    report, lines = dry
    assert report["rule"] == f"gloo: {N} ranks on the host (device cpu)"
    assert lines[0] == f"dryrun_multichip({N}): backend {report['rule']}"
    assert local_backend("cpu", 8) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert local_backend("cuda", 1) == "nccl"
    assert local_backend("cuda", 4) == "gloo"
    assert graft_entry.parse_args([]).device == "cuda"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_entry_graph_equals_eager(card):
    from quantized_distillation_tpu_torch.kernels import fake_quant_buckets

    fn, example = graft_entry.entry()
    params, *inputs = example
    n0 = fake_quant_buckets.launches
    eager = fn(*example)
    assert fake_quant_buckets.launches == n0 + 1
    call = graft_entry.graphed_entry(fn, example)  # the capture counts nothing
    n1 = fake_quant_buckets.launches
    got = call(*params.values(), *inputs)[0]
    assert fake_quant_buckets.launches == n1 + 1
    assert torch.equal(got, eager)


@pytest.mark.gpu
def test_gpu_dryrun_over_nccl(card, capsys):
    report = graft_entry.dryrun_multichip(1, step_seconds=0.04, dcn_smoke=False)
    assert report["backend"] == "nccl" and report["graphed"] == [True]
    assert report["mesh"] == {"data": 1, "model": 1} and np.isfinite(report["loss"])
    launches = report["launches"][0]
    assert launches["f32"] == launches["reduced"] == {"fake_quant_buckets": 1}
    steps = graft_entry.SEARCH.max_len
    assert launches["search"] == {"dequant_matmul": 2 * steps, "dequant_matmul_topk": steps,
                                  "beam_advance": steps}
    proj = [line for line in capsys.readouterr().out.splitlines() if "projection (" in line]
    assert len(proj) == 4 and all(report["card"] in line for line in proj)
