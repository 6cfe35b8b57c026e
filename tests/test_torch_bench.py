"""The port's bench (``quantized_distillation_tpu_torch.bench``) against the
repository root's ``bench.py`` on the CPU, at ``--quick`` shapes.

``bench.py`` is loaded by path; its variables and inputs are rebuilt from
``PRNGKey(0)`` exactly as it builds them, carried across with
``convert.params_from_numpy`` and handed to the port's builders:

- serving: the score sums of 2 chained searches equal those of
  ``bench.build``'s ``fp_loop`` (f32: rtol 1e-5, atol 1e-4 a sentence, the
  serve tests' score tolerance) and ``q_loop`` (bf16 compute: within 2e-2 of
  the sum's magnitude, the serve tests' bf16 tolerance); a chain at f32
  compute, built here as ``bench.py:62-86`` builds one, ends on equal
  tokens;
- train: the seq2seq and WRN families (dropout 0), with equal ``n_items``
  and ``grad_payload``: a chain of one step within rtol 1e-5 (the train
  tests' loss tolerance) of ``bench.build_train``'s ``q_loop(1)`` and
  ``fp_loop(1)``, and the losses of 2 chained steps within rtol 1e-4 of
  ``q_loop(2)`` and ``fp_loop(2)``. The looser bound is Adam's, not the
  port's: its first update is lr · sign(g) on every weight, so a weight
  whose gradient is at rounding level in both frameworks can move by +lr in
  one and -lr in the other (measured on the WRN: 16 of 703,284 weights
  2e-3 apart after the 4-bit step, 87 after the FP32 one, every other
  within 1e-4), and the second step's loss differs by up to 3.3e-5 of
  itself; ``tests/test_torch_train.py`` compares whole multi-step runs
  with SGD for the same reason. The LM family's dropout masks cannot be
  shared between the two RNGs, so its weights, batch, ``n_items`` and
  ``grad_payload`` are held equal, and two port runs at one seed equal
  each other;
- engine: the churn fields equal those ``bench.run_engine`` prints, for
  both ``--arrival`` values;
- ``kernels.topk_fused.topk_sorted`` equals a stable descending sort on
  rows with many ties, -inf runs, NaN and ±0, k up to 10;
- the CLI: ``main([..., "--device", "cpu"])`` prints ``bench.py``'s keys,
  metric names and units for each mode; a non-default generator knob is
  rejected; without a card and without ``--device cpu`` it raises.

Tests marked ``gpu`` run on the card (``python -m pytest -m gpu
tests/test_torch_bench.py``) and skip elsewhere: ``topk_sorted`` inside a
CUDA graph against the stable sort, and ``main(["--quick", ...])`` for
serving, the engine and the seq2seq train step.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from quantized_distillation_tpu_torch import bench as pb
from quantized_distillation_tpu_torch.config import BeamConfig
from quantized_distillation_tpu_torch.convert import params_from_numpy, params_to_numpy
from quantized_distillation_tpu_torch.kernels.topk_fused import pick_generator_group, topk_sorted
from quantized_distillation_tpu_torch.models import make_seq2seq
from quantized_distillation_tpu_torch.serve import beam_search_packed, pack_decoder

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
N = 2  # chained searches and train steps
F32_RTOL, SCORE_ATOL = 1e-5, 1e-4
BF16_REL = 2e-2
LOSS_RTOL = 1e-5
ADAM_RTOL = 1e-4  # the losses of 2 chained Adam steps (see the module docstring)
CHURN_KEYS = ("occupancy_at_0.9_load", "steady_state_occupancy", "requests_churned",
              "idle_frac_queue_empty", "idle_frac_midchunk_est")


def _jax_bench():
    spec = importlib.util.spec_from_file_location("root_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _quick(*flags):
    return pb.parse_args(["--quick", "--device", "cpu", *flags])


@pytest.fixture(scope="module")
def serving():
    """``bench.py``'s serving model, variables and sources, rebuilt as
    ``bench.py:38-44`` builds them, and its two loops."""
    import jax
    import jax.numpy as jnp

    from quantized_distillation_tpu.models import make_seq2seq as jmake

    jb = _jax_bench()
    args = _quick()
    fp_loop, q_loop, src, src_len = jb.build(args)
    model = jmake(args.preset, args.vocab, args.vocab)
    rng = jax.random.PRNGKey(0)
    jsrc = jax.random.randint(rng, (args.batch, args.src_len), 4, args.vocab)
    variables = model.init(rng, jsrc, src_len, jnp.ones((args.batch, 2), jnp.int32))
    np.testing.assert_array_equal(np.asarray(jsrc), np.asarray(src))
    return {"jb": jb, "args": args, "model": model, "variables": variables,
            "params": params_from_numpy(_np(variables["params"])), "src": np.asarray(src),
            "src_len": src_len, "fp": float(fp_loop(src, src_len, N)),
            "q": float(q_loop(src, src_len, N))}


def test_serving_chain_sums_equal_bench_py(serving):
    fp_loop, q_loop = pb.build(serving["args"], params=serving["params"], src=serving["src"])
    fp, q = float(fp_loop(N)), float(q_loop(N))
    sentences = N * serving["args"].batch
    np.testing.assert_allclose(fp, serving["fp"], rtol=F32_RTOL, atol=SCORE_ATOL * sentences)
    assert abs(q - serving["q"]) <= BF16_REL * abs(serving["q"])


def test_serving_f32_chain_tokens_equal(serving):
    """Both packages' packed chains at f32 compute, as ``bench.py:62-86``
    builds them, feed back equal tokens and sum equal scores."""
    import jax
    import jax.numpy as jnp

    from quantized_distillation_tpu.config import BeamConfig as JBeamConfig
    from quantized_distillation_tpu.serve.infer import beam_search_packed as jsearch
    from quantized_distillation_tpu.serve.infer import pack_decoder as jpack

    args, model, variables = serving["args"], serving["model"], serving["variables"]
    group = pick_generator_group(args.batch * args.beam)
    jdec = jpack(variables["params"], model.cfg, args.bits, use_pallas=False,
                 generator_group=group, compute_dtype=jnp.float32)
    jcfg = JBeamConfig(beam_size=args.beam, max_len=args.src_len)

    @jax.jit
    def jchain(s0, sl, n):
        def body(c):
            i, s, acc = c
            toks, scores = jsearch(model, variables, jdec, s, sl, jcfg)
            nxt = jnp.clip(toks, 4, args.vocab - 1).astype(jnp.int32)
            return i + 1, nxt, acc + jnp.sum(scores)

        return jax.lax.while_loop(lambda c: c[0] < n, body, (jnp.int32(0), s0, 0.0))

    _, jtoks, jacc = jchain(jnp.asarray(serving["src"]), serving["src_len"], N)

    tmodel = make_seq2seq(args.preset, args.vocab, args.vocab, device="cpu")
    tmodel.load_params(serving["params"])
    tdec = pack_decoder(serving["params"], tmodel.cfg, args.bits, compute_dtype=torch.float32,
                        generator_group=group, device="cpu")
    cfg = BeamConfig(beam_size=args.beam, max_len=args.src_len)
    src = torch.as_tensor(serving["src"], dtype=torch.int64)
    src_len = torch.full((args.batch,), args.src_len, dtype=torch.int64)
    run = pb.chain(lambda s, sl: beam_search_packed(tmodel, tdec, s, sl, cfg, device="cpu"),
                   src, src_len, args.vocab)
    acc, toks = run(N)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(float(acc), float(jacc), rtol=F32_RTOL,
                               atol=SCORE_ATOL * N * args.batch)


def _jax_train(family):
    """``bench.build_train``'s losses of ``N`` chained steps per leg, and
    the variables and batch it trains on, rebuilt as ``bench.py:127-176``
    builds them."""
    import jax
    import jax.numpy as jnp

    jb = _jax_bench()
    args = _quick("--train", "--family", family)
    q_loop, fp_loop, n_items, payload = jb.build_train(args)
    rng = jax.random.PRNGKey(0)
    b, l = args.batch, args.src_len
    if family == "wrn":
        from quantized_distillation_tpu.models import make_wrn

        teacher = make_wrn("student_small", num_classes=100)
        student = make_wrn("student_small", num_classes=100)
        batch = {"image": jax.random.normal(rng, (b, 32, 32, 3), jnp.float32),
                 "label": jax.random.randint(rng, (b,), 0, 100)}
        tv = teacher.init(rng, batch["image"])
        sv = student.init(jax.random.PRNGKey(1), batch["image"])
    elif family == "lm":
        from quantized_distillation_tpu.models import make_lm

        teacher = make_lm("teacher", args.vocab)
        student = make_lm("student_small", args.vocab)
        batch = {"input": jax.random.randint(rng, (b, l), 0, args.vocab),
                 "target": jax.random.randint(rng, (b, l), 0, args.vocab)}
        tv = teacher.init(rng, batch["input"], None)
        sv = student.init(jax.random.PRNGKey(1), batch["input"], None)
    else:
        from quantized_distillation_tpu.models import make_seq2seq as jmake

        teacher = jmake("teacher", args.vocab, args.vocab, dropout=0.0)
        student = jmake(args.preset, args.vocab, args.vocab, dropout=0.0)
        batch = {"src": jax.random.randint(rng, (b, l), 4, args.vocab),
                 "src_len": jnp.full((b,), l, jnp.int32),
                 "tgt_in": jax.random.randint(rng, (b, l), 4, args.vocab),
                 "tgt_out": jax.random.randint(rng, (b, l), 4, args.vocab),
                 "tgt_mask": jnp.ones((b, l), jnp.float32)}
        tv = teacher.init(rng, batch["src"], batch["src_len"], batch["tgt_in"])
        sv = student.init(rng, batch["src"], batch["src_len"], batch["tgt_in"])
    out = {"args": args, "n_items": n_items, "grad_payload": payload, "batch": _np(batch),
           "variables": {"teacher": _np(tv), "student": _np(sv)}}
    if family != "lm":  # the LM's dropout differs between the RNGs: its losses are not compared
        out["loops"] = {n: (float(q_loop(n)), float(fp_loop(n))) for n in (1, N)}
    return out


def _port_legs(jax_run):
    params = {role: {k: params_from_numpy(v) for k, v in variables.items()}
              for role, variables in jax_run["variables"].items()}
    return pb.build_train(jax_run["args"], params=params, batch=jax_run["batch"])


@pytest.mark.parametrize("family", ["seq2seq", "wrn"])
def test_train_chain_losses_equal_bench_py(family):
    jax_run = _jax_train(family)
    legs = _port_legs(jax_run)
    assert legs.n_items == jax_run["n_items"]
    assert legs.grad_payload == jax_run["grad_payload"]
    for n, rtol in ((N, ADAM_RTOL), (1, LOSS_RTOL)):  # the chain reset after 2 steps too
        got = (float(legs.q_loop(n)), float(legs.fp_loop(n)))
        np.testing.assert_allclose(got, jax_run["loops"][n], rtol=rtol, err_msg=f"{n} steps")


def test_train_lm_inputs_equal_bench_py_and_runs_repeat():
    jax_run = _jax_train("lm")
    legs = _port_legs(jax_run)
    assert legs.n_items == jax_run["n_items"]
    assert legs.grad_payload == jax_run["grad_payload"]
    for key, arr in jax_run["batch"].items():
        np.testing.assert_array_equal(legs.batch[key].numpy(), arr)
    got = dict(_flat(params_to_numpy(legs.student)))
    want = dict(_flat(jax_run["variables"]["student"]["params"]))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)
    for loop in (legs.q_loop, legs.fp_loop):
        first, second = float(loop(N)), float(loop(N))
        assert np.isfinite(first) and first == second


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _line(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = fn(*args, **kw)
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert ret is None or line == ret
    return line


@pytest.fixture(scope="module")
def engine_lines(serving):
    """``bench.run_engine``'s line and the port's on the same weights, for
    each ``--arrival``."""
    out = {}
    for arrival in ("poisson", "smooth"):
        args = _quick("--engine", "--arrival", arrival)
        out[arrival] = (_line(serving["jb"].run_engine, args),
                        _line(pb.run_engine, args, params=serving["params"],
                              src=serving["src"]))
    return out


@pytest.mark.parametrize("arrival", ["poisson", "smooth"])
def test_engine_churn_fields_equal_bench_py(engine_lines, arrival):
    jax_line, port_line = engine_lines[arrival]
    assert list(port_line) == list(jax_line)
    for key in CHURN_KEYS + ("offered_load", "arrival", "stage_ahead", "metric", "unit"):
        assert port_line[key] == jax_line[key], key
    assert port_line["value"] > 0 and port_line["offline_same_process_tokens_per_s"] > 0


@pytest.mark.parametrize("flags", [[], ["--train", "--family", "seq2seq"],
                                   ["--train", "--family", "wrn"],
                                   ["--train", "--family", "lm"]],
                         ids=["serve", "train-seq2seq", "train-wrn", "train-lm"])
def test_cli_prints_bench_py_line(flags):
    line = _line(pb.main, ["--quick", "--device", "cpu", *flags])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    source = (REPO / "bench.py").read_text()
    assert f'"{line["metric"]}"' in source and f'"{line["unit"]}"' in source
    assert line["value"] > 0 and line["vs_baseline"] > 0


def test_cli_engine_prints_bench_py_keys(engine_lines):
    line = _line(pb.main, ["--quick", "--device", "cpu", "--engine", "--offline-tok-s", "100"])
    assert list(line) == list(engine_lines["poisson"][0])
    assert line["vs_baseline"] == round(line["value"] / 100, 3)


@pytest.mark.parametrize("flag", ["--gen-store-bits=8", "--gen-group=16", "--gen-lse-shift=0",
                                  "--no-gen-fold", "--gen-pair=1"])
def test_non_default_generator_knob_rejected(flag, capsys):
    with pytest.raises(SystemExit):
        pb.parse_args(["--device", "cpu", flag])
    assert "generator" in capsys.readouterr().err
    assert pb.parse_args(["--device", "cpu"]).gen_lse_shift == 1


def test_no_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        pb.main(["--quick"])


def test_chain_lengths_default_by_mode():
    assert (_quick().lo, _quick().hi) == (1, 3)
    serve = pb.parse_args(["--device", "cpu"])
    train = pb.parse_args(["--device", "cpu", "--train"])
    assert (serve.lo, serve.hi, train.lo, train.hi) == (4, 36, 2, 8)
    short = pb.parse_args(["--device", "cpu", "--train", "--lo", "1", "--hi", "2"])
    assert (short.lo, short.hi) == (1, 2)


def _tied_rows(rng, rows, n):
    """Rows drawn from a few values (many ties), with -inf runs, NaN, ±0."""
    pool = np.array([0.0, -0.0, 1.5, -1.5, 3.0, -np.inf, np.inf, np.nan], np.float32)
    x = rng.choice(pool[:6], size=(rows, n)).astype(np.float32)
    x[0] = -np.inf
    x[1, : n // 2] = -np.inf
    x[2] = rng.choice(pool, size=n)
    x[3] = rng.integers(-2, 3, n).astype(np.float32) * 0.0  # +0 and -0 only
    return x


@pytest.mark.parametrize("k", [1, 2, 5, 8, 10])
@pytest.mark.parametrize("n", [37, 200, 640, 1280])
def test_topk_sorted_equals_stable_sort(n, k):
    rng = np.random.default_rng(n + k)
    x = torch.from_numpy(_tied_rows(rng, 6, n))
    v, i = topk_sorted(x, k)
    sv, si = torch.sort(x, dim=-1, descending=True, stable=True)
    np.testing.assert_array_equal(i.numpy(), si[..., :k].numpy())
    np.testing.assert_array_equal(v.view(torch.int32).numpy(),
                                  sv[..., :k].contiguous().view(torch.int32).numpy())


def test_topk_sorted_candidate_shape_and_k_past_width():
    """The dense search's call: [B, K * V] candidates, integer-valued so
    that many tie; and k larger than the row."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(-5, 5, (4, 5 * 256)).astype(np.float32))
    v, i = topk_sorted(x, 5)
    sv, si = torch.sort(x, dim=-1, descending=True, stable=True)
    assert torch.equal(i, si[:, :5]) and torch.equal(v, sv[:, :5])
    v, i = topk_sorted(x[:, :3], 5)
    assert torch.equal(i, torch.sort(x[:, :3], dim=-1, descending=True, stable=True)[1])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_topk_sorted_in_a_graph_equals_stable_sort(cuda):
    """On the card, inside a CUDA graph (no host sync), at the dense
    search's [B, K * V] shape with ties, -inf runs, NaN and ±0."""
    from quantized_distillation_tpu_torch.utils.graphs import CapturedCall

    rng = np.random.default_rng(7)
    x = torch.from_numpy(_tied_rows(rng, 8, 5 * 3000)).to(cuda)
    call = CapturedCall(lambda t: topk_sorted(t, 5), [x])
    v, i = call(x)
    sv, si = torch.sort(x, dim=-1, descending=True, stable=True)
    assert torch.equal(i, si[:, :5])
    assert torch.equal(v.view(torch.int32), sv[:, :5].contiguous().view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("flags", [[], ["--engine"], ["--train", "--family", "seq2seq"]],
                         ids=["serve", "engine", "train-seq2seq"])
def test_gpu_quick_lines(cuda, flags):
    line = _line(pb.main, ["--quick", *flags])
    assert line["metric"] in (pb.SERVE_METRIC, pb.ENGINE_METRIC,
                              pb.TRAIN_METRICS["seq2seq"][0])
    assert line["value"] > 0
