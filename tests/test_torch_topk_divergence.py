"""The port's ``scripts.topk_divergence`` on the CPU at a tiny size (its
module constants shrunk), against the JAX script ``scripts/
topk_divergence.py`` (loaded with importlib, left as it is).

- The output's top-level and per-entry keys are the JAX script's (read
  from its source: its measure stage runs TPU kernels with no interpret
  flag, so it cannot run here).
- On the CPU both paths run the plain versions: no mismatch, token
  agreement 1.0, equal BLEUs, and ``rows`` counts the walk's live rows.
- The train stage's per-epoch losses equal the JAX script's
  ``train_stage`` (rtol 1e-4) from the JAX init, carried across; JAX's
  ``params_path`` points into ``tmp_path``.

The ``gpu`` test runs the script at V = 2000 on the card. JAX is imported
only inside the CPU tests.
"""

import ast
import importlib.util
import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from quantized_distillation_tpu_torch.convert import params_from_numpy
from quantized_distillation_tpu_torch.data import nmt_batches
from quantized_distillation_tpu_torch.models import SEQ2SEQ_PRESETS
from quantized_distillation_tpu_torch.scripts import topk_divergence as td

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
JAX_SCRIPT = REPO / "scripts" / "topk_divergence.py"
TINY = {"VOCAB": 300, "N_TRAIN": 512, "EPOCHS": 2, "HIDDEN": 32, "EMBED": 16}
SEEDS, STEPS, BATCH, BEAM = 3, 10, 64, 5  # measure_stage's defaults, as main runs it


def _dict_keys(node):
    return [k.value for k in node.keys]


def jax_output_keys():
    """(top-level keys, per-entry keys of ``per_step``, keys of an
    ``end_to_end`` row) of the JAX script's measure stage, from its source."""
    tree = ast.parse(JAX_SCRIPT.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "measure_stage")
    top = entry = row = None
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            target = node.targets[0]
            if isinstance(target, ast.Name) and target.id == "out":
                top = _dict_keys(node.value)
            elif (isinstance(target, ast.Subscript) and isinstance(target.value, ast.Subscript)
                  and getattr(target.value.value, "id", None) == "out"):
                entry = _dict_keys(node.value)  # out["per_step"][f"slots{s}"] = {...}
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "append" and isinstance(node.args[0], ast.Dict)):
            row = _dict_keys(node.args[0])
    return top, entry, row


@pytest.fixture(scope="module")
def port_run():
    """The port's ``main`` at the tiny size on the CPU → (its JSON, its
    report, the trained model)."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in TINY.items():
            mp.setattr(td, k, v)
        models = []
        real = td.make_seq2seq
        mp.setattr(td, "make_seq2seq", lambda *a, **kw: models.append(real(*a, **kw))
                   or models[-1])
        report = {}
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert td.main(["--device", "cpu"], report=report) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1]), report, models[0]


def test_output_keys_equal_the_jax_script(port_run):
    out, _, _ = port_run
    top, entry, row = jax_output_keys()
    assert list(out) == top
    assert list(out["per_step"]) == ["exact"]  # the port's top-k has no slots
    assert list(out["per_step"]["exact"]) == entry
    assert len(out["end_to_end"]) == SEEDS
    assert all(list(r) == row for r in out["end_to_end"])
    assert (out["vocab"], out["beam"], out["bits"], out["steps"], out["seeds"]) == (
        TINY["VOCAB"], BEAM, 4, STEPS, SEEDS)


def test_cpu_paths_agree_exactly(port_run):
    out, report, _ = port_run
    ex = out["per_step"]["exact"]
    assert ex["topk_set_mismatch_rate"] == ex["top1_mismatch_rate"] == 0.0
    assert ex["cert_fail_rate"] == 0.0 and ex["unsound_certificates"] == 0
    assert ex["mismatch_value_gap_max"] == ex["unsound_value_gap_rel_max"] == 0.0
    assert out["f32_shared_rounding_unsound"] == report["f32_mismatch_past_bound"] == 0
    for r in out["end_to_end"]:
        assert r["token_agreement"] == 1.0 and r["bleu_fused"] == r["bleu_exact"]
    # the plain versions count no launch
    assert report["search_launches"] == {"fused": {}, "exact": {}}


def test_rows_are_the_live_rows_of_the_walk(port_run):
    out, _, model = port_run
    params = td.params_to_numpy(model)
    dec = td.pack_decoder(params, model.cfg, 4, compute_dtype=torch.bfloat16, device="cpu")
    live_rows, steps = [], []
    with torch.no_grad():
        for seed in range(SEEDS):
            tb = next(nmt_batches(td.build_corpus(BATCH, 1000 + seed, TINY["VOCAB"]), BATCH,
                                  shuffle=False))
            src, src_len = torch.as_tensor(tb["src"]).long(), torch.as_tensor(tb["src_len"]).long()
            td.walk(model, dec, src, src_len, BEAM, STEPS, TINY["VOCAB"],
                    lambda live, *rest: (live_rows.append(int(live.sum())),
                                         steps.append(live.numel())))
    assert steps == [BATCH * BEAM] * (SEEDS * STEPS)
    assert out["per_step"]["exact"]["rows"] == sum(live_rows)
    assert live_rows[0] == BATCH * BEAM and min(live_rows) < BATCH * BEAM  # beams finish


def test_train_stage_losses_match_jax(monkeypatch, tmp_path, capsys):
    import jax
    import quantized_distillation_tpu.train as jtrain

    spec = importlib.util.spec_from_file_location("jax_topk_divergence", JAX_SCRIPT)
    jtd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtd)
    for k, v in TINY.items():
        monkeypatch.setattr(jtd, k, v)
        monkeypatch.setattr(td, k, v)
    monkeypatch.setattr(jtd, "params_path", lambda: str(tmp_path / "params.msgpack"))
    inits, losses = [], []
    real_state, real_step = jtrain.create_train_state, jtrain.make_train_step

    def recording_state(params, tx, **kw):
        inits.append(jax.tree.map(np.asarray, params))
        return real_state(params, tx, **kw)

    def recording_step(*a, **kw):
        step = real_step(*a, **kw)

        def run(state, batch, rng):
            state, m = step(state, batch, rng)
            losses.append(float(m["loss"]))
            return state, m

        return run

    monkeypatch.setattr(jtrain, "create_train_state", recording_state)
    monkeypatch.setattr(jtrain, "make_train_step", recording_step)
    jtd.train_stage()
    assert (tmp_path / "params.msgpack").is_file() and len(inits) == 1
    per_epoch = len(losses) // TINY["EPOCHS"]
    assert per_epoch * TINY["EPOCHS"] == len(losses)
    want = [float(np.mean(losses[e * per_epoch:(e + 1) * per_epoch]))
            for e in range(TINY["EPOCHS"])]

    real = td.make_seq2seq
    monkeypatch.setattr(td, "make_seq2seq", lambda *a, **kw: real(*a, **kw).load_params(
        params_from_numpy(inits[0])))
    _, got = td.train_stage(device="cpu")
    print(f"per-epoch losses port {got} JAX {want}")
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert capsys.readouterr().err.count("train epoch") == 2 * TINY["EPOCHS"]


def test_f32_noise_bound():
    # 2 gamma_{K+2} at K = 256: 2 * 258 u / (1 - 258 u), u = 2^-24
    u = 2.0 ** -24
    assert td.f32_noise_rel(256) == pytest.approx(2 * 258 * u / (1 - 258 * u), rel=1e-12)
    assert td.BF16_NOISE_REL == 8 * 2.0 ** -8


def test_main_defaults_to_the_card(monkeypatch):
    assert td.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        td.main([])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")


@pytest.mark.gpu
def test_gpu_walk_at_vocab_2000(cuda):
    report = {}
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert td.main(["--vocab", "2000"], report=report) == 0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    ex = out["per_step"]["exact"]
    assert out["vocab"] == 2000 and ex["rows"] > 0
    assert ex["mismatch_value_gap_rel_max"] <= td.BF16_NOISE_REL
    assert report["f32_mismatch_past_bound"] == 0
    assert all(np.isfinite([r["bleu_fused"], r["bleu_exact"]]).all() for r in out["end_to_end"])
    # a decode step: a dequant-matmul for each LSTM layer and attn_out, 1
    # fused generator and 1 beam advance in the fused search; one more
    # dequant-matmul (the logits) in the exact one
    n, dm = SEEDS * STEPS, SEQ2SEQ_PRESETS[td.PRESET]["num_layers"] + 1
    assert report["search_launches"]["fused"] == {
        "dequant_matmul": dm * n, "dequant_matmul_topk": n, "beam_advance": n}
    assert report["search_launches"]["exact"] == {"dequant_matmul": (dm + 1) * n}
