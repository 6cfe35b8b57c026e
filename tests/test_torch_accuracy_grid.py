"""The port's ``scripts.accuracy_grid`` against the JAX script
``scripts/accuracy_grid.py`` (loaded with importlib, left as it is), on the
CPU at tiny flags.

- ``contract_checks`` equals what the JAX script's ``main()`` prints when
  its ``run_*_grid`` functions return the same fabricated grids.
- The WRN grid (dropout 0), held to the JAX run in its two halves as the
  NMT grid is: training, from JAX's init at the ``PRNGKey`` integer the
  port asks for (the port's model factory is swapped for one that loads
  it), where the configs, the losses before the first weight update, the
  weights after it and the teacher handed to the students are compared;
  and deployment, where the port evaluates the weights each JAX model was
  trained to into JAX's logits and accuracies. At these flags every
  accuracy is at chance, so the accuracies alone would say nothing.
- The CNN grid, port only in its values (dropout 0.3 draws its masks from
  other generators), has the JAX grid's keys, values in [0, 1], and the
  fake-quant launches ``chip_smoke.py`` expects of it.
- ``main`` without ``--device`` asks for the card, and raises without one.

The NMT grid's comparison is ``tests/test_torch_accuracy_grid_nmt.py``.
JAX is imported only inside the tests.
"""

import dataclasses
import importlib.util
import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from quantized_distillation_tpu_torch.convert import flatten_tree, params_to_numpy
from quantized_distillation_tpu_torch.models import make_cnn, make_wrn
from quantized_distillation_tpu_torch.scripts import accuracy_grid as grid
from quantized_distillation_tpu_torch.train import quantize_tree

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TINY = ["--epochs", "1", "--teacher-epochs", "1", "--batch", "16", "--device", "cpu"]
WRN_DATA = 64  # 4 train steps a model; 16 test images: one image is 1/16 of accuracy
WRN_MODELS = 4  # the teacher, then 3 bit widths
LOSS_RTOL = 1e-5
UPDATE_ATOL = 1e-5  # the median weight's distance from JAX's after the first update
UPDATE_FAR = 3e-4  # 0.3 of the learning rate: a distance only sign noise reaches
UPDATE_FLIPS = 1e-3  # the share of weights allowed past UPDATE_FAR
LOGIT_TOL = 1e-5


def load_jax_script():
    spec = importlib.util.spec_from_file_location("jax_accuracy_grid",
                                                  REPO / "scripts" / "accuracy_grid.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jgrid():
    return load_jax_script()


# ------------------------------------------------------------ contract_checks


def _cells(rng, names, bits, scale):
    """A grid's cells: values on a coarse lattice, so equalities and the
    2-point / 2-BLEU margins are hit exactly as often as not."""
    return {f"{n}@{b}": round(float(rng.integers(0, 6)) * scale, 4)
            for n in names for b in bits}


def fabricated(seed):
    rng = np.random.default_rng(seed)
    out = {"cnn_synthetic_cifar100": {"teacher_acc": 0.9, "cells": _cells(
        rng, ("student_small", "student_medium"), ("fp32", 8, 4, 2), 0.01)},
        "wrn_synthetic_cifar100": {"teacher_acc": 0.8, "cells": _cells(
            rng, ("student_small", "student_medium"), ("fp32", 4, 2), 0.01)},
        "nmt_toy": {"teacher_bleu": 99.0, "cells": _cells(
            rng, ("narrow_64h", "wide_128h"), ("fp32", 4, 2), 1.0)}}
    drop = [(), ("wrn_synthetic_cifar100",), ("cnn_synthetic_cifar100",), ("nmt_toy",),
            ("cnn_synthetic_cifar100", "nmt_toy")][seed % 5]
    return {k: v for k, v in out.items() if k not in drop}


def jax_main_out(jgrid, monkeypatch, grids):
    """What the JAX script's ``main()`` prints when its grid functions
    return ``grids``: the flags ask for exactly the grids present."""
    for key, fn in (("cnn_synthetic_cifar100", "run_cnn_grid"),
                    ("wrn_synthetic_cifar100", "run_wrn_grid"), ("nmt_toy", "run_nmt_grid")):
        monkeypatch.setattr(jgrid, fn, lambda args, key=key: grids[key])
    argv = ["accuracy_grid.py"]
    argv += [] if "cnn_synthetic_cifar100" in grids else ["--skip-cnn"]
    argv += ["--wrn"] if "wrn_synthetic_cifar100" in grids else []
    argv += [] if "nmt_toy" in grids else ["--skip-nmt"]
    monkeypatch.setattr(sys, "argv", argv)
    buf = io.StringIO()
    with redirect_stdout(buf):
        jgrid.main()
    return json.loads(buf.getvalue().strip().splitlines()[-1]), argv[1:]


@pytest.mark.parametrize("seed", range(10))
def test_contract_checks_equal_jax(jgrid, monkeypatch, seed):
    grids = fabricated(seed)
    want, flags = jax_main_out(jgrid, monkeypatch, grids)
    assert grid.contract_checks(grids) == want["contract_checks"]
    # the port's main prints the same JSON from the same grids
    for key, fn in (("cnn_synthetic_cifar100", "run_cnn_grid"),
                    ("wrn_synthetic_cifar100", "run_wrn_grid"), ("nmt_toy", "run_nmt_grid")):
        monkeypatch.setattr(grid, fn, lambda args, key=key: grids[key])
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert grid.main(flags + ["--device", "cpu"]) == 0
    assert json.loads(buf.getvalue().strip().splitlines()[-1]) == want


def test_fabricated_grids_take_every_branch():
    seen = {}
    for seed in range(10):
        for name, ok in grid.contract_checks(fabricated(seed)).items():
            seen.setdefault(name, set()).add(ok)
    assert len(seen) == 8
    assert all(v == {True, False} for v in seen.values()), seen


# ---------------------------------------------------------------- the grids


def _recording_step(step_fn, rec, snapshot):
    """``make_train_step`` that appends each step's loss to a new list in
    ``rec["losses"]`` and the parameters after its first two steps, as
    ``snapshot(params)`` gives them, to ``rec["updated"]``."""

    def make_train_step(*a, **kw):
        step, losses, after = step_fn(*a, **kw), [], []
        rec["losses"].append(losses)
        rec["updated"].append(after)

        def run(state, batch, rng):
            state, m = step(state, batch, rng)
            losses.append(float(m["loss"]))
            if len(after) < 2:
                after.append(snapshot(state.params))
            return state, m

        return run

    return make_train_step


def _recording_args(fn, calls, i):
    """``fn`` that records argument ``i`` of each call (a TrainConfig as a
    dict, or ``steps_per_epoch``) in ``calls``."""

    def run(*a, **kw):
        arg = a[i] if len(a) > i else kw.get("steps_per_epoch")
        calls.append(dataclasses.asdict(arg) if dataclasses.is_dataclass(arg) else arg)
        return fn(*a, **kw)

    return run


@pytest.fixture(scope="module")
def jax_wrn_run(jgrid):
    """The JAX script's WRN grid at TINY (a WRN-16-2 teacher, the three
    WRN-16-2 cells) → (its result, and per model in the grid's order: the
    TrainConfig ``fit`` gets and the step count ``build_optimizer`` gets,
    each train step's loss, the parameters after the first two steps, the
    variables the model was evaluated on, and its eval logits)."""
    import jax
    import quantized_distillation_tpu.train as jtrain
    import quantized_distillation_tpu.train.loops as jloops
    from quantized_distillation_tpu.models import make_wrn as jax_make_wrn
    from quantized_distillation_tpu.train import quantize_tree as jqt

    rec = {"fit": [], "steps_per_epoch": [], "losses": [], "updated": [], "trained": [],
           "logits": []}
    eval_fn = jtrain.make_eval_step

    def make_eval_step(task, quant=None, **kw):
        # the eval step's own logits: its hard quantization, then the forward
        @jax.jit
        def logits(params, stats, batch):
            if quant is not None:
                params = jqt.quantize_tree_hard(params, quant)
            return task.student_forward({"params": params, "batch_stats": stats}, batch,
                                        False, {})[0]

        ev, mine = eval_fn(task, quant=quant, **kw), []
        rec["logits"].append(mine)

        def run(state, batch):
            if not mine:
                rec["trained"].append(jax.tree.map(
                    np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))
            mine.append(np.asarray(logits(state.params, state.batch_stats, batch)))
            return ev(state, batch)

        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloops, "fit", _recording_args(jloops.fit, rec["fit"], 2))
        mp.setattr(jtrain, "build_optimizer",
                   _recording_args(jtrain.build_optimizer, rec["steps_per_epoch"], 1))
        mp.setattr(jloops, "make_train_step", _recording_step(
            jloops.make_train_step, rec, lambda p: flatten_tree(jax.tree.map(np.asarray, p))))
        mp.setattr(jtrain, "make_eval_step", make_eval_step)
        out = jgrid.run_vision_grid(grid.parse_args(TINY), jax_make_wrn, "student_small",
                                    ("student_small",), "wrn", bit_list=(None, 4, 2),
                                    n_data=WRN_DATA)
    assert [len(v) for v in rec.values()] == [WRN_MODELS] * len(rec), rec.keys()
    return out, rec


def _port_wrn_run(monkeypatch, factory, argv):
    """The port's WRN grid at ``argv`` with ``factory`` as its model
    factory, recorded as ``jax_wrn_run`` records the JAX run → (its
    result, the record)."""
    from quantized_distillation_tpu_torch.train import loops

    rec = {"fit": [], "steps_per_epoch": [], "losses": [], "updated": [], "trained": [],
           "logits": []}
    eval_fn = grid.make_eval_step

    def make_eval_step(task, quant=None, **kw):
        ev, mine = eval_fn(task, quant=quant, **kw), []
        rec["logits"].append(mine)

        def run(state, batch):
            if not mine:
                rec["trained"].append({k: {n: t.clone() for n, t in v.items()} for k, v in (
                    ("params", state.params), ("batch_stats", state.batch_stats))})
            params = state.params
            if quant is not None:
                params = quantize_tree.quantize_tree_hard(params, quant)
            b = {k: torch.as_tensor(v) for k, v in batch.items() if k != "index"}
            with torch.no_grad():
                mine.append(task.student_forward({**params, **state.batch_stats}, b, False,
                                                 None)[0].numpy())
            return ev(state, batch)

        return run

    monkeypatch.setattr(grid, "fit", _recording_args(grid.fit, rec["fit"], 2))
    monkeypatch.setattr(grid, "build_optimizer",
                        _recording_args(grid.build_optimizer, rec["steps_per_epoch"], 1))
    monkeypatch.setattr(loops, "make_train_step", _recording_step(
        loops.make_train_step, rec, lambda p: flatten_tree(params_to_numpy(p))))
    monkeypatch.setattr(grid, "make_eval_step", make_eval_step)
    got = grid.run_vision_grid(grid.parse_args(argv), factory, "student_small",
                               ("student_small",), "wrn", bit_list=(None, 4, 2),
                               n_data=WRN_DATA)
    return got, rec


def test_wrn_grid_matches_jax_on_the_same_weights(jax_wrn_run, monkeypatch):
    """The port's WRN grid trains as the JAX run does, from JAX's init at
    the integer the port asks for:

    - every ``fit`` gets JAX's TrainConfig (schedule, KD, bits, seed) and
      every ``build_optimizer`` JAX's step count;
    - the losses of the steps no weight update has reached yet (the
      teacher's first; the students' first two, where the cosine warmup's
      first rate is 0) are JAX's within LOSS_RTOL, the students distilling
      from the JAX run's trained teacher: init seeds, augment seeds, the
      fake-quant forward and the KD targets show here;
    - after the first update (the teacher's first step, the students'
      second) the median weight is JAX's within UPDATE_ATOL and at most
      UPDATE_FLIPS of them lie UPDATE_FAR or more away: a wrong rate or
      gradient moves them all;
    - the teacher the students distill from holds the variables the port's
      teacher training ended with.

    The two runs part by rounding alone, and no closer comparison holds:
    Adam's first update is lr * sign(g), so a weight whose gradient is
    rounding noise moves 2 * lr the other way (40 of WRN-16-2's 703,284
    weights after the teacher's first step), and the teacher's loss two
    steps on is off by 1e-4. In the quantized cells a ReLU whose input is
    rounding noise flips (the 4-bit cell's smallest pre-ReLU value at its
    last BatchNorm is 7e-6, against a typical 0.64), which moves every
    gradient below it by about 0.5%: 4-6% of their weights end 1e-5 or more
    from JAX's after the first update, 0.015% of them 3e-4 or more.
    Measured medians are 6e-7 or less."""
    import jax
    import jax.numpy as jnp
    from quantized_distillation_tpu.models import make_wrn as jax_make_wrn

    want, jrec = jax_wrn_run

    def twin(preset, num_classes=100, *, device="cuda", seed=0):
        v = jax_make_wrn(preset, num_classes=num_classes).init(
            jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)))
        return make_wrn(preset, num_classes, device=device, seed=seed).load_params(
            v["params"]).load_batch_stats(v["batch_stats"])

    task_fn, seen = grid.vision_task, []

    def vision_task(student, teacher=None, **kw):
        if teacher is not None:
            if not seen:  # before the load below: what the port's grid hands over
                seen.append({n: t.clone() for n, t in [*teacher.named_parameters(),
                                                       *teacher.named_buffers()]})
            v = jrec["trained"][0]
            teacher.load_params(v["params"]).load_batch_stats(v["batch_stats"])
        return task_fn(student, teacher, **kw)

    monkeypatch.setattr(grid, "vision_task", vision_task)
    got, rec = _port_wrn_run(monkeypatch, twin, TINY)
    assert got["cells"].keys() == want["cells"].keys()
    assert rec["fit"] == jrec["fit"] and rec["steps_per_epoch"] == jrec["steps_per_epoch"]
    for i, (mine, theirs) in enumerate(zip(rec["losses"], jrec["losses"])):
        n = 1 if i == 0 else 2
        assert len(mine) == len(theirs) == WRN_DATA // 16
        np.testing.assert_allclose(mine[:n], theirs[:n], rtol=LOSS_RTOL,
                                   err_msg=f"model {i}'s losses")
    moved = []
    for i, (mine, theirs) in enumerate(zip(rec["updated"], jrec["updated"])):
        a, b = mine[0 if i == 0 else 1], theirs[0 if i == 0 else 1]
        assert a.keys() == b.keys()
        d = np.concatenate([np.abs(a[k] - b[k]).ravel() for k in b])
        moved.append((float(np.median(d)), float(np.mean(d > UPDATE_FAR))))
    teacher = {**rec["trained"][0]["params"], **rec["trained"][0]["batch_stats"]}
    assert seen[0].keys() == teacher.keys()
    for name, t in seen[0].items():
        torch.testing.assert_close(t, teacher[name], rtol=0, atol=0, msg=name)
    gaps = {k: abs(got["cells"][k] - want["cells"][k]) for k in want["cells"]}
    gaps["teacher_acc"] = abs(got["teacher_acc"] - want["teacher_acc"])
    print(f"after the first update, per model (median distance from JAX's weights, share "
          f"past {UPDATE_FAR}): {moved}; accuracy gaps {gaps}")
    assert all(m <= UPDATE_ATOL and far <= UPDATE_FLIPS for m, far in moved), moved
    one_image = 1.0 / (WRN_DATA // 4)
    assert max(gaps.values()) <= one_image + 1e-4, (got, want)


def test_wrn_grid_deploys_jax_trained_weights_as_jax(jax_wrn_run, monkeypatch):
    """On the variables each JAX model was trained to, the port's grid
    (training skipped) evaluates every model, the quantized ones
    hard-quantized at their bits, to the JAX run's logits and accuracies."""
    want, jrec = jax_wrn_run
    trained = list(jrec["trained"])

    def loading(preset, num_classes=100, *, device="cuda", seed=0):
        v = trained.pop(0)
        return make_wrn(preset, num_classes, device=device, seed=seed).load_params(
            v["params"]).load_batch_stats(v["batch_stats"])

    monkeypatch.setattr(grid, "fit", lambda task, state, *a, **kw: state)
    got, rec = _port_wrn_run(monkeypatch, loading, TINY)
    assert not trained and len(rec["logits"]) == WRN_MODELS
    worst = 0.0
    for i, (mine, theirs) in enumerate(zip(rec["logits"], jrec["logits"])):
        a, b = np.concatenate(mine), np.concatenate(theirs)
        worst = max(worst, float(np.max(np.abs(a - b))))
        np.testing.assert_allclose(a, b, rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=f"model {i}'s eval logits")
    print(f"largest eval-logit gap: {worst}")
    assert got == want


def test_cnn_grid_keys_values_and_launches(jgrid, monkeypatch):
    args = grid.parse_args(TINY + ["--cnn-teacher", "student_small", "--cnn-data", "64"])
    # the JAX grid's keys: its cells stubbed, its teacher trained for real
    monkeypatch.setattr(jgrid, "vision_cell", lambda *a: 0.5)
    want = jgrid.run_cnn_grid(args)
    calls = []
    real = quantize_tree.fake_quant_buckets
    monkeypatch.setattr(quantize_tree, "fake_quant_buckets",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = grid.run_cnn_grid(args)
    assert got.keys() == want.keys() == {"teacher_acc", "cells"}
    assert list(got["cells"]) == list(want["cells"]) and len(got["cells"]) == 8
    values = [got["teacher_acc"], *got["cells"].values()]
    assert all(0.0 <= v <= 1.0 for v in values), got
    # the wrapper's plain version runs here: its calls are the card's launches
    assert len(calls) == chip_smoke.grid_fake_quant_launches(args)["cnn"]


def test_wrn_and_nmt_launches_are_the_formula(monkeypatch):
    # WRN-28-10 is too big for the CPU: its grid with a WRN-16-2 teacher
    monkeypatch.setattr(grid, "make_wrn", lambda preset, *a, **kw: make_wrn(
        "student_small" if preset == "teacher" else preset, *a, **kw))
    calls = []
    real = quantize_tree.fake_quant_buckets
    monkeypatch.setattr(quantize_tree, "fake_quant_buckets",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    args = grid.parse_args(["--device", "cpu", "--skip-cnn", "--wrn", "--wrn-data", "48",
                            "--epochs", "2", "--teacher-epochs", "1", "--batch", "16",
                            "--nmt-data", "200", "--nmt-epochs", "2"])
    want = chip_smoke.grid_fake_quant_launches(args)
    grid.run_wrn_grid(args)
    assert len(calls) == want["wrn"] == 4 * (2 * 3 + 1)  # the last test batch short
    grid.run_nmt_grid(args)
    assert len(calls) - want["wrn"] == want["nmt"] and want["cnn"] == 0


def test_grid_factories_are_the_module_names():
    # the tests swap these module-level names for the JAX init's twins
    assert grid.make_wrn is make_wrn and grid.make_cnn is make_cnn
    assert grid.run_wrn_grid.__globals__ is vars(grid)


def test_main_defaults_to_the_card():
    assert grid.parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: main([]) would run the grid on it")
    with pytest.raises(RuntimeError, match="cuda"):
        grid.main([])


def test_expected_launches_formula_counts_quantized_cells():
    a = grid.parse_args(["--wrn", "--device", "cpu"])
    n = chip_smoke.grid_fake_quant_launches(a)
    # 6 CNN cells of 12 epochs x 32 steps + 8 eval batches; 4 WRN cells of
    # 12 x 16 + 4; the NMT cells' steps follow the corpus's buckets
    assert n["cnn"] == 6 * (12 * 32 + 8) and n["wrn"] == 4 * (12 * 16 + 4)
    assert n["nmt"] > 4 and (n["nmt"] - 4) % (4 * 6) == 0
