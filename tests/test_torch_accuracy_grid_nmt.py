"""The port's ``scripts.accuracy_grid`` NMT grid against the JAX script's
``run_nmt_grid`` (``scripts/accuracy_grid.py``, loaded with importlib, left
as it is), on the CPU, dropout 0.

The flags are the smallest at which the teacher learns the toy reversal
task (a few hundred pairs or one epoch leave every BLEU at 0): 2,000
pairs, 3 epochs, B = 32. Two trainings from one init do not stay together
there: f32 rounding differences of 1e-7 between XLA and PyTorch flip a
fake-quant rounding of some weight within the first 7-26 steps of every
quantized student (a jump of one level), and grow through the teacher's
abrupt escape from its loss plateau (steps ~60-140) into other trained
weights (the two teachers read BLEU 46.3 and 86.1 from one init). So the
grid is held to the JAX run in its two halves, each from the JAX side's
own tensors:

- training: from the JAX script's init of each of the 7 models (recorded
  as the JAX run hands it to ``create_train_state``), the port's grid
  steps on the same batches, its students distilling from the JAX run's
  trained teacher; every model's loss over its first ``STEPS_COMPARED``
  steps, before any rounding flip, is the JAX run's within rtol 1e-5;
- deployment: from the weights each JAX model was trained to (recorded as
  the JAX run hands them to ``quantize_tree_hard`` or, for the FP models,
  to ``beam_search``), the port's grid at ``--nmt-epochs 0`` quantizes and
  decodes them into the JAX run's tokens, sentence for sentence, and
  scores them: the teacher's BLEU (above 0) and every cell's are the JAX
  run's within 0.5 BLEU.

Only those steps are compared, so the JAX run trains each student for
them alone (its teacher for all 3 epochs): the students' BLEU is then 0 on
both sides, and their tokens carry the comparison. JAX's compiles (a
train step for each model and batch shape, a beam search for each model)
are most of the time.
"""

import importlib.util
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from quantized_distillation_tpu_torch.convert import params_from_numpy
from quantized_distillation_tpu_torch.models import make_seq2seq
from quantized_distillation_tpu_torch.scripts import accuracy_grid as grid

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
NMT = ["--nmt-data", "2000", "--nmt-epochs", "3", "--batch", "32", "--device", "cpu"]
MODELS = 7  # the teacher, then 2 widths x 3 bit widths
STEPS_COMPARED = 6
LOSS_RTOL = 1e-5
BLEU_TOL = 0.5


@pytest.fixture(scope="module")
def jax_run():
    """The JAX script's NMT grid at NMT → (its result, each model's init,
    per-step losses and trained weights, in the grid's order)."""
    import jax
    import quantized_distillation_tpu.data as jdata
    import quantized_distillation_tpu.serve as jserve
    import quantized_distillation_tpu.train as jtrain
    from quantized_distillation_tpu.train import quantize_tree as jqt

    spec = importlib.util.spec_from_file_location("jax_accuracy_grid",
                                                  REPO / "scripts" / "accuracy_grid.py")
    jgrid = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jgrid)
    rec = {"inits": [], "losses": [], "trained": [], "pending": [], "tokens": []}
    state_fn, step_fn = jtrain.create_train_state, jtrain.make_train_step
    hard_fn, beam_fn = jqt.quantize_tree_hard, jserve.beam_search
    batches_fn = jdata.nmt_batches

    def nmt_batches(corpus, batch_size, **kw):
        # a student trains for the compared steps only: the first epoch's first ones
        stream = batches_fn(corpus, batch_size, **kw)
        if kw.get("drop_remainder") and len(rec["inits"]) > 1:
            return itertools.islice(stream, STEPS_COMPARED if kw.get("seed") == 0 else 0)
        return stream

    def create_train_state(params, tx, **kw):
        rec["inits"].append(jax.tree.map(np.asarray, params))
        return state_fn(params, tx, **kw)

    def make_train_step(*a, **kw):
        step, losses = step_fn(*a, **kw), []
        rec["losses"].append(losses)

        def run(state, batch, rng):
            state, m = step(state, batch, rng)
            losses.append(float(m["loss"]))
            return state, m

        return run

    def quantize_tree_hard(params, spec, *a, **kw):
        rec["pending"].append(jax.tree.map(np.asarray, params))
        return hard_fn(params, spec, *a, **kw)

    def beam_search(model, variables, *a, **kw):
        trained = rec["pending"].pop() if rec["pending"] else jax.tree.map(
            np.asarray, variables["params"])
        rec["trained"].append(trained)
        out = beam_fn(model, variables, *a, **kw)
        rec["tokens"].append(np.asarray(out[0]))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "create_train_state", create_train_state)
        mp.setattr(jtrain, "make_train_step", make_train_step)
        mp.setattr(jqt, "quantize_tree_hard", quantize_tree_hard)
        mp.setattr(jserve, "beam_search", beam_search)
        mp.setattr(jdata, "nmt_batches", nmt_batches)
        out = jgrid.run_nmt_grid(grid.parse_args(NMT))
    assert [len(rec[k]) for k in ("inits", "losses", "trained", "tokens")] == [MODELS] * 4
    return out, rec


def _loading(monkeypatch, trees):
    """Swap the grid's model factory for one that loads ``trees`` in turn."""
    trees = list(trees)

    def twin(preset, src_vocab, tgt_vocab, *, device="cuda", seed=0, **kw):
        return make_seq2seq(preset, src_vocab, tgt_vocab, device=device, seed=seed,
                            **kw).load_params(params_from_numpy(trees.pop(0)))

    monkeypatch.setattr(grid, "make_seq2seq", twin)
    return trees


def test_nmt_training_matches_jax_from_the_same_init(jax_run, monkeypatch):
    _, rec = jax_run
    losses = []
    step_fn = grid.make_train_step

    def make_train_step(*a, **kw):
        step, mine = step_fn(*a, **kw), []
        losses.append(mine)

        def run(state, batch, rng):
            state, m = step(state, batch, rng)
            mine.append(float(m["loss"]))
            return state, m

        return run

    task_fn = grid.nmt_task

    def nmt_task(model, teacher=None, **kw):
        # the students distill from the JAX run's trained teacher, as there
        if teacher is not None:
            teacher.load_params(params_from_numpy(rec["trained"][0]))
        return task_fn(model, teacher, **kw)

    batches_fn = grid.nmt_batches

    def nmt_batches(corpus, batch_size, **kw):
        # the training stream stops after the compared steps
        stream = batches_fn(corpus, batch_size, **kw)
        return itertools.islice(stream, STEPS_COMPARED) if kw.get("drop_remainder") else stream

    left = _loading(monkeypatch, rec["inits"])
    monkeypatch.setattr(grid, "make_train_step", make_train_step)
    monkeypatch.setattr(grid, "nmt_task", nmt_task)
    monkeypatch.setattr(grid, "nmt_batches", nmt_batches)
    args = grid.parse_args(NMT)
    args.nmt_epochs = 1  # the compared steps all lie in the first epoch
    got = grid.run_nmt_grid(args)
    assert len(losses) == MODELS and not left
    assert got["cells"].keys() == jax_run[0]["cells"].keys()
    worst = []
    for mine, want in zip(losses, rec["losses"]):
        assert len(mine) == STEPS_COMPARED and len(want) >= STEPS_COMPARED
        a, b = np.array(mine), np.array(want[:STEPS_COMPARED])
        worst.append(float(np.max(np.abs(a - b) / np.abs(b))))
        np.testing.assert_allclose(a, b, rtol=LOSS_RTOL)
    print(f"largest relative loss gap per model over {STEPS_COMPARED} steps: {worst}")


def test_nmt_deploy_matches_jax_on_the_trained_weights(jax_run, monkeypatch):
    want, rec = jax_run
    left = _loading(monkeypatch, rec["trained"])
    tokens = []
    beam_fn = grid.beam_search

    def beam_search(*a, **kw):
        out = beam_fn(*a, **kw)
        tokens.append(out[0].numpy())
        return out

    monkeypatch.setattr(grid, "beam_search", beam_search)
    args = grid.parse_args(NMT)
    args.nmt_epochs = 0  # the JAX run's trained weights, deployed as they are
    got = grid.run_nmt_grid(args)
    assert not left and len(tokens) == MODELS
    for i, (mine, theirs) in enumerate(zip(tokens, rec["tokens"])):
        np.testing.assert_array_equal(mine, theirs, err_msg=f"model {i}'s tokens")
    assert got["cells"].keys() == want["cells"].keys()
    gaps = {k: abs(got["cells"][k] - want["cells"][k]) for k in want["cells"]}
    gaps["teacher_bleu"] = abs(got["teacher_bleu"] - want["teacher_bleu"])
    print(f"port {got}\nJAX {want}\nlargest BLEU gap {max(gaps.values())}")
    assert want["teacher_bleu"] > 0.0
    assert max(gaps.values()) <= BLEU_TOL, gaps
