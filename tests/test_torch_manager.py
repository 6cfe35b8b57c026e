"""The port's experiment manager (``train/manager.py``): the run registry as
``tests/test_manager.py`` holds the JAX package's (same ``registry.json``
schema, read by the JAX manager too), checkpoints that round-trip a train
state bit for bit through ``torch.load(weights_only=True)`` (Adam moments,
codebooks, BatchNorm statistics, an LM carry), and ``fit(manager=)``: a
checkpoint after each epoch, and a run stopped after epoch 1 and resumed
from its checkpoint equal to an uninterrupted one. Exact throughout (the
CPU runs the same operations in the same order)."""

import json

import numpy as np
import pytest
import torch

from quantized_distillation_tpu_torch.config import DistillSpec, QuantSpec, TrainConfig
from quantized_distillation_tpu_torch.models import make_cnn, make_lm, make_seq2seq
from quantized_distillation_tpu_torch.train import (
    build_optimizer,
    create_train_state,
    fit,
    lm_initial_carry,
    lm_task,
    make_train_step,
    nmt_task,
    vision_task,
)
from quantized_distillation_tpu_torch.train.manager import ExperimentManager
from quantized_distillation_tpu_torch.train.optim import OptState
from quantized_distillation_tpu_torch.train.trainer import TrainState
from quantized_distillation_tpu_torch.utils.debug import leaves_with_path

torch.set_num_threads(2)

V = 30


# ---------------------------------------------------------------- registry


class TestRegistry:
    def test_add_list_runs(self, tmp_path):
        mgr = ExperimentManager(str(tmp_path))
        mgr.add_new_model("m1", {"bits": 4})
        assert mgr.has_model("m1") and mgr.list_models() == ["m1"]
        assert mgr.get_config("m1") == {"bits": 4}
        mgr.record_run("m1", "train", {"lr": 1e-3}, {"acc": 0.9})
        mgr.record_run("m1", "diffquant", {"bits": 2})
        assert mgr.num_training_runs("m1") == 2
        assert mgr.get_runs("m1")[0]["results"]["acc"] == 0.9

    def test_duplicate_raises(self, tmp_path):
        mgr = ExperimentManager(str(tmp_path))
        mgr.add_new_model("m")
        with pytest.raises(ValueError):
            mgr.add_new_model("m")
        with pytest.raises(KeyError):
            mgr.save("unknown", {"w": torch.zeros(2)}, 1)

    def test_persistence_across_instances(self, tmp_path):
        ExperimentManager(str(tmp_path)).add_new_model("m", {"x": 1})
        mgr2 = ExperimentManager(str(tmp_path))
        assert mgr2.has_model("m")
        assert mgr2.get_config("m") == {"x": 1}

    def test_registry_schema_reads_in_the_jax_manager(self, tmp_path):
        from quantized_distillation_tpu.train.manager import ExperimentManager as JaxManager

        mgr = ExperimentManager(str(tmp_path))
        mgr.add_new_model("m", {"bits": 4, "lr": 1e-3})
        mgr.record_run("m", "train", {"lr": 1e-3}, {"bleu": 20.5})
        mgr.save("m", {"w": torch.ones(3)}, 12)
        theirs = JaxManager(str(tmp_path))
        assert theirs.list_models() == ["m"]
        assert theirs.get_config("m") == {"bits": 4, "lr": 1e-3}
        assert theirs.latest_step("m") == 12
        assert theirs.get_runs("m") == mgr.get_runs("m")
        registry = json.loads((tmp_path / "registry.json").read_text())
        assert set(registry["models"]["m"]) == {"created", "config", "runs", "latest_step"}

    def test_resume_or_register_is_config_aware(self, tmp_path):
        """Resume only when the registered config matches; a changed config
        drops the stale checkpoint pointer at once."""
        mgr = ExperimentManager(str(tmp_path))
        cfg = {"epochs": 2, "lr": 1e-3, "workdir": "/a"}
        assert mgr.resume_or_register("m", cfg) is False  # unknown: registers
        assert mgr.resume_or_register("m", cfg) is False  # no checkpoint yet
        mgr.save("m", {"w": torch.zeros(3)}, 5)
        # same config (the volatile workdir differs): resume
        assert mgr.resume_or_register("m", dict(cfg, workdir="/b")) is True
        # changed config: retrain, re-register, drop the pointer
        assert mgr.resume_or_register("m", dict(cfg, epochs=9)) is False
        assert mgr.get_config("m")["epochs"] == 9
        assert mgr.latest_step("m") is None
        # a retrain interrupted before its first save: train again
        assert mgr.resume_or_register("m", dict(cfg, epochs=9)) is False
        mgr.save("m", {"w": torch.ones(3)}, 2)
        assert mgr.resume_or_register("m", dict(cfg, epochs=9)) is True
        assert torch.equal(mgr.restore("m", {"w": torch.zeros(3)})["w"], torch.ones(3))
        assert torch.equal(mgr.restore("m", {"w": torch.zeros(3)}, step=5)["w"], torch.zeros(3))


# ------------------------------------------------------------- checkpoints


def _assert_states_equal(a, b):
    la, lb = list(leaves_with_path(a)), list(leaves_with_path(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device, path
            assert torch.equal(x, y), path
        else:
            assert x == y, path


def _cnn_setup(seed=0):
    student = make_cnn("student_small", 10, image_size=9, device="cpu", seed=seed)
    rng = np.random.default_rng(1)
    batch = {"image": rng.standard_normal((4, 9, 9, 3)).astype(np.float32),
             "label": rng.integers(0, 10, 4).astype(np.int32)}
    return student, vision_task(student, device="cpu"), batch


def _s2s_setup(seed=0):
    student = make_seq2seq("student_small", V, V, hidden=24, embed_dim=16, device="cpu",
                           seed=seed)
    teacher = make_seq2seq("student_small", V, V, hidden=16, embed_dim=8, device="cpu", seed=9)
    return student, nmt_task(student, teacher, device="cpu")


def _nmt_batch(seed):
    rng = np.random.default_rng(seed)
    return {"src": rng.integers(4, V, (3, 5)).astype(np.int32),
            "src_len": np.array([5, 3, 2], np.int32),
            "tgt_in": rng.integers(1, V, (3, 4)).astype(np.int32),
            "tgt_out": rng.integers(1, V, (3, 4)).astype(np.int32),
            "tgt_mask": np.ones((3, 4), np.float32)}


def _steps(step_fn, state, batches):
    for b in batches:
        state, _ = step_fn(state, b, 7)
    return state


@pytest.mark.parametrize("kind", ["cnn_statistics", "codebooks_joint", "lm_carry"])
def test_state_round_trip_is_bit_exact_and_training_continues(tmp_path, kind):
    """Save after 3 steps, restore into a fresh state, take a 4th step from
    each: the restored state equals the saved one bit for bit, and so do
    the two 4th steps."""
    cfg = TrainConfig(learning_rate=3e-3, clip_norm=1.0)
    if kind == "cnn_statistics":
        def setup(seed):
            student, task, batch = _cnn_setup(seed)
            tx = build_optimizer(cfg)
            quant = QuantSpec(bits=4)
            state = create_train_state(dict(student.named_parameters()), tx, quant=quant,
                                       batch_stats=dict(student.named_buffers()), device="cpu")
            return state, make_train_step(task, tx, quant=quant, device="cpu"), [batch] * 3
    elif kind == "codebooks_joint":
        def setup(seed):
            student, task = _s2s_setup(seed)
            tx = build_optimizer(cfg)
            quant = QuantSpec(bits=2, method="codebook")
            state = create_train_state(dict(student.named_parameters()), tx, quant=quant,
                                       mode="joint", codebook_init="quantile", device="cpu")
            step = make_train_step(task, tx, quant=quant, mode="joint",
                                   distill=DistillSpec(0.5, 2.0), device="cpu")
            return state, step, [_nmt_batch(s) for s in range(3)]
    else:
        def setup(seed):
            student = make_lm("student_small", V, device="cpu", seed=seed, embed_dim=16,
                              hidden=16, num_layers=2)
            tx = build_optimizer(cfg)
            quant = QuantSpec(bits=4)
            state = create_train_state(dict(student.named_parameters()), tx, quant=quant,
                                       carry=lm_initial_carry(student, 2), device="cpu")
            step = make_train_step(lm_task(student, thread_carry=True, device="cpu"), tx,
                                   quant=quant, device="cpu")
            rng = np.random.default_rng(3)
            batches = [{"input": rng.integers(0, V, (2, 5)), "target": rng.integers(0, V, (2, 5))}
                       for _ in range(3)]
            return state, step, batches

    state, step_fn, batches = setup(0)
    state = _steps(step_fn, state, batches)
    mgr = ExperimentManager(str(tmp_path))
    mgr.add_new_model("m")
    mgr.save("m", state, state.step)
    assert mgr.latest_step("m") == 3
    stored = torch.load(tmp_path / "m/checkpoints/3.pt", weights_only=True)
    assert set(stored["train_state"]) == {"step", "params", "opt_state", "batch_stats",
                                          "codebooks", "carry"}

    fresh, fresh_step, _ = setup(5)  # other random weights, zero moments
    restored = mgr.restore("m", fresh)
    assert isinstance(restored, TrainState) and isinstance(restored.opt_state, OptState)
    name = next(iter(fresh.params))
    assert restored.params[name] is fresh.params[name]  # restored into the model's own tensor
    _assert_states_equal(restored, state)
    if kind != "lm_carry":
        assert restored.carry is None
    a, _ = step_fn(state, batches[0], 7)
    b, _ = fresh_step(restored, batches[0], 7)
    _assert_states_equal(a, b)


def test_restore_missing_raises_and_template_must_fit(tmp_path):
    mgr = ExperimentManager(str(tmp_path))
    mgr.add_new_model("empty")
    with pytest.raises(FileNotFoundError):
        mgr.restore("empty", {"a": torch.zeros(3)})
    mgr.save("empty", {"a": torch.zeros(3)}, 1)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore("empty", {"a": torch.zeros(4)})
    with pytest.raises(ValueError, match="keys"):
        mgr.restore("empty", {"b": torch.zeros(3)})


# --------------------------------------------------------------------- fit


def _fit_run(tmp_path, epochs, start_epoch=0, restore_from=None):
    student, task = _s2s_setup()
    cfg = TrainConfig(epochs=epochs, learning_rate=5e-3, clip_norm=1.0, log_every=0,
                      quant=QuantSpec(bits=4), distill=DistillSpec(0.5, 2.0))
    tx = build_optimizer(cfg)
    state = create_train_state(dict(student.named_parameters()), tx, quant=cfg.quant,
                               device="cpu")
    mgr = ExperimentManager(str(tmp_path))
    if not mgr.has_model("s"):
        mgr.add_new_model("s")
    if restore_from is not None:
        state = mgr.restore("s", state, step=restore_from)

    def batches(epoch):  # another data order each epoch
        return iter([_nmt_batch(10 * (epoch + start_epoch) + i) for i in range(2)])

    state = fit(task, state, cfg, batches, tx=tx, manager=mgr, model_name="s", device="cpu")
    return state, mgr


def test_fit_checkpoints_each_epoch_and_resume_equals_uninterrupted(tmp_path):
    full, mgr = _fit_run(tmp_path / "full", epochs=2)
    assert mgr.latest_step("s") == full.step == 4
    assert sorted(p.name for p in (tmp_path / "full/s/checkpoints").iterdir()) == ["2.pt", "4.pt"]
    first, mgr = _fit_run(tmp_path / "cut", epochs=1)
    assert first.step == mgr.latest_step("s") == 2
    resumed, _ = _fit_run(tmp_path / "cut", epochs=1, start_epoch=1, restore_from=2)
    assert resumed.step == 4
    _assert_states_equal(resumed, full)


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_state_round_trip_on_the_card(cuda, tmp_path):
    student = make_seq2seq("student_small", V, V, hidden=24, embed_dim=16, device=cuda)
    tx = build_optimizer(TrainConfig())
    quant = QuantSpec(bits=4)
    state = create_train_state(dict(student.named_parameters()), tx, quant=quant, device=cuda)
    state, _ = make_train_step(nmt_task(student, device=cuda), tx, quant=quant,
                               device=cuda)(state, _nmt_batch(0), 0)
    mgr = ExperimentManager(str(tmp_path))
    mgr.add_new_model("m")
    mgr.save("m", state, state.step)
    other = make_seq2seq("student_small", V, V, hidden=24, embed_dim=16, device=cuda, seed=4)
    fresh = create_train_state(dict(other.named_parameters()), tx, quant=quant, device=cuda)
    _assert_states_equal(mgr.restore("m", fresh), state)
