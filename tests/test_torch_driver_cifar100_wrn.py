"""The port's CIFAR-100 WideResNet driver (``python -m
quantized_distillation_tpu_torch.examples.cifar100_wrn_diffquant``) on the
CPU at a tiny size (WRN-16-2 teacher and student, 40 synthetic images, one
epoch per stage, ``--auto-bits 3``). Its events, their fields and its
registry entries are the JAX package's ``examples/cifar100_wrn_diffquant.py``
ones, pinned below with their lines (a JAX run at these flags takes over a
minute on the CPU). The codebook stage leaves the student's weights as they
are and learns the codebooks; a second invocation resumes the teacher, the
same flags give the same ``metrics.jsonl``, and the driver runs on the card
unless told otherwise."""

import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from quantized_distillation_tpu_torch.examples import cifar100_wrn_diffquant as driver
from quantized_distillation_tpu_torch.kernels.fake_quant import fake_quant_buckets
from quantized_distillation_tpu_torch.train import loops
from quantized_distillation_tpu_torch.train.manager import ExperimentManager

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TINY = ["--teacher", "student_small", "--student", "student_small", "--synthetic-size", "40",
        "--batch-size", "16", "--teacher-epochs", "1", "--epochs", "1",
        "--diffquant-epochs", "1", "--auto-bits", "3"]
TEACHER, STUDENT = "wrn_student_small_fp32", "wrn_student_small_2bit"

# The JAX driver's events at these flags (examples/cifar100_wrn_diffquant.py)
_EPOCH = ("epoch", ["accuracy", "epoch", "loss", "step"])  # train/loops.py:151, per epoch
JAX_EVENTS = [
    ("data", ["n_train", "source"]),  # :70
    _EPOCH,  # the teacher's fit, :97
    ("teacher_eval", ["accuracy"]),  # :103
    _EPOCH,  # the uniform student's fit, :122
    ("student_uniform_eval", ["accuracy"]),  # :129
    ("auto_bits", ["assigned", "mean_target"]),  # :146
    _EPOCH,  # the codebook stage's fit, :161
    ("final", ["compression_ratio", "data_source", "size_mb", "student_diffquant_accuracy",
               "student_uniform_accuracy", "teacher_accuracy"]),  # :178
]
# its registry: both models registered with vars(args) (:94, :121), one run
# recorded on the student (:187)
JAX_RUN = ("differentiable_quantization", ["compression_ratio", "diffquant_acc", "uniform_acc"])


def _events(workdir):
    return [json.loads(line) for line in (workdir / "metrics.jsonl").read_text().splitlines()]


def _untimed(events):
    return [{k: v for k, v in e.items() if k != "t"} for e in events]


def _fields(events):
    return [(e["event"], sorted(k for k in e if k not in ("event", "t"))) for e in events]


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    """The port's driver, run once as a user runs it."""
    root = tmp_path_factory.mktemp("cifar100_wrn")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    subprocess.run(
        [sys.executable, "-m", "quantized_distillation_tpu_torch.examples.cifar100_wrn_diffquant",
         *TINY, "--device", "cpu", "--workdir", str(root / "port")],
        cwd=root, env=env, check=True, timeout=600, capture_output=True)
    return root / "port"


def test_events_and_registry_are_the_jax_drivers(first_run):
    events = _events(first_run)
    assert _fields(events) == JAX_EVENTS
    assert _untimed(events)[0] == {"event": "data", "source": "synthetic", "n_train": 40.0}
    assert events[5]["mean_target"] == 3.0 and events[5]["assigned"] == "[2, 8]"
    final = events[-1]
    assert final["data_source"] == "synthetic" and 8 < final["compression_ratio"] < 32
    assert all(math.isfinite(v) for v in final.values() if isinstance(v, float))

    config = vars(driver.parse_args(TINY + ["--workdir", str(first_run)]))
    del config["device"]
    mgr = ExperimentManager(str(first_run))
    assert mgr.list_models() == sorted([TEACHER, STUDENT])
    for name in (TEACHER, STUDENT):
        assert mgr.get_config(name) == config
        step = mgr.latest_step(name)
        assert step == 40 // 16 and (first_run / name / "checkpoints" / f"{step}.pt").is_file()
    assert mgr.get_runs(TEACHER) == []
    (run,) = mgr.get_runs(STUDENT)
    assert (run["fn"], sorted(run["results"])) == JAX_RUN and run["kwargs"] == config
    assert run["results"]["compression_ratio"] == final["compression_ratio"]


def test_codebook_stage_keeps_the_weights_and_learns_the_codebooks(tmp_path, monkeypatch):
    stages = []
    real_fit = loops.fit

    def fit(task, state, cfg, *args, mode="weights", **kw):
        weights = {n: t.detach().clone() for n, t in state.params.items()}
        books = {p: t.detach().clone() for p, t in (state.codebooks or {}).items()}
        out = real_fit(task, state, cfg, *args, mode=mode, **kw)
        stages.append(mode)
        if mode == "codebooks":
            assert out.params.keys() == weights.keys()
            for n, t in out.params.items():
                assert not t.requires_grad and torch.equal(t, weights[n]), n
            assert books and out.codebooks.keys() == books.keys()
            assert any(not torch.equal(out.codebooks[p], b) for p, b in books.items())
        return out

    monkeypatch.setattr(loops, "fit", fit)
    assert driver.main(TINY + ["--device", "cpu", "--workdir", str(tmp_path / "w")]) == 0
    assert stages == ["weights", "weights", "codebooks"]


def test_second_invocation_resumes_the_teacher(first_run, tmp_path):
    workdir = tmp_path / "resume"
    shutil.copytree(first_run, workdir)
    first = _events(workdir)
    assert driver.main(TINY + ["--device", "cpu", "--workdir", str(workdir)]) == 0
    events = _events(workdir)[len(first):]
    # the JAX driver logs no event when it restores the WRN teacher (:95)
    assert [e["event"] for e in events] == ["data", "teacher_eval", "epoch",
                                            "student_uniform_eval", "auto_bits", "epoch", "final"]
    assert events[1]["accuracy"] == first[2]["accuracy"]  # the same teacher
    assert ExperimentManager(str(workdir)).num_training_runs(STUDENT) == 2


def test_same_flags_same_metrics(first_run, tmp_path):
    assert driver.main(TINY + ["--device", "cpu", "--workdir", str(tmp_path / "again")]) == 0
    assert _untimed(_events(tmp_path / "again")) == _untimed(_events(first_run))


def test_driver_defaults_to_the_card(tmp_path, monkeypatch):
    assert driver.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        driver.main(TINY + ["--workdir", str(tmp_path / "w")])
    assert not (tmp_path / "w").exists()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")


@pytest.mark.gpu
def test_gpu_driver_trains_through_the_fake_quant_kernel(cuda, tmp_path):
    fake_quant_buckets.launches = 0
    assert driver.main(TINY + ["--workdir", str(tmp_path / "gpu")]) == 0
    final = _events(tmp_path / "gpu")[-1]
    assert all(math.isfinite(v) for v in final.values() if isinstance(v, float))
    # one launch per uniform-student STE step, one per quantized eval batch
    # (after the epoch and for student_uniform_eval); the teacher, the bit
    # assignment and the codebook stage (plain PyTorch) launch none
    steps, eval_batches = 40 // 16, math.ceil(40 / 16)
    assert fake_quant_buckets.launches == steps + 2 * eval_batches
