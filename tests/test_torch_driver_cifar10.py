"""The port's CIFAR-10 driver (``python -m
quantized_distillation_tpu_torch.examples.cifar10_distill``) on the CPU at a
tiny size (the smallest CNN preset, 40 synthetic images, one epoch per
stage), held to the JAX package's ``examples/cifar10_distill.py`` run at the
same flags: the same events with the same fields, the same registry entries.
A second invocation resumes the teacher, the same flags give the same
``metrics.jsonl``, and the driver runs on the card unless told otherwise."""

import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from quantized_distillation_tpu_torch.examples import cifar10_distill as driver
from quantized_distillation_tpu_torch.kernels.fake_quant import fake_quant_buckets
from quantized_distillation_tpu_torch.train.manager import ExperimentManager

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TINY = ["--teacher", "student_small", "--student", "student_small", "--synthetic-size", "40",
        "--batch-size", "16", "--teacher-epochs", "1", "--epochs", "1"]
TEACHER, STUDENT = "cifar10_student_small_fp32", "cifar10_student_small_4bit"


def _events(workdir):
    return [json.loads(line) for line in (workdir / "metrics.jsonl").read_text().splitlines()]


def _untimed(events):
    return [{k: v for k, v in e.items() if k != "t"} for e in events]


def _fields(events):
    return [(e["event"], sorted(k for k in e if k not in ("event", "t"))) for e in events]


def _registry(workdir):
    """Each model's config and runs, the run directory and times left out."""
    models = json.loads((workdir / "registry.json").read_text())["models"]

    def strip(cfg):
        return {k: v for k, v in cfg.items() if k != "workdir"}

    return {name: dict(config=strip(m["config"]), latest_step=m["latest_step"],
                       runs=[(r["fn"], strip(r["kwargs"]), sorted(r["results"]))
                             for r in m["runs"]])
            for name, m in models.items()}


@pytest.fixture(scope="module")
def first_runs(tmp_path_factory):
    """The port's driver and the JAX driver, each run once as a user runs
    it, at the same flags."""
    root = tmp_path_factory.mktemp("cifar10")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2", JAX_PLATFORMS="cpu")
    port, jax_ = root / "port", root / "jax"
    for cmd in ([sys.executable, "-m", "quantized_distillation_tpu_torch.examples.cifar10_distill",
                 *TINY, "--device", "cpu", "--workdir", str(port)],
                [sys.executable, str(REPO / "examples" / "cifar10_distill.py"), *TINY,
                 "--workdir", str(jax_)]):
        subprocess.run(cmd, cwd=root, env=env, check=True, timeout=600, capture_output=True)
    return port, jax_


def test_events_and_registry_are_the_jax_drivers(first_runs):
    port, jax_ = first_runs
    events, jax_events = _events(port), _events(jax_)
    assert _fields(events) == _fields(jax_events)
    assert [e["event"] for e in events] == ["data", "epoch", "teacher_eval", "epoch", "final"]
    assert _untimed(events)[0] == _untimed(jax_events)[0]  # data: source, n_train
    final = events[-1]
    assert final["data_source"] == "synthetic" and 4 < final["compression_ratio"] < 32
    assert all(math.isfinite(v) for v in final.values() if isinstance(v, float))

    reg, jax_reg = _registry(port), _registry(jax_)
    assert sorted(reg) == sorted(jax_reg) == sorted([TEACHER, STUDENT])
    for name in reg:
        assert reg[name]["config"] == jax_reg[name]["config"]
        assert reg[name]["latest_step"] == jax_reg[name]["latest_step"] > 0
        assert reg[name]["runs"] == jax_reg[name]["runs"]
        step = reg[name]["latest_step"]
        assert (port / name / "checkpoints" / f"{step}.pt").is_file()
    (fn, kwargs, results), = reg[STUDENT]["runs"]
    assert fn == "quantized_distillation" and "device" not in kwargs
    assert results == ["accuracy", "compression_ratio", "teacher_accuracy"]


def test_second_invocation_resumes_the_teacher(first_runs, tmp_path):
    workdir = tmp_path / "resume"
    shutil.copytree(first_runs[0], workdir)
    first = _events(workdir)
    assert driver.main(TINY + ["--device", "cpu", "--workdir", str(workdir)]) == 0
    events = _events(workdir)[len(first):]
    assert [e["event"] for e in events] == ["data", "teacher_restored", "teacher_eval",
                                            "epoch", "final"]
    mgr = ExperimentManager(str(workdir))
    assert events[1]["step"] == mgr.latest_step(TEACHER)
    assert events[2]["accuracy"] == first[2]["accuracy"]  # the same teacher
    assert mgr.num_training_runs(STUDENT) == 2


def test_same_flags_same_metrics(first_runs, tmp_path):
    assert driver.main(TINY + ["--device", "cpu", "--workdir", str(tmp_path / "again")]) == 0
    assert _untimed(_events(tmp_path / "again")) == _untimed(_events(first_runs[0]))


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
    # one launch per student STE step, one per quantized eval batch (after
    # the epoch and for the report); the teacher launches none
    steps, eval_batches = 40 // 16, math.ceil(40 / 16)
    assert fake_quant_buckets.launches == steps + 2 * eval_batches
