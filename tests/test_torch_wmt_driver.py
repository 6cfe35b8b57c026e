"""The port's WMT driver (``python -m
quantized_distillation_tpu_torch.examples.wmt_distill``) end to end on the
CPU at a tiny size: toy corpus, small presets, one epoch each. It writes
``metrics.jsonl`` with the JAX driver's events, registers both models with
their checkpoints, writes the student's ``.qdt`` (which loads back), and a
second invocation resumes the teacher. Everything stays under
``tmp_path``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from quantized_distillation_tpu_torch.examples import wmt_distill
from quantized_distillation_tpu_torch.models import make_seq2seq
from quantized_distillation_tpu_torch.train.manager import ExperimentManager
from quantized_distillation_tpu_torch.utils.artifact import load_artifact

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TINY = ["--teacher-preset", "student_small", "--student-preset", "student_small",
        "--epochs", "1", "--teacher-epochs", "1", "--toy-size", "120", "--toy-vocab", "40",
        "--batch-size", "16", "--beam", "2", "--max-decode-len", "8"]


def _events(workdir):
    return [json.loads(line) for line in (workdir / "metrics.jsonl").read_text().splitlines()]


def test_driver_runs_end_to_end_and_resumes_the_teacher(tmp_path):
    workdir = tmp_path / "wmt"
    args = TINY + ["--device", "cpu", "--workdir", str(workdir)]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    subprocess.run([sys.executable, "-m", "quantized_distillation_tpu_torch.examples.wmt_distill",
                    *args], cwd=tmp_path, env=env, check=True, timeout=600,
                   capture_output=True)
    events = _events(workdir)
    names = [e["event"] for e in events]
    assert names[0] == "data" and names[-1] == "final"
    assert names.count("epoch") == 2 and "teacher_eval" in names and "teacher_resume" not in names
    final = events[-1]
    for key in ("teacher_bleu", "student_quantized_bleu", "student_perplexity", "size_mb",
                "compression_ratio", "artifact_bytes"):
        assert isinstance(final[key], float), key
    assert final["data_source"] == "toy" and 4 < final["compression_ratio"] < 32

    mgr = ExperimentManager(str(workdir))
    teacher, student = "nmt_student_small_fp32", "nmt_student_small_4bit_uniform"
    assert mgr.list_models() == sorted([teacher, student])
    assert mgr.latest_step(teacher) == mgr.latest_step(student) > 0
    assert mgr.num_training_runs(student) == 1
    assert mgr.get_runs(student)[0]["results"]["compression_ratio"] == final["compression_ratio"]
    template = make_seq2seq("student_small", 40, 40, device="cpu")
    params, meta = load_artifact(str(workdir / f"{student}.qdt"), template, device="cpu")
    assert meta == {"model": student, "step": mgr.latest_step(student)}
    assert os.path.getsize(workdir / f"{student}.qdt") == final["artifact_bytes"]

    assert wmt_distill.main(args) == 0  # the second invocation, in this process
    events = _events(workdir)[len(events):]
    assert [e["event"] for e in events][:3] == ["data", "teacher_resume", "teacher_eval"]
    assert events[1]["step"] == mgr.latest_step(teacher)
    assert ExperimentManager(str(workdir)).num_training_runs(student) == 2


def test_driver_codebook_method_trains_joint(tmp_path):
    workdir = tmp_path / "cb"
    wmt_distill.main(TINY + ["--device", "cpu", "--workdir", str(workdir), "--method",
                             "codebook", "--bits", "2"])
    final = _events(workdir)[-1]
    assert final["event"] == "final" and final["compression_ratio"] > 8
    assert (workdir / "nmt_student_small_2bit_codebook.qdt").exists()


def test_driver_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        wmt_distill.main(TINY + ["--workdir", str(tmp_path / "w")])
    assert wmt_distill.parse_args([]).device == "cuda"
