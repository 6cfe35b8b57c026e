"""The yardstick's arithmetic: operations and bytes from shapes reproduce
PERF.md's kernel table (generator, dequant-matmul and fake-quant rows), and
the metric readers divide as their docstrings say."""

import importlib.util
import json
from pathlib import Path

import pytest

from portbench import counts, trace

HERE = Path(__file__).resolve().parent.parent


def metric(name):
    spec = importlib.util.spec_from_file_location(name, HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


PEAKS = json.loads((HERE / "peaks.json").read_text())
NMT, LM = config("wmt13-nmt-2x256-4bit"), config("ptb-lm-2x256-4bit")


def test_peaks_are_the_data_sheet():
    assert PEAKS["bf16_flops_per_s"] == 989e12
    assert PEAKS["f32_flops_per_s"] == 67e12
    assert PEAKS["hbm_bytes_per_s"] == 3.35e12


def test_generator_width():
    assert counts.generator_width(32000, 1280) == 32768
    assert counts.generator_width(32768, 1280) == 32768


def test_generator_call():
    ops, nbytes = metric("generator_roofline").call(1280, 256, 32768)
    assert (ops, nbytes) == (21_474_836_480, 5_954_560)


def test_dequant_matmul_step():
    m = metric("dequant_matmul_roofline")
    calls = m.step_calls(1280, 256, 256, 2)
    total = [sum(x) for x in zip(*(m.call(*c) for c in calls))]
    assert total == [3_690_987_520, 18_460_672]


def test_fake_quant_weights():
    assert counts.quantized_weights(NMT) == 105_984 * 256
    assert 8 * counts.quantized_weights(NMT) == 217_055_232
    assert counts.quantized_weights(LM) == 24_096 * 256


def test_search_operations_a_row_step():
    shape = {"rows": 256, "beam": 5, "src_len": 24, "steps": 24}
    per_row_step = counts.search(NMT["student"], 32000, shape) / (256 * 5 * 24)
    assert 19e6 < per_row_step < 21e6  # the generator 16.8M, the decoder 2.9M, the encoder


def test_kd_step_operations():
    shape = {"rows": 128, "src_len": 24, "tgt_len": 24}
    s = counts.seq2seq_forward(NMT["student"], 32000, 128, 24, 24)
    t = counts.seq2seq_forward(NMT["teacher"], 32000, 128, 24, 24)
    assert counts.kd_step(NMT, shape) == 3 * s + t
    lm = counts.kd_step(LM, {"rows": 256, "src_len": 0, "tgt_len": 35})
    h, v = 256, 10000
    student = 2 * 256 * 35 * ((256 + h) * 4 * h * 2) + 2 * 256 * 35 * h * v
    assert lm == pytest.approx(3 * student + counts.lm_forward(LM["teacher"], v, 256, 35))


def record(ops, shapes, config_, window=1.0, busy=0.9, units=None):
    return {"window_s": window, "busy_s": busy, "ops": ops, "idle_gaps": {},
            "spans": {"step": [0.002, 0.004]}, "units": units or len(shapes),
            "unit_shapes": shapes, "config": config_, "peaks": PEAKS, "cards": 1}


def test_roofline_readers():
    shape = {"rows": 256, "beam": 5, "src_len": 16, "steps": 16}
    bound_gen = 21_474_836_480 / 989e12
    ops = {"void topk_tc_kernel<4>(...)": [16 * 10 * bound_gen, 16],
           "topk_merge_kernel": [0.0, 16],
           "void dequant_matmul_tc_kernel<...>": [16 * 4 * 18_460_672 / 3.35e12, 48],
           "Memcpy HtoD (Pinned -> Device)": [1.0, 1]}
    rec = record(ops, [shape], NMT)
    assert metric("generator_roofline").read(rec) == pytest.approx(10.0)
    assert metric("dequant_matmul_roofline").read(rec) == pytest.approx(25.0)
    assert metric("launches_per_search").read(rec) == 80
    assert metric("device_idle_share.serve").read(rec) == pytest.approx(10.0)
    assert metric("mfu.decode").read(rec) == pytest.approx(
        100 * counts.search(NMT["student"], 32000, shape) / 989e12)


def test_train_readers():
    n = counts.quantized_weights(NMT)
    ops = {"fake_quant_kernel": [2 * 2 * 8 * n / 3.35e12, 2], "gemm": [0.5, 100]}
    shapes = [{"rows": 256, "src_len": 16, "tgt_len": 16}] * 2
    rec = record(ops, shapes, NMT, window=2.0)
    assert metric("fake_quant_roofline").read(rec) == pytest.approx(50.0)
    assert metric("launches_per_step.train").read(rec) == 51
    assert metric("step_host_ms.train").read(rec) == pytest.approx(3.0)
    assert metric("mfu.train").read(rec) == pytest.approx(
        100 * 2 * counts.kd_step(NMT, shapes[0]) / (2.0 * 67e12))


def test_allreduce_reader():
    ops = {"ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)": [0.012, 48],
           "ncclDevKernel_Broadcast_RING_LL(x)": [5.0, 2], "gemm": [0.5, 100]}
    rec = record(ops, [{"rows": 1024, "src_len": 16, "tgt_len": 16}] * 12, NMT)
    assert metric("allreduce_device_ms.dp").read(rec) == pytest.approx(1.0)


def test_readers_silent_without_their_kernels():
    rec = record({"gemm": [0.1, 3]}, [{"rows": 1, "beam": 5, "src_len": 4, "steps": 4}], NMT)
    for name in ("generator_roofline", "dequant_matmul_roofline", "fake_quant_roofline"):
        assert metric(name).read(rec) is None
    rec = record({}, [], NMT, busy=0.0)
    for name in ("mfu.decode", "mfu.train", "device_idle_share.serve"):
        assert metric(name).read(rec) is None


def test_union_and_gap_labels():
    import numpy as np

    iv = np.array([[0, 2], [1, 3], [5, 6]], dtype=float)
    assert trace._union(iv).tolist() == [[0, 3], [5, 6]]
    host = sorted([(0, 10, "portbench.step", True), (3.5, 4.5, "cudaStreamSynchronize", False),
                   (0, 10, "aten::copy_", False)])
    gaps = np.array([[3.0, 5.0], [6.0, 8.0]])
    idle = trace._label_gaps(gaps, host)
    assert idle == {"step/cudaStreamSynchronize": 2e-9, "step/aten::copy_": 2e-9}
