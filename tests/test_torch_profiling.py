"""The port's profiling helpers (``utils/profiling.py``): the roofline
arithmetic against the JAX package's formula on the H100's data-sheet
peaks, the one definition of those peaks that ``chip_smoke.py`` reads,
``detect_chip`` and ``measure`` raising without a card, and a trace on the
CPU. The ``gpu`` test times a kernel-free call on the card."""

import json

import pytest
import torch

from quantized_distillation_tpu_torch.utils import profiling
from quantized_distillation_tpu_torch.utils.profiling import (
    CHIP_PEAKS,
    detect_chip,
    peaks,
    roofline,
)

torch.set_num_threads(2)

H100 = "NVIDIA H100 80GB HBM3"


def test_h100_peaks_are_the_data_sheet_and_the_smoke_reads_them():
    import chip_smoke

    assert CHIP_PEAKS == {"H100": {"bf16_tflops": 989.0, "f32_tflops": 67.0, "hbm_gbs": 3350.0}}
    assert peaks(H100) is CHIP_PEAKS["H100"]
    assert (chip_smoke.PEAK_BF16, chip_smoke.PEAK_F32, chip_smoke.HBM) == (989e12, 67e12, 3.35e12)
    # the smoke's bound: the larger of operations / peak and bytes / memory rate
    assert chip_smoke.bound(989e9, 0) == (pytest.approx(1.0), "operations")
    assert chip_smoke.bound(0, 3.35e9) == (pytest.approx(1.0), "bytes")
    with pytest.raises(KeyError, match="no peak"):
        peaks("Some Other Card")


@pytest.mark.parametrize("seconds,flops,nbytes,bound", [
    (1e-3, 989e9 * 0.5, 3.35e9 * 0.25, "compute"),   # intensity above the ridge
    (2e-5, 2.0e9, 1.0e8, "memory"),                  # 20 FLOP/byte < ridge (295)
    (5e-6, 0.0, 1.0, "memory"),
])
def test_roofline_arithmetic(seconds, flops, nbytes, bound):
    r = roofline("k", seconds, flops, nbytes, chip=H100)
    tf, gb = flops / seconds / 1e12, nbytes / seconds / 1e9
    assert (r.tflops, r.gbs) == (pytest.approx(tf), pytest.approx(gb))
    assert r.pct_compute == pytest.approx(100 * tf / 989.0)
    assert r.pct_memory == pytest.approx(100 * gb / 3350.0)
    assert r.bound == bound and r.seconds == seconds
    assert r.line().startswith("k: ") and f"{bound}-bound" in r.line()


def test_roofline_formula_matches_jax():
    """The JAX package's formula (``roofline`` with a chip's peaks) on the
    H100's peaks gives the same numbers."""
    from quantized_distillation_tpu.utils import profiling as jprof

    jprof.CHIP_PEAKS["h100-test"] = CHIP_PEAKS["H100"]
    try:
        for args in ((1e-3, 3e11, 2e8), (3e-5, 1e9, 5e8)):
            want = jprof.roofline("k", *args, chip="h100-test")
            got = roofline("k", *args, chip=H100)
            assert (got.tflops, got.gbs, got.pct_compute, got.pct_memory, got.bound) == (
                want.tflops, want.gbs, want.pct_compute, want.pct_memory, want.bound)
    finally:
        del jprof.CHIP_PEAKS["h100-test"]


def test_detect_chip_and_measure_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        detect_chip()
    with pytest.raises(RuntimeError, match="is_available"):
        roofline("k", 1.0, 1.0, 1.0)  # no chip given: asks the card
    with pytest.raises(ValueError, match="CUDA"):
        detect_chip("cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        with profiling.trace("unused"):
            pass


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.key_averages() is not None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_measure_and_detect_chip(cuda):
    x = torch.ones(1024, 1024, device=cuda)
    s = profiling.measure(lambda: x.mul_(1.0), calls=10, reps=3)
    assert 0 < s < 1e-2
    assert detect_chip() == torch.cuda.get_device_name(0)
