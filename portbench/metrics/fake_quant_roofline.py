"""The fake-quant kernel's share of its roofline (%): a call reads and
writes every quantizable weight of the student once in f32 (8 bytes and
8 operations a weight, in whole buckets: 105,984 buckets of 256 for the
seq2seq student at V = 32000, 24,096 for the LM student at V = 10000); the
bound is the larger of the operations at the f32 peak and the bytes at the
memory peak, over the kernel's device time a call. Kernel:
``csrc/fake_quant.cu``."""

from portbench.counts import quantized_weights
from portbench.trace import matching

PATTERNS = ("fake_quant_kernel",)


def read(rec):
    sec, calls = matching(rec, PATTERNS)
    if not calls:
        return None
    n, pk = quantized_weights(rec["config"]), rec["peaks"]
    bound = max(8.0 * n / pk["f32_flops_per_s"], 8.0 * n / pk["hbm_bytes_per_s"])
    return 100.0 * bound * calls / sec
