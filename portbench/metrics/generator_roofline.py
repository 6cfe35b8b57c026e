"""The fused generator's share of its roofline (%): the least time the card
could take for a call (the larger of its operations at the bf16 peak and
its bytes at the memory peak) over the matched kernels' device time a
call. A call at M = rows x beam, K = hidden, N = the padded vocabulary:
2 M K N operations; bytes: x (f32) read once, the packed 4-bit weights,
their scale and offset and the bias read once, M (8 k + 4) bytes of
candidates and logsumexp written (k = 5 candidates). At 1280 x 256 x 32768:
21,474,836,480 operations and 5,954,560 bytes. Kernels:
``csrc/topk_fused.cu``."""

from portbench.counts import generator_width
from portbench.trace import matching

MAIN = ("topk_tc_kernel", "topk_tc_stream_kernel", "topk_partial_kernel")
ALL = MAIN + ("topk_merge_kernel",)
K_CANDIDATES = 5


def call(m: int, k: int, n: int, bits: int = 4):
    """(operations, bytes) of one call."""
    weights = k * n * bits // 8 + 2 * 4 * k * (n // 256) + 4 * n
    return 2.0 * m * k * n, 4.0 * m * k + weights + m * (8 * K_CANDIDATES + 4)


def read(rec):
    sec, _ = matching(rec, ALL)
    _, calls = matching(rec, MAIN)
    if not calls:
        return None
    cfg, pk = rec["config"], rec["peaks"]
    bound = 0.0
    for s in rec["unit_shapes"]:
        m = s["rows"] * s["beam"]
        ops, nbytes = call(m, cfg["student"]["hidden"], generator_width(cfg["vocab"], m),
                           cfg["quant"]["bits"])
        bound += s["steps"] * max(ops / pk["bf16_flops_per_s"], nbytes / pk["hbm_bytes_per_s"])
    return 100.0 * bound / sec
