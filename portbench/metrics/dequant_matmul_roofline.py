"""The dequant-matmul kernel's share of its roofline (%), over a decode
step's three calls: the two LSTM layers' fused [x; h] x [W_i; W_h]
(bf16 x) and the attention output projection (f32 x). A call [M, K] x
[K, N]: 2 M K N operations; bytes: x read once, the packed 4-bit weights
and their scale and offset read once, the f32 output written once. At M =
1280, hidden 256: 3,690,987,520 operations and 18,460,672 bytes a step.
The bound is each call's larger of operations at the bf16 peak and bytes
at the memory peak, summed. Kernels: ``csrc/dequant_matmul.cu``."""

from portbench.trace import matching

PATTERNS = ("dequant_matmul_kernel", "dequant_matmul_tc_kernel")


def step_calls(m: int, embed: int, hidden: int, layers: int):
    """[(M, K, N, x bytes an element)] of one decode step."""
    cells = [(m, (embed + hidden if i == 0 else hidden) + hidden, 4 * hidden, 2)
             for i in range(layers)]
    return cells + [(m, 2 * hidden, hidden, 4)]


def call(m: int, k: int, n: int, x_bytes: int, bits: int = 4):
    """(operations, bytes) of one call."""
    weights = k * n * bits // 8 + 2 * 4 * k * (-(-n // 256))
    return 2.0 * m * k * n, m * k * x_bytes + weights + 4.0 * m * n


def read(rec):
    sec, calls = matching(rec, PATTERNS)
    if not calls:
        return None
    cfg, pk = rec["config"], rec["peaks"]
    st = cfg["student"]
    bound = 0.0
    for s in rec["unit_shapes"]:
        for shape in step_calls(s["rows"] * s["beam"], st["embed_dim"], st["hidden"],
                                st["num_layers"]):
            ops, nbytes = call(*shape, cfg["quant"]["bits"])
            bound += s["steps"] * max(ops / pk["bf16_flops_per_s"], nbytes / pk["hbm_bytes_per_s"])
    return 100.0 * bound / sec
