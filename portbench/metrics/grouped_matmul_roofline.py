"""The grouped expert matmul's share of its roofline (%): for each traced
step, the least time the card could take for the held experts' products
(the student's forward, data and weight gradients and the teacher's
forward, each pass the larger of its operations at the f32 peak and its
bytes at the memory peak; ``portbench.counts_moe.grouped_pass`` from the
pairs the program counted) over the matched kernels' device time. None
without a matched kernel or counted pairs. Kernels:
``kernels/grouped_matmul.py`` -> ``csrc/grouped_matmul.cu``."""

from portbench.counts_moe import grouped_pass
from portbench.trace import matching

PATTERNS = ("grouped_mm_kernel", "grouped_mm_wgrad_kernel")


def read(rec):
    sec, calls = matching(rec, PATTERNS)
    shapes = rec.get("unit_shapes") or []
    if not calls or not shapes or "held_pairs" not in shapes[0]:
        return None
    cfg, pk = rec["config"], rec["peaks"]

    def bound(pairs):
        ops, nbytes = grouped_pass(cfg, pairs)
        return max(ops / pk["f32_flops_per_s"], nbytes / pk["hbm_bytes_per_s"])

    total = sum(3 * bound(s["held_pairs"]) + bound(s["held_pairs_teacher"]) for s in shapes)
    return 100.0 * total / sec
