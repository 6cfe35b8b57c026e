"""The DeepSeek-V2 KD steps' model operations in the traced window as a
share of the cards' float32 peak over the window (%): the student's
forward and backward (twice the forward) and the teacher's forward, the
held experts at the pairs the program counted, nothing recomputed counted
(``portbench.counts_moe.kd_step``). None without counted pairs."""

from portbench.counts_moe import kd_step


def read(rec):
    shapes = rec.get("unit_shapes") or []
    if not rec["busy_s"] or not shapes or "held_pairs" not in shapes[0]:
        return None
    ops = sum(kd_step(rec["config"], s) for s in shapes)
    return 100.0 * ops / (rec["window_s"] * rec["peaks"]["f32_flops_per_s"] * rec["cards"])
