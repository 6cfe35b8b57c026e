"""The KD steps' model operations in the traced window as a share of the
cards' float32 peak over the window (%): the student's forward and
backward (twice the forward) and the teacher's forward, at the padded
shapes, nothing recomputed counted (``portbench.counts.kd_step``)."""

from portbench.counts import kd_step


def read(rec):
    if not rec["busy_s"]:
        return None
    ops = sum(kd_step(rec["config"], s) for s in rec["unit_shapes"])
    return 100.0 * ops / (rec["window_s"] * rec["peaks"]["f32_flops_per_s"] * rec["cards"])
