"""The searches' model operations in the traced window as a share of the
card's bf16 peak over the window (%): encoder, attention keys, and every
decode step's LSTM layers, attention, output projection and generator at
its padded width (``portbench.counts.search``)."""

from portbench.counts import search


def read(rec):
    if not rec["busy_s"]:
        return None
    cfg = rec["config"]
    ops = sum(search(cfg["student"], cfg["vocab"], s) for s in rec["unit_shapes"])
    return 100.0 * ops / (rec["window_s"] * rec["peaks"]["bf16_flops_per_s"] * rec["cards"])
