"""Kernels launched a train step in the traced window (copies and sets not
counted): the step graph's replayed kernels over the steps."""

from portbench.trace import kernels


def read(rec):
    n = sum(c for _, c in kernels(rec).values())
    return n / rec["units"] if n else None
