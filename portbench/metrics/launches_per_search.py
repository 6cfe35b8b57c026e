"""Kernels launched a search in the traced window (copies and sets not
counted): the search graph's replayed kernels over the searches."""

from portbench.trace import kernels


def read(rec):
    n = sum(c for _, c in kernels(rec).values())
    return n / rec["units"] if n else None
