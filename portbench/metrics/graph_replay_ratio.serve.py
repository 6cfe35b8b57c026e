"""Search graphs replayed over graphs replayed and captured in the traced
window (the port's counters ``graph.replays`` and ``graph.captures``), %."""

from portbench.program import replay_ratio


def read(rec):
    return replay_ratio(rec)
