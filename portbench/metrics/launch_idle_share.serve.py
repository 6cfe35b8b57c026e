"""Share of the traced serving window in which the device idled while the
host launched a search's graph (innermost port span ``qdt.graph.replay``
at the idle gap's middle), %."""

from portbench.program import idle_share


def read(rec):
    return idle_share(rec, "graph.replay")
