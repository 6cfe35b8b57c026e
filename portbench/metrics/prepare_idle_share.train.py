"""Share of the traced training window in which the device idled while the
host was in ``TrainStep.prepare`` (innermost port span
``qdt.train.prepare`` at the idle gap's middle), %."""

from portbench.program import idle_share


def read(rec):
    return idle_share(rec, "train.prepare")
