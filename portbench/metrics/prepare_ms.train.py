"""Host milliseconds a traced train step spends in ``TrainStep.prepare``
(the port's span ``qdt.train.prepare``), mean over the window's steps."""

from portbench.program import span_ms


def read(rec):
    return span_ms(rec, "train.prepare")
