"""Host milliseconds a traced train step spends launching its graph (the
port's spans ``qdt.graph.replay`` inside ``qdt.train.step``), mean over
the window's steps."""

from portbench.program import span_ms


def read(rec):
    return span_ms(rec, "graph.replay", inside="train.step")
