"""Host milliseconds a traced search spends launching its graph (the port's
spans ``qdt.graph.replay`` inside ``qdt.serve.search``), mean over the
window's searches."""

from portbench.program import span_ms


def read(rec):
    return span_ms(rec, "graph.replay", inside="serve.search")
