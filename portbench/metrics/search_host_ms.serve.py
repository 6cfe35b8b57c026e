"""Host milliseconds of a traced search's call into the port (the span
``qdt.serve.search`` around ``beam_search_packed``: its checks, the graph's
key, the input copies, the launch and the output clones), mean over the
window's searches."""

from portbench.program import span_ms


def read(rec):
    return span_ms(rec, "serve.search")
