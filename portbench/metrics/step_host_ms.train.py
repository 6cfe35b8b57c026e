"""Host milliseconds of a train step's call (the benchmark's span around
``TrainStep.__call__``: ``prepare``, then the graph's replay), mean over
the traced window's steps."""


def read(rec):
    spans = rec["spans"].get("step")
    return 1e3 * sum(spans) / len(spans) if spans else None
