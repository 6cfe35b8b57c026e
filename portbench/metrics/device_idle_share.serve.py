"""Share of the traced serving window in which no operation ran on the
device (%): 100 * (1 - busy / window), from the profiler's trace."""


def read(rec):
    if not rec["busy_s"]:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
