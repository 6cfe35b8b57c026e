"""Device milliseconds of rank 0's NCCL all-reduce kernels a train step
(the data-parallel step's gradient, loss and metrics reductions, which its
CUDA graph replays unoverlapped), over the traced window's steps. A
kernel's time includes its wait for the last rank to arrive."""

from portbench.trace import matching


def read(rec):
    sec, calls = matching(rec, ("AllReduce",))
    return 1e3 * sec / rec["units"] if calls else None
