"""Device milliseconds of NCCL a data-parallel train step on rank 0: every
kernel whose name holds `nccl` in the traced window's profile (the
gradient all-reduce of `GroupReduce.sum_grads`, the loss terms' and the
criterion's small all-reduces), over the steps of the window. An NCCL
kernel runs from its launch until every rank has joined, so waiting for
the slowest rank counts too."""


def read(trace, work):
    n, seconds = trace.kernel_time_s("nccl")
    if not n or not work.get("steps"):
        return None
    return 1e3 * seconds / work["steps"]
