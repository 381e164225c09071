"""CUDA kernel launches in the traced window's profile per query completed
in it: the pipeline's staging, dispatch and fetch as the device sees them.
A count that repeats exactly from run to run."""


def read(trace, work):
    if not work.get("queries"):
        return None
    n = len(trace.kernels())
    return n / work["queries"] if n else None
