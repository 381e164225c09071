"""The coarse kernel's share of its roofline, in percent: its least time
per launch (`benchmark/counts.coarse_bound_s`: valid-frame bytes, the real
queries' CLS rows and maxima, over 3.35 TB/s, or the product's operations
over the TF32 dense peak, whichever is longer), averaged over the traced
window's launches, over its mean device time per launch in the profile."""


def read(trace, work):
    n, seconds = trace.kernel_time_s("coarse_segment_max")
    if not n or not work.get("coarse_launches"):
        return None
    bound = work["coarse_bound_s"] / work["coarse_launches"]
    return 100.0 * bound / (seconds / n)
