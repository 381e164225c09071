"""Device milliseconds of 2D-TAN's within-window NMS per query: the
operations launched inside the benchmark's `bench.tan_window_nms` span
around `eval/tan_pipeline.within_window_nms` (the pool of a window's 128
best cells, their pairwise IoU and the greedy scan), per query completed
in the traced window."""


def read(trace, work):
    s = trace.span_device_s("tan_window_nms")
    if not s or not work.get("queries"):
        return None
    return 1e3 * s / work["queries"]
