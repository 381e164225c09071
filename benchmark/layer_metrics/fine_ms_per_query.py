"""Device milliseconds of the fine stage per query: the operations launched
inside the benchmark's `bench.fine` span around the pipeline's `_fine`
(window gather, the model's forward, the matching pool), per query
completed in the traced window."""


def read(trace, work):
    s = trace.span_device_s("fine")
    if not s or not work.get("queries"):
        return None
    return 1e3 * s / work["queries"]
