"""Host milliseconds a train step waited for its batch: the benchmark's
`bench.loader_wait` span around taking the next staged batch from the
loader's feed (`data/dataset.TrainLoader` sampling, `data/prefetch.py`'s
thread), per step of the traced window."""


def read(trace, work):
    if not work.get("steps") or not trace.span_count.get("loader_wait"):
        return None
    return 1e3 * trace.span_host_s("loader_wait") / work["steps"]
