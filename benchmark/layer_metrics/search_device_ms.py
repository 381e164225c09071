"""Device milliseconds per answered /search: every CUDA kernel, copy and
set in the traced window's profile (the library scan of
`serve/corpus._coarse_all`, the fine stage, the fetches) over the requests
answered in it."""


def read(trace, work):
    if not work.get("requests") or not trace.ops:
        return None
    return 1e3 * sum(o[2] for o in trace.ops) / 1e9 / work["requests"]
