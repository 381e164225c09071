"""The service's own time per /search in the traced window: its `/stats`
counters (`requests.search`, `mean_latency_s.search`, the timer around
`retriever.search_batch` under the device lock), read before and after the
window, in ms per request."""


def read(trace, work):
    return work.get("service_ms") if work.get("requests") else None
