"""Device milliseconds of 2D-TAN's map per query: the operations launched
inside the benchmark's `bench.tan_map` span around the TAN model's forward
(frame conv and pool, the sparse max-pool map, the fusion, the four map
convolutions, the prediction), less those inside the `bench.tan_text`
span the LSTM runs in within it, per query completed in the traced
window."""


def read(trace, work):
    s = trace.span_device_s("tan_map") - trace.span_device_s("tan_text")
    if s <= 0 or not work.get("queries"):
        return None
    return 1e3 * s / work["queries"]
