"""2D-TAN's map against the card's float32 yardstick, in percent: the
map's FLOPs over the dense grid cuDNN computes
(`benchmark/tan_counts.map_flops`, every (query, window) of the traced
window), over the device seconds under `bench.tan_map` less
`bench.tan_text`, over the TF32 dense peak (`benchmark/counts.py`,
495 TFLOP/s on the H100), which float32 on any unit of the card stays
under."""


def read(trace, work):
    seconds = trace.span_device_s("tan_map") - trace.span_device_s("tan_text")
    if seconds <= 0 or not work.get("tan_map_flops") or not work.get("peak_flops"):
        return None
    return 100.0 * work["tan_map_flops"] / seconds / work["peak_flops"]
