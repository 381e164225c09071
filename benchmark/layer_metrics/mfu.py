"""The share of the card's peak, in percent, for `mfu.eval` (the whole
fused dispatch) and `mfu.train` (the train step): the matmul FLOPs of the
work the untraced stretch completed (`benchmark/counts.py`: real queries,
valid frames and videos; each trained sample at its own tokens), over its
host seconds, over the dense peak of the configuration's compute dtype
(float32 at the TF32 rate)."""


def read(trace, work):
    plain = work.get("untraced", {})
    if not plain.get("flops") or not plain.get("elapsed_s"):
        return None
    return 100.0 * plain["flops"] / plain["elapsed_s"] / plain["peak_flops"]
