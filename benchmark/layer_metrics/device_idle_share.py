"""Share of the time in which no operation ran on the device, in percent,
for `device_idle_share.eval` and `device_idle_share.train`: 100 * (1 -
busy / time), busy being the union of the CUDA kernels', copies' and sets'
intervals in the traced stretch's profile per unit of its work (a query,
a step), time the untraced stretch's host seconds per unit of its work,
which the profiler's own cost does not stretch."""


def read(trace, work):
    plain = work.get("untraced", {})
    if not trace.ops or not work.get("units") or not plain.get("units"):
        return None
    busy = trace.busy_s / work["units"]
    return 100.0 * (1.0 - busy / (plain["elapsed_s"] / plain["units"]))
