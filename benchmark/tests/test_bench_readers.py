"""Each per-layer metric's reader on a small recorded profile: device
operations, runtime launches and spans laid out by hand, the numbers
worked out by hand."""

from __future__ import annotations

import pytest

from benchmark import manifest
from benchmark.trace import TraceView

MS = 1_000_000  # ns


def view():
    """A 10 ms window. Thread 1: a `dispatch` span (0-6 ms) holding a
    `fine` span (1-4 ms); thread 2: `loader_wait` (0-1, 1-2 ms).
    Kernels: coarse 1 ms launched in dispatch, two fine kernels of 2 ms and
    1 ms launched in fine, a 0.5 ms copy launched outside every span."""
    spans = {1: [(0, 6 * MS, "dispatch"), (1 * MS, 4 * MS, "fine")],
             2: [(0, 1 * MS, "loader_wait"), (1 * MS, 2 * MS, "loader_wait")]}
    runtime = {1: (1, int(0.5 * MS)), 2: (1, int(1.5 * MS)), 3: (1, int(2 * MS)),
               4: (1, int(7 * MS))}
    ops = [("coarse_segment_max_kernel<4>", 1 * MS, 1 * MS, "kernel", 1),
           ("gemm_a", 2 * MS, 2 * MS, "kernel", 2),
           ("gemm_b", 4 * MS, 1 * MS, "kernel", 3),
           ("Memcpy HtoD", 8 * MS, MS // 2, "memcpy", 4)]
    return TraceView.build(0.010, ops, runtime, spans)


def test_view_sums():
    v = view()
    assert v.busy_s == pytest.approx(0.0045)
    assert v.span_device_s("fine") == pytest.approx(0.003)
    assert v.span_device_s("dispatch") == pytest.approx(0.004)
    assert v.span_host_s("loader_wait") == pytest.approx(0.002)
    assert v.kernel_time_s("coarse_segment_max") == (1, pytest.approx(0.001))
    assert v.gaps == {"dispatch": 3 * MS}
    b = v.breakdown()
    assert b["device_ops"][0] == ["gemm_a", pytest.approx(0.002)]
    assert b["idle_gaps"] == [["dispatch", pytest.approx(0.003)]]


WORK = {"queries": 4, "units": 4, "coarse_bound_s": 2e-4, "coarse_launches": 1, "steps": 2,
        "requests": 5, "service_ms": 12.5,
        # the untraced stretch: 8 units in 16 ms (2 ms a unit, against the
        # traced 4.5 ms of device time over 4 units)
        "untraced": {"units": 8, "elapsed_s": 0.016, "flops": 4.95e9, "peak_flops": 495e12}}


@pytest.mark.parametrize("metric, want", [
    ("device_idle_share.eval", 43.75),           # 1 - (4.5 ms / 4) / (16 ms / 8)
    ("device_idle_share.train", 43.75),
    ("mfu.eval", 100 * 4.95e9 / 0.016 / 495e12),
    ("mfu.train", 100 * 4.95e9 / 0.016 / 495e12),
    ("launches_per_query", 3 / 4),               # three kernels, the copy is none
    ("fine_ms_per_query", 3.0 / 4),
    ("coarse_roofline", 20.0),                   # 0.2 ms bound over 1 ms
    ("loader_wait_ms", 1.0),                     # 2 ms over 2 steps
    ("search_device_ms", 4.5 / 5),
    ("search_service_ms", 12.5),
])
def test_reader_reads(metric, want):
    assert manifest.reader(metric)(view(), WORK) == pytest.approx(want)


@pytest.mark.parametrize("metric", [m["name"] for m in manifest.load()["per_layer"]])
def test_reader_with_nothing_to_read_returns_nothing(metric):
    empty = TraceView.build(1.0, [], {}, {})
    assert manifest.reader(metric)(empty, {}) is None


def test_a_split_metric_is_read_by_the_file_of_its_base():
    """`mfu.eval` and `mfu.train` have no files of their own: `mfu.py`
    reads both; a metric with a file of its own is read by that file."""
    base = manifest.BENCH_DIR / "layer_metrics"
    assert not (base / "mfu.eval.py").exists() and (base / "mfu.py").exists()
    assert manifest.reader("mfu.eval").__module__ == "benchmark.layer_metrics.mfu"
    assert manifest.reader("launches_per_query").__module__ == \
        "benchmark.layer_metrics.launches_per_query"
