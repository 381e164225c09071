"""Spans from the benchmark's own files, and the reading of a traced run.

In a traced run (`--trace 1`) the traffic driver wraps the calls into each
layer of the program with `torch.profiler.record_function` spans named
`bench.<layer>`: instance attributes are shadowed by wrappers, the
program's files are not edited. One `torch.profiler` session (CPU and CUDA
activities) covers the traced window. The reading then takes the raw
profiler events once:

  * device operations: the CUDA kernels, copies and sets (the profiler's
    own GPU-side annotations are left out);
  * busy seconds: the union of their intervals;
  * a span's device seconds: each operation falls to the spans open on the
    host thread that launched it, at the time of its launch (the runtime
    call that shares its correlation id);
  * idle gaps: the intervals of the window with no device operation, by
    what the host was doing when each gap began: the open span, on any
    thread, that started last.

With `--trace 0` nothing is wrapped and no profiler runs.
"""

from __future__ import annotations

import bisect
import functools
import time
from collections import defaultdict

PREFIX = "bench."


class NoTracer:
    """The untraced run: spans cost nothing."""

    active = False

    def wrap(self, obj, attr: str, span: str) -> None:
        pass

    def span(self, name: str):
        import contextlib

        return contextlib.nullcontext()

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass


class Tracer(NoTracer):
    active = True

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t_start = self.t_end = None

    def wrap(self, obj, attr: str, span: str) -> None:
        """Shadow obj.attr with a wrapper that runs it inside span
        `bench.<span>`."""
        import torch

        fn = getattr(obj, attr)
        name = PREFIX + span

        @functools.wraps(fn)
        def wrapped(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)

        setattr(obj, attr, wrapped)

    def span(self, name: str):
        import torch

        return torch.profiler.record_function(PREFIX + name)

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.t_end = time.perf_counter()
        self.prof.stop()

    def view(self) -> "TraceView":
        return TraceView.from_events(self.prof.profiler.kineto_results.events(),
                                     self.t_end - self.t_start)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class TraceView:
    """What the readers of per-layer metrics see of one traced window.

    window_s: the traced window on the host clock. ops: [(name, start_ns,
    dur_ns, kind)] with kind "kernel" | "memcpy" | "memset". span_device_ns:
    {span name: device ns of the operations launched inside it};
    span_count, span_host_ns: {span name: occurrences, host ns inside};
    gaps: {span name: idle ns}."""

    def __init__(self, window_s, ops, span_device_ns, span_count, span_host_ns, gaps):
        self.window_s = float(window_s)
        self.ops = ops
        self.span_device_ns = span_device_ns
        self.span_count = span_count
        self.span_host_ns = span_host_ns
        self.gaps = gaps
        self.busy_s = sum(e - s for s, e in _merge((o[1], o[1] + o[2]) for o in ops)) / 1e9

    @classmethod
    def from_events(cls, events, window_s):
        ops, runtime, spans = [], {}, defaultdict(list)
        for e in events:
            name = e.name()
            if e.device_type().name == "CUDA":
                if e.is_user_annotation():
                    continue
                low = name.lower()
                kind = "memcpy" if low.startswith("memcpy") else \
                    "memset" if low.startswith("memset") else "kernel"
                ops.append((name, e.start_ns(), e.duration_ns(), kind, e.correlation_id()))
            elif name.startswith(PREFIX):
                spans[e.start_thread_id()].append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                                   name[len(PREFIX):]))
            elif name.startswith("cu"):
                runtime[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
        return cls.build(window_s, ops, runtime, spans)

    @classmethod
    def build(cls, window_s, ops, runtime, spans):
        """ops: [(name, start_ns, dur_ns, kind, correlation)]; runtime:
        {correlation: (thread, launch_ns)}; spans: {thread: [(start_ns,
        end_ns, name)]}, properly nested on each thread."""
        index = {}
        span_ns, span_count, span_host = defaultdict(int), defaultdict(int), defaultdict(int)
        for tid, lst in spans.items():
            lst.sort(key=lambda s: (s[0], -s[1]))
            parent, stack = [], []
            for i, (s, e, name) in enumerate(lst):
                while stack and lst[stack[-1]][1] < s:
                    stack.pop()
                parent.append(stack[-1] if stack else -1)
                stack.append(i)
                span_count[name] += 1
                span_host[name] += e - s
            index[tid] = ([s for s, _, _ in lst], lst, parent)

        def open_spans(tid, t):
            """(start, name) of the spans open on thread tid at time t,
            innermost last: the last span to start by t and those of its
            ancestors (spans nest) that have not ended."""
            if tid not in index:
                return []
            starts, lst, parent = index[tid]
            j = bisect.bisect_right(starts, t) - 1
            out = []
            while j >= 0:
                if lst[j][1] >= t:
                    out.append((lst[j][0], lst[j][2]))
                j = parent[j]
            return out[::-1]

        for name, start, dur, kind, corr in ops:
            rt = runtime.get(corr)
            if rt is None:
                continue
            for s in {n for _, n in open_spans(*rt)}:
                span_ns[s] += dur
        gaps = defaultdict(int)
        merged = _merge((o[1], o[1] + o[2]) for o in ops)
        for (s0, e0), (s1, _) in zip(merged, merged[1:]):
            inner = [o[-1] for o in (open_spans(tid, e0) for tid in index) if o]
            gaps[max(inner)[1] if inner else "outside spans"] += s1 - e0
        plain = [o[:4] for o in ops]
        return cls(window_s, plain, dict(span_ns), dict(span_count), dict(span_host), dict(gaps))

    def kernels(self):
        return [o for o in self.ops if o[3] == "kernel"]

    def kernel_time_s(self, contains: str):
        """(launches, device seconds) of the kernels whose name contains
        `contains`."""
        sel = [o for o in self.ops if o[3] == "kernel" and contains in o[0]]
        return len(sel), sum(o[2] for o in sel) / 1e9

    def span_device_s(self, name: str) -> float:
        return self.span_device_ns.get(name, 0) / 1e9

    def span_host_s(self, name: str) -> float:
        """Host seconds inside span `name`, summed over its occurrences."""
        return self.span_host_ns.get(name, 0) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        by_name = defaultdict(int)
        for name, _, dur, _ in self.ops:
            by_name[name[:160]] += dur
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v / 1e9] for n, v in ops],
                "idle_gaps": [[n, v / 1e9] for n, v in gaps]}
