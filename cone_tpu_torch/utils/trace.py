"""Spans of the program's phases, read by torch.profiler.

`span(name)` marks one phase (a fused dispatch, the staging of a group, a
train step, a request's wait for the device) as
`torch.profiler.record_function("cone." + name)` on whatever thread runs
it, as a context manager or as a decorator. Kineto keeps those spans and
the device's operations on one clock, so each kernel's launch falls inside
the spans open on its thread. Spans of threads other than the one that
starts the profiler are recorded when it runs with
`experimental_config=_ExperimentalConfig(profile_all_threads=True)`.

Off by default: `span` then checks one flag and returns the shared no-op
span of that name, allocating nothing and calling no profiler code. Who
starts a profiler calls `enable(True)`, and `enable(False)` before
stopping it.
"""

from __future__ import annotations

import functools

import torch

PREFIX = "cone."
_on = False


def enable(on: bool) -> None:
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def _decorate(self, fn):
    """`@span(name)`: each call runs inside span `name` if tracing is on
    at that call."""
    name = self.name[len(PREFIX):]

    @functools.wraps(fn)
    def traced(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return traced


class _Idle:
    """The span while tracing is off: one per name, entered by any thread."""

    __slots__ = ("name",)
    __call__ = _decorate

    def __init__(self, name: str):
        self.name = PREFIX + name

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


class _Live(torch.profiler.record_function):
    __call__ = _decorate


class _IdleSpans(dict):
    def __missing__(self, name):
        self[name] = idle = _Idle(name)
        return idle


_IDLE = _IdleSpans()


def span(name: str):
    """The span `cone.<name>`: a no-op while tracing is off."""
    if not _on:
        return _IDLE[name]
    return _Live(PREFIX + name)
