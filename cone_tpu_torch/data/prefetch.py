"""Background-thread staging: host work for item n+1 (query packing,
host-to-device copies) runs while the device executes item n."""

from __future__ import annotations

import queue
import threading

from cone_tpu_torch.utils.trace import span

_SENTINEL = object()


def prefetch_iterator(iterable, depth: int = 2):
    """Yield items of `iterable`, produced in a background thread.

    Abandoning the iterator (break / exception in the consumer) releases
    the worker: it checks a stop flag around a bounded put, so it never
    blocks forever holding buffered items alive. An exception in the
    worker is raised in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    err = []
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def worker():
        try:
            for item in iterable:
                put(item)
                if stop.is_set():
                    return
        except BaseException as e:  # handed to the consumer, re-raised there
            err.append(e)
        finally:
            put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            with span("prefetch.wait"):
                item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
