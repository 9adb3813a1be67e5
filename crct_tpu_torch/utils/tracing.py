"""The port's tracer: spans and counters at the layer boundaries of the
train step, the model's forward and ``evaluate()``.

    from crct_tpu_torch.utils import tracing
    with tracing.span("train.forward"):
        ...
    tracing.count("eval.rows_valid", n)

Off by default: ``span()`` then returns one shared no-op context and
``count()`` returns at once, with no clock read and nothing recorded.
``enable()`` turns recording on; ``drain()`` hands back what was recorded
and empties the buffer. A span records its name, its start and end, the
id of the span open around it on the same thread, that thread's native id
(the one torch.profiler writes as ``tid``), a trace id and its
attributes. The trace id is given by the outermost span (the step's index
in training, the loader batch's in evaluation) and inherited by the spans
inside it. Spans are kept in memory up to a fixed number; the rest are
counted as dropped, and the buffer does not grow.

Stamps come from ``time.time_ns()``, the Unix clock, which is torch
profiler's clock too: in its chrome trace ``ts`` plus
``baseTimeNanoseconds`` / 1000 is Unix time in microseconds, so
``chrome_events`` puts the spans on the profiler's timeline. On or off,
the tracer makes no CUDA call: no synchronize, no event, no launch.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Any, Dict, List

CAPACITY = 1 << 16          # spans kept until the next drain()

_on = False
_spans: List[tuple] = []
_counts: Dict[str, int] = {}
_dropped = 0
_ids = itertools.count(1)
_lock = threading.Lock()
_local = threading.local()


class _Off:
    """The shared context ``span()`` returns while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "trace", "id", "parent", "start")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.trace = attrs.pop("trace", None)
        self.attrs = attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
            _local.thread = threading.get_native_id()
        outer = stack[-1] if stack else None
        self.parent = outer.id if outer is not None else None
        if self.trace is None and outer is not None:
            self.trace = outer.trace
        self.id = next(_ids)
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.stack.pop()
        global _dropped
        with _lock:
            if len(_spans) < CAPACITY:
                _spans.append((self.name, self.start, end, self.id,
                               self.parent, _local.thread,
                               self.trace, self.attrs))
            else:
                _dropped += 1
        return False


def span(name: str, **attrs):
    """A context that records a span while the tracer is on. ``trace=``
    sets the trace id (else the enclosing span's); other keywords are
    kept as the span's attributes."""
    if not _on:
        return _OFF
    return _Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the tracer is on."""
    if not _on:
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + int(n)


def enable() -> None:
    """Record spans and counters from now on, keeping at most
    ``CAPACITY`` spans until the next ``drain()``."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until ``drain()``."""
    global _on
    _on = False


def drain() -> Dict[str, Any]:
    """What was recorded since the last drain, and an empty buffer:
    ``spans`` (dicts in order of start), ``counters`` and ``dropped``,
    the spans the full buffer turned away."""
    global _spans, _counts, _dropped
    with _lock:
        spans, counts, dropped = _spans, _counts, _dropped
        _spans, _counts, _dropped = [], {}, 0
    keys = ("name", "start_ns", "end_ns", "id", "parent", "thread", "trace",
            "attrs")
    out = sorted((dict(zip(keys, s)) for s in spans),
                 key=lambda s: (s["start_ns"], s["id"]))
    return {"spans": out, "counters": counts, "dropped": dropped}


def chrome_events(spans: List[Dict[str, Any]],
                  base_ns: int) -> List[Dict[str, Any]]:
    """The spans as chrome-trace complete events on the clock of a
    torch.profiler trace whose ``baseTimeNanoseconds`` is ``base_ns``
    (microseconds since it), in this process's and each span's thread's
    lane."""
    pid = os.getpid()
    return [{"ph": "X", "cat": "program_span", "name": s["name"],
             "pid": pid, "tid": s["thread"],
             "ts": (s["start_ns"] - base_ns) / 1e3,
             "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
             "args": dict(s["attrs"], trace=s["trace"], span=s["id"],
                          parent=s["parent"])}
            for s in spans]
