"""The by-span table of a traced run: where the host's time goes inside the
program's train step or ``evaluate()``, and which of the program's spans
the card's busy and idle time belong to, from the program's own tracer
(``crct_tpu_torch/utils/tracing.py``).

The readers of the span metrics call ``table(state)``; the first call of a
run measures and keeps the table in ``state``, after the traced stretch
and the readers listed before them, with the same ``state``. It runs two
more stretches as long as the traced one (``trace_steps`` steps or
``trace_batches`` loader batches):

(a) the tracer on, the profiler off: the host's ms a step (a batch) in
    each span, with and without the spans inside it, and the counters;
    a stretch with the tracer off before and after it gives the tracer's
    cost, in the same conditions;
(b) the tracer on under the profiler, CUDA activity only, as
    ``common.traced`` runs it. Each device operation goes to the innermost
    span open on the step's thread when its launch call began (matched by
    the trace's correlation id, whichever host thread made the call, so
    that the backward's launches from autograd's thread go to
    ``train.backward``); each idle gap goes to the span open when it
    began; each operation counts as a launch of its span.

Before (b), five spans around a sleep kernel's launch measure how far the
spans' clock may lie from the trace's (``clock``). The table goes to
standard error as one ``spans`` line. A program without the tracer gives
no table, and its readers report nothing.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from perfbench import common

OUTSIDE = "(outside)"           # no span of the step's thread open


def table(state: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The run's by-span table, measured at the first call."""
    if "spans" not in state:
        state["spans"] = _measure(state)
    return state["spans"]


def by_span(state, name: str, key: str) -> Optional[float]:
    """One number of one span's row, or None."""
    t = table(state)
    row = t["by_span"].get(name) if t else None
    return None if row is None else row.get(key)


def _measure(state) -> Optional[Dict[str, Any]]:
    try:
        from crct_tpu_torch.utils import tracing
    except ImportError:
        return None
    ctx = state["ctx"]
    dev = ctx.device
    if "program" in state:
        prog = state["program"]
        from perfbench import run as harness
        feed = harness.load_module("traffic", "train").Feed(
            ctx.cfg, ctx.mix, ctx.seed, dev)
        units, unit = state["trace_steps"], "step"
        window_ms = 1e3 * state["window_s"] / state["steps"]

        def stretch():
            for i in range(units):
                prog.step(feed(i), prog.generator)
    else:
        setup = state["setup"]
        nb = len(setup.questions.batches)
        units, unit = state["trace_batches"], "batch"
        window_ms = 1e3 * state["window_s"] / state["batches"]
        first = state["batches"] + units

        def stretch():
            setup.evaluate([(first + i) % nb for i in range(units)])

    def timed(on: bool) -> float:
        _sync(dev)
        if on:
            tracing.enable()
        t0 = time.perf_counter()
        stretch()
        _sync(dev)
        tracing.disable()
        return 1e3 * (time.perf_counter() - t0) / units

    thread = threading.get_native_id()
    tracing.drain()
    off = [timed(False)]
    ms_a = timed(True)
    rec_a = tracing.drain()
    off.append(timed(False))
    clock = _clock(tracing, dev, ctx.scratch)
    tracing.enable()
    events, base_ns = _profiled(stretch, dev, ctx.scratch)
    tracing.disable()
    rec_b = tracing.drain()

    host = host_times(rec_a["spans"], thread)
    dev_t = attribute(rec_b["spans"], events, base_ns, thread)
    rows: Dict[str, Dict[str, float]] = {}
    for name, h in host.items():
        rows.setdefault(name, {}).update(
            calls=h["calls"] / units, host_ms=h["us"] / 1e3 / units,
            self_host_ms=h["self_us"] / 1e3 / units)
    for name, d in dev_t["by_span"].items():
        rows.setdefault(name, {}).update(
            device_ms=d["device_us"] / 1e3 / units,
            self_device_ms=d["self_device_us"] / 1e3 / units,
            idle_ms=d["idle_us"] / 1e3 / units,
            self_idle_ms=d["self_idle_us"] / 1e3 / units,
            launches=d["launches"] / units)
    out = {"unit": unit, "units": units, "by_span": rows,
           "counters": rec_a["counters"],
           "dropped": rec_a["dropped"] + rec_b["dropped"],
           "stretch_a_ms": ms_a, "tracer_off_ms": off,
           "on_cost_pct": 100.0 * (2.0 * ms_a / sum(off) - 1.0),
           "window_ms": window_ms,
           "busy_ms": dev_t["busy_us"] / 1e3 / units,
           "window_b_ms": dev_t["window_us"] / 1e3 / units,
           "unmatched_ops": dev_t["unmatched"], "clock": clock}
    print("spans " + json.dumps(out), file=sys.stderr, flush=True)
    return out


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _profiled(fn, dev, scratch):
    """``fn`` under torch.profiler (CUDA activity only) closed by a
    synchronize: the trace's events and its ``baseTimeNanoseconds``."""
    from torch.profiler import ProfilerActivity, profile
    _sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(dev)
    os.makedirs(scratch, exist_ok=True)
    path = os.path.join(scratch, f"spans-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    os.remove(path)
    return trace["traceEvents"], int(trace.get("baseTimeNanoseconds", 0))


def _clock(tracing, dev, scratch, probes: int = 5) -> Dict[str, Any]:
    """Spans around ``probes`` launches of a sleep kernel, under the
    profiler: whether each holds its launch call's record, and how far
    at most the two clocks may lie apart by the tightest (the larger of
    the room before and after the call, in us)."""
    tracing.enable()
    events, base_ns = _profiled(
        lambda: [_sleep_in_span(tracing) for _ in range(probes)], dev,
        scratch)
    tracing.disable()
    spans = [s for s in tracing.drain()["spans"] if s["name"] == "bench.clock"]
    launches = sorted((e for e in events if e.get("ph") == "X"
                       and e.get("cat") in common.HOST_CATS
                       and "LaunchKernel" in e.get("name", "")),
                      key=lambda e: e["ts"])
    if len(launches) != len(spans) or not spans:
        return {"probes": len(spans), "launches": len(launches)}
    slack, held = [], True
    for s, e in zip(spans, launches):
        before = e["ts"] - (s["start_ns"] - base_ns) / 1e3
        after = (s["end_ns"] - base_ns) / 1e3 - (e["ts"] + e["dur"])
        held &= before >= 0 and after >= 0
        slack.append(max(before, after))
    return {"probes": len(spans), "held": held, "slack_us": min(slack),
            "slack_us_each": slack}


def _sleep_in_span(tracing) -> None:
    with tracing.span("bench.clock"):
        torch.cuda._sleep(1000)


def host_times(spans: List[Dict[str, Any]], thread: int
               ) -> Dict[str, Dict[str, float]]:
    """By span name on ``thread``: calls, microseconds, and microseconds
    less those of the spans directly inside."""
    own = [s for s in spans if s["thread"] == thread]
    inner: Dict[int, float] = {}
    for s in own:
        if s["parent"] is not None:
            inner[s["parent"]] = inner.get(s["parent"], 0.0) + (
                s["end_ns"] - s["start_ns"]) / 1e3
    out: Dict[str, Dict[str, float]] = {}
    for s in own:
        us = (s["end_ns"] - s["start_ns"]) / 1e3
        row = out.setdefault(s["name"], {"calls": 0, "us": 0.0,
                                         "self_us": 0.0})
        row["calls"] += 1
        row["us"] += us
        row["self_us"] += us - inner.get(s["id"], 0.0)
    return out


def _owners(spans, base_ns):
    """The innermost open span over time: change points (us on the
    trace's clock) and the span from each on, None where none is open.
    The spans of one thread nest."""
    times, owners, stack = [], [], []
    for s in sorted(spans, key=lambda s: (s["start_ns"], -s["end_ns"])):
        while stack and stack[-1]["end_ns"] <= s["start_ns"]:
            done = stack.pop()
            times.append((done["end_ns"] - base_ns) / 1e3)
            owners.append(stack[-1] if stack else None)
        stack.append(s)
        times.append((s["start_ns"] - base_ns) / 1e3)
        owners.append(s)
    while stack:
        done = stack.pop()
        times.append((done["end_ns"] - base_ns) / 1e3)
        owners.append(stack[-1] if stack else None)
    return times, owners


def attribute(spans: List[Dict[str, Any]], events: List[Dict[str, Any]],
              base_ns: int, thread: int) -> Dict[str, Any]:
    """The card's busy time, idle gaps and operations of a chrome trace,
    by the spans of ``thread`` (see the module's docstring). ``device_us``
    and ``idle_us`` of a span hold the spans inside it; ``self_*`` do not,
    and over all rows with ``(outside)`` they sum to the trace's busy and
    idle time. An operation that overlaps one before it counts only the
    time it adds to the busy time."""
    own = [s for s in spans if s["thread"] == thread]
    by_id = {s["id"]: s for s in own}
    times, owners = _owners(own, base_ns)

    def chain(t):
        i = bisect.bisect_right(times, t) - 1
        s = owners[i] if i >= 0 else None
        names = []
        while s is not None:
            if s["name"] not in names:
                names.append(s["name"])
            s = by_id.get(s["parent"])
        return names or [OUTSIDE]

    rows: Dict[str, Dict[str, float]] = {}

    def add(names, key, value):
        for j, name in enumerate(names):
            row = rows.setdefault(name, dict.fromkeys(
                ("device_us", "self_device_us", "idle_us", "self_idle_us",
                 "launches"), 0.0))
            row[key] += value
            if j == 0 and key in ("device_us", "idle_us"):
                row["self_" + key] += value

    xs = [e for e in events if e.get("ph") == "X"]
    launch_at = {e["args"]["correlation"]: float(e["ts"]) for e in xs
                 if e.get("cat") in common.HOST_CATS
                 and "correlation" in e.get("args", {})}
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                  e.get("args", {}).get("correlation")) for e in xs
                 if e.get("cat") in common.DEVICE_CATS)
    unmatched, covered, busy = 0, float("-inf"), 0.0
    for s, e, corr in ops:
        part = max(0.0, e - max(s, covered))
        covered = max(covered, e)
        busy += part
        if corr not in launch_at:
            unmatched += 1
        names = chain(launch_at.get(corr, s))
        add(names, "device_us", part)
        add(names, "launches", 1)
    ends = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
            for e in xs if e.get("cat") in common.DEVICE_CATS
            + common.HOST_CATS]
    w0 = min((s for s, _ in ends), default=0.0)
    w1 = max((e for _, e in ends), default=0.0)
    prev = w0
    for s, e, _ in ops + [(w1, w1, None)]:
        if s > prev:
            add(chain(prev), "idle_us", s - prev)
        prev = max(prev, e)
    return {"by_span": rows, "busy_us": busy, "window_us": w1 - w0,
            "unmatched": unmatched}
