"""What every cell shares: the card and the host, the peaks, the profiler's
trace reduced to busy time, top kernels and idle gaps, and device time of a
call."""

from __future__ import annotations

import bisect
import json
import os
import subprocess
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

# dense peaks of one card without sparsity (NVIDIA's H100 SXM data sheet),
# at its full 700 W power limit: what a roofline or an MFU divides by
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989.4e12, "tf32_flops": 495.0e12,
                              "hbm_bytes_per_s": 3.35e12, "power_w": 700.0},
}
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "crct_tpu")


def process_start() -> float:
    """The wall-clock time this process started, from /proc."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``crct_tpu_torch`` is not ``crct_tpu``)."""
    import sys
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def machine(device_index: int = 0) -> Dict[str, Any]:
    """The card (name, power limit, SM clock, temperature) and the host
    (CPU model, cores)."""
    out: Dict[str, Any] = {"cores": os.cpu_count()}
    out["cpu"] = "unknown"
    try:
        lines = subprocess.run(["lscpu"], capture_output=True, text=True,
                               timeout=30).stdout.splitlines()
        out["cpu"] = next(line.split(":", 1)[1].strip() for line in lines
                          if line.startswith("Model name"))
    except (OSError, StopIteration, subprocess.SubprocessError):
        pass
    try:
        line = subprocess.run(
            ["nvidia-smi", f"--id={device_index}",
             "--query-gpu=name,power.limit,clocks.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
        name, limit, clock, temp = (s.strip() for s in line.split(","))
        out.update(card=name, power_limit=limit, sm_clock=clock,
                   temperature_c=temp)
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        out["card"] = "unknown"
    return out


# --------------------------------------------------------------------------
# the profiler's trace
# --------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def reduce_trace(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """From a chrome trace's events: the traced window (from the first
    CUDA call or device operation to the end of the last, which is the
    closing synchronize), the seconds in it when the device ran an
    operation, device time by kernel name, and the idle gaps labelled by
    the CUDA call the host was in when each began ("host" outside one)."""
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
              e.get("cat"), e.get("name", "?")) for e in events
             if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS + HOST_CATS]
    if not spans:
        raise RuntimeError("the trace holds no CUDA call and no operation")
    w0 = min(s for s, _, _, _ in spans)
    w1 = max(e for _, e, _, _ in spans)
    dev = [(s, e) for s, e, c, _ in spans if c in DEVICE_CATS and e > s]
    by_name: Dict[str, float] = {}
    for s, e, c, name in spans:
        if c in DEVICE_CATS:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
    busy = _union(dev)
    host = sorted((s, e, name) for s, e, c, name in spans if c in HOST_CATS)
    starts = [h[0] for h in host]
    gaps, prev = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    labels: Dict[str, float] = {}
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0)
        label, best = "host", None
        for j in range(i - 1, max(-1, i - 64), -1):
            s, e, name = host[j]
            if s <= g0 < e and (best is None or e - s < best):
                label, best = name, e - s
        labels[label] = labels.get(label, 0.0) + (g1 - g0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(labels.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(e - s for s, e in busy) / 1e6,
            "device_ops": [[n[:120], v / 1e6] for n, v in top],
            "idle_gaps": [[n[:120], v / 1e6] for n, v in idle],
            "kernel_s": {n: v / 1e6 for n, v in by_name.items()}}


def traced(fn: Callable[[], None], device, scratch: str) -> Dict[str, Any]:
    """Run ``fn`` under torch.profiler, closed by a synchronize, and reduce
    the trace. The profiler records the device's operations and the CUDA
    calls only: recording every host operation as well slows the host of
    a step bound by its dispatch twice over."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    os.makedirs(scratch, exist_ok=True)
    path = os.path.join(scratch, f"trace-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return reduce_trace(events)


def queued_seconds(fn: Callable[[], Any], device, calls: int = 5,
                   warmup: int = 2, repeats: int = 3,
                   tries: int = 4) -> Optional[float]:
    """Mean seconds of one call of ``fn`` on the card: CUDA events around
    ``calls`` calls queued behind a sleep kernel, which holds the card
    while the host launches them, so that the host's launching leaves no
    gap between them; the median of ``repeats`` such readings. The sleep
    grows fourfold, up to ``tries`` times, where the host took more than
    half of it to launch the calls; None where it never got ahead (a call
    that waits for the card). Unlike the profiler's records, which fell
    short by 40-80 % for the port's own kernels in some processes, events
    read each attention shape within a few per cent from run to run on
    the H100."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    cycles = 40_000_000           # ~20 ms at the H100's 1.98 GHz
    readings: List[float] = []
    grown = 0
    while len(readings) < repeats and grown < tries:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        torch.cuda._sleep(cycles)
        marks[1].record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host = time.perf_counter() - t0
        marks[2].record()
        torch.cuda.synchronize(device)
        if host < 0.5e-3 * marks[0].elapsed_time(marks[1]):
            readings.append(1e-3 * marks[1].elapsed_time(marks[2]) / calls)
        else:
            cycles *= 4
            grown += 1
    if len(readings) < repeats:
        return None
    return sorted(readings)[repeats // 2]


def device_seconds(fn: Callable[[], Any], device, calls: int = 5,
                   warmup: int = 2, tries: int = 3) -> float:
    """Mean seconds of one call of ``fn`` that the card's operations take
    (kernels, copies and fills), the host's launching and the gaps left
    out: torch.profiler's device time over ``calls`` calls. A profile with
    no device time is taken again, up to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    us = 0.0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize(device)
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            break
    return us / 1e6 / calls
