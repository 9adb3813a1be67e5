"""Device time of a call: what the card's kernels take, without the host's
time to launch them."""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch


def device_ms(fn: Callable[[], object], device, iters: int = 20,
              warmup: int = 3, tries: int = 3,
              name: Optional[str] = None) -> float:
    """Mean time of one call of ``fn`` over ``iters`` calls after
    ``warmup``, ms: on the card the summed time of its CUDA kernels (those
    whose name holds ``name``, if given) under torch.profiler, the host's
    time to launch them and the card's idle gaps left out (through Python
    wrappers the launching exceeds the smaller kernels' own time); a
    profile with no such kernel is taken again, up to ``tries``: the
    profiler has been seen to return an empty trace of calls that
    launched. On the CPU its wall time."""
    device = torch.device(device)
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize(device)
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and (name is None or name in e.key))
        if us > 0:
            break
    return us / 1e3 / iters
