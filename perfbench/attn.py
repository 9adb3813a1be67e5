"""The attention core's share of its roofline, at the shapes a cell runs.

The measured time is the card's time for the program's attention entry
(``ops.attention.fused_attention``) called alone at every shape one
forward of the cell runs, with the cell's batch, dtype, attention mode and
dropout: its forward (K1), or its backward (K2) from a saved forward,
timed by CUDA events around calls queued behind a sleep kernel
(``common.queued_seconds``).
Whatever implements that entry is held to the same work
(``flops.attention_work``); the least time of a call is the larger of its
FLOPs over the peak and its bytes over the memory bandwidth.
"""

from __future__ import annotations

from typing import Optional

import torch

from perfbench import common, flops


def roofline_pct(cfg, B: int, dtype: torch.dtype, mode: str, rate: float,
                 backward: bool, peak_key: str, device) -> Optional[float]:
    pk = common.PEAKS.get(torch.cuda.get_device_name(device))
    if pk is None:
        return None
    from crct_tpu_torch.ops.attention import fused_attention
    itemsize = torch.tensor([], dtype=dtype).element_size()
    g = torch.Generator(device).manual_seed(0)
    measured = least = 0.0
    for shape, calls in flops.attention_calls(cfg, B):
        b, h, lq, lk, d = shape
        q, k, v = (torch.randn((b, h, n, d), generator=g, device=device)
                   .to(dtype) for n in (lq, lk, lk))
        mask = torch.zeros((b, 1, 1, lk), device=device)
        mask[:, :, :, lk - lk // 4:] = -10000.0
        if backward:
            for t in (q, k, v):
                t.requires_grad_(True)
            out = fused_attention(q, k, v, mask, rate, 1234, mode)
            grad = torch.randn(out.shape, generator=g, device=device) \
                .to(dtype)
            fn = lambda: torch.autograd.grad(      # noqa: E731
                out, (q, k, v), grad, retain_graph=True)
        elif rate > 0:
            for t in (q, k, v):
                t.requires_grad_(True)
            fn = lambda: fused_attention(          # noqa: E731
                q, k, v, mask, rate, 1234, mode)
        else:
            def fn():
                with torch.inference_mode():
                    fused_attention(q, k, v, mask, 0.0, 0, mode)
        seconds = common.queued_seconds(fn, device)
        if seconds is None:
            return None
        measured += calls * seconds
        f, nbytes = flops.attention_work(shape, itemsize, backward)
        least += calls * flops.least_seconds(f, nbytes, pk[peak_key],
                                             pk["hbm_bytes_per_s"])
    return 100.0 * least / measured if measured > 0 else None
