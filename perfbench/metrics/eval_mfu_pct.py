"""Analytic forward FLOPs of the window's candidate rows a second, as a
share of the card's TF32 dense peak, the fastest that any product of fp32
inputs runs on it."""

import torch

from perfbench import common, flops


def read(state):
    ctx = state["ctx"]
    pk = common.PEAKS.get(torch.cuda.get_device_name(ctx.device))
    if pk is None:
        return None
    rate = flops.forward_flops(ctx.cfg, 1) * state["rows"] / state["window_s"]
    return 100.0 * rate / pk["tf32_flops"]
