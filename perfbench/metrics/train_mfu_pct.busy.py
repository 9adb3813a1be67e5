"""Model FLOPs of a training step over the card's busy time a step (the
profiler's trace of the stretch after the window), as a share of the card's
bf16 dense peak: the whole step's share of the peak on the device's side,
beside the attention kernels' rooflines."""

import torch

from perfbench import common, flops


def read(state):
    ctx = state["ctx"]
    pk = common.PEAKS.get(torch.cuda.get_device_name(ctx.device))
    busy_s = state["trace"]["busy_s"] / state["trace_steps"]
    if pk is None or busy_s <= 0:
        return None
    rate = flops.train_step_flops(ctx.cfg, state["batch"]) / busy_s
    return 100.0 * rate / pk["bf16_flops"]
