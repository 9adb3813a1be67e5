"""Model FLOPs of the window's training steps a second, as a share of the
card's bf16 dense peak: the analytic count of ``perfbench.flops`` (useful
matmuls, forward and twice it for the backward) at the cell's widths,
shapes and batch."""

import torch

from perfbench import common, flops


def read(state):
    ctx = state["ctx"]
    pk = common.PEAKS.get(torch.cuda.get_device_name(ctx.device))
    if pk is None or not state["steps"]:
        return None
    rate = flops.train_step_flops(ctx.cfg, state["batch"]) * state["steps"] \
        / state["window_s"]
    return 100.0 * rate / pk["bf16_flops"]
