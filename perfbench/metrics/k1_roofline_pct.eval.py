"""K1's share of its roofline in evaluation: the attention forward at every
shape of the model, at the eval chunk's rows, fp32, no dropout, against
the TF32 dense peak (``perfbench.attn``)."""

import torch

from perfbench import attn


def read(state):
    ctx = state["ctx"]
    return attn.roofline_pct(ctx.cfg, state["chunk"], torch.float32,
                             ctx.mix["attention_mode"], 0.0, False,
                             "tf32_flops", ctx.device)
