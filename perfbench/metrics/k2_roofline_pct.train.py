"""K2's share of its roofline in the train step: the attention backward at
every shape of the step, at its batch, bf16 in the cell's attention mode,
with dropout (``perfbench.attn``)."""

import torch

from perfbench import attn


def read(state):
    ctx = state["ctx"]
    return attn.roofline_pct(
        ctx.cfg, state["batch"], torch.bfloat16, ctx.mix["attention_mode"],
        ctx.cfg["model"]["attention_probs_dropout_prob"], True,
        "bf16_flops", ctx.device)
