"""Hybrid regression heads (reference CRCT/backbone/regressor.py).

The port of ``crct_tpu/models/regressor.py``. The heads read the pre-pooler
CLS states of both streams (hw_0 = text[:, 0], hv_0 = vision[:, 0]) and give
either a Tanh-bounded scalar (PlotQA) or a 65-way softmax over the legal
DVQA float table (CE variant). The pipes are ``nn.Sequential``s with the
Linear layers at indices 0, 2, 4, 6, the reference's state-dict layout.
They always run in fp32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _pipe(dims: Sequence[int], in_size: int) -> nn.Sequential:
    """Linear/LeakyReLU MLP in_size -> dims[0] -> ... -> dims[-1], last layer
    linear."""
    layers = []
    for i, d in enumerate(dims):
        layers.append(nn.Linear(in_size, d))
        if i < len(dims) - 1:
            layers.append(nn.LeakyReLU())
        in_size = d
    return nn.Sequential(*layers)


def _fusion(out_size: int) -> nn.Sequential:
    """concat(hv, hw) [512] -> 512 -> 256 -> 256 -> LeakyReLU -> out_size."""
    return nn.Sequential(*_pipe((512, 256, 256), 512), nn.LeakyReLU(),
                         nn.Linear(256, out_size))


class HybridRegressor(nn.Module):
    """PlotQA_Regressor_v20 (reference regressor.py:5-42): txt/vis pipes to
    256-d, concat, fusion MLP to a Tanh scalar."""

    def __init__(self, hidden_size: int, v_hidden_size: int):
        super().__init__()
        self.txt_pipe = _pipe((hidden_size, 512, 256, 256), hidden_size)
        self.vis_pipe = _pipe((v_hidden_size, 512, 256, 256), v_hidden_size)
        self.fusion = _fusion(1)

    def forward(self, hv_0: torch.Tensor, hw_0: torch.Tensor) -> torch.Tensor:
        pre = torch.cat([self.vis_pipe(hv_0), self.txt_pipe(hw_0)], dim=-1)
        return torch.tanh(self.fusion(pre))[..., 0]


class CERegressor(nn.Module):
    """DVQA_Regressor_v20_CE (reference regressor.py:45-82): same pipes,
    65-way softmax head over the legal DVQA float bins."""

    def __init__(self, hidden_size: int, v_hidden_size: int,
                 num_bins: int = 65):
        super().__init__()
        self.txt_pipe = _pipe((hidden_size, 512, 256, 256), hidden_size)
        self.vis_pipe = _pipe((v_hidden_size, 512, 256, 256), v_hidden_size)
        self.ce_fusion = _fusion(num_bins)

    def forward(self, hv_0: torch.Tensor, hw_0: torch.Tensor) -> torch.Tensor:
        pre = torch.cat([self.vis_pipe(hv_0), self.txt_pipe(hw_0)], dim=-1)
        # the reference applies Softmax inside the head (regressor.py:73)
        return F.softmax(self.ce_fusion(pre), dim=-1)
