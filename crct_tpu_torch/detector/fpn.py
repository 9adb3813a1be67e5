"""Feature Pyramid Network on top of the ResNet stages, NCHW.

The port of ``crct_tpu/detector/fpn.py``: lateral 1x1 convs, a top-down
nearest 2x upsample (cropped to the lateral's size), 3x3 output convs
giving P2-P5, and P6 by a stride-2 1x1 max-pool of P5. Named as
Detectron2's ``backbone`` (``bottom_up``, ``fpn_lateral{2..5}``,
``fpn_output{2..5}``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from crct_tpu_torch.detector.resnet import ResNet

IN_CHANNELS = (256, 512, 1024, 2048)    # C2..C5 of a bottleneck ResNet


class FPN(nn.Module):
    def __init__(self, bottom_up: ResNet, out_channels: int = 256):
        super().__init__()
        self.bottom_up = bottom_up
        for i, c in enumerate(IN_CHANNELS):
            self.add_module(f"fpn_lateral{i + 2}",
                            nn.Conv2d(c, out_channels, 1))
            self.add_module(f"fpn_output{i + 2}",
                            nn.Conv2d(out_channels, out_channels, 3,
                                      padding=1))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """[B, 3, H, W] -> (P2, P3, P4, P5, P6), each [B, C, h, w]."""
        c_feats = self.bottom_up(x)
        laterals = [getattr(self, f"fpn_lateral{i + 2}")(c)
                    for i, c in enumerate(c_feats)]
        merged = [laterals[-1]]
        for lat in laterals[-2::-1]:
            up = F.interpolate(merged[0], scale_factor=2, mode="nearest")
            merged.insert(0, lat + up[..., :lat.shape[-2], :lat.shape[-1]])
        outs = [getattr(self, f"fpn_output{i + 2}")(m)
                for i, m in enumerate(merged)]
        return tuple(outs) + (F.max_pool2d(outs[-1], 1, 2),)
