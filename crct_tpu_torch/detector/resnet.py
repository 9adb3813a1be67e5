"""ResNet backbone (the detector's CNN trunk), NCHW, Detectron2 names.

The port of ``crct_tpu/detector/resnet.py``. Module attributes carry
Detectron2's names (``stem.conv1``, ``res2.0.conv1.norm``, ...), so a
Detectron2 state dict loads as it is. Batch norm is frozen
(``FrozenBatchNorm2d``: affine scale/bias and running statistics held as
buffers, never trained): the Detectron2 default for detection fine-tuning.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BLOCKS_PER_STAGE = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3),
                    14: (1, 1, 1, 1)}  # tiny trunk for tests


class FrozenBN(nn.Module):
    """Affine normalization with fixed running statistics (buffers)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return (x * inv.to(x.dtype)[None, :, None, None]
                + shift.to(x.dtype)[None, :, None, None])


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with an optional ``norm`` after it (Detectron2's
    wrapper, whence the ``conv1.norm.*`` keys)."""

    def __init__(self, *args, norm: Optional[nn.Module] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.norm = norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = super().forward(x)
        return x if self.norm is None else self.norm(x)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with a projection shortcut where the
    width or stride changes. ``stride_in_1x1``: Detectron2's model-zoo
    ResNets put the stride-2 on the first 1x1 conv; torchvision on the
    3x3."""

    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 stride_in_1x1: bool = False):
        super().__init__()
        out_ch = filters * 4
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        if in_channels != out_ch or stride != 1:
            self.shortcut = Conv2d(in_channels, out_ch, 1, stride, bias=False,
                                   norm=FrozenBN(out_ch))
        else:
            self.shortcut = None
        self.conv1 = Conv2d(in_channels, filters, 1, s1, bias=False,
                            norm=FrozenBN(filters))
        self.conv2 = Conv2d(filters, filters, 3, s3, padding=1, bias=False,
                            norm=FrozenBN(filters))
        self.conv3 = Conv2d(filters, out_ch, 1, bias=False,
                            norm=FrozenBN(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        y = F.relu(self.conv1(x))
        y = F.relu(self.conv2(y))
        y = self.conv3(y)
        return F.relu(y + shortcut)


class BasicStem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, padding=3, bias=False,
                            norm=FrozenBN(64))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(F.relu(self.conv1(x)), 3, 2, padding=1)


class ResNet(nn.Module):
    """Returns the C2..C5 stage outputs (strides 4, 8, 16, 32) of an NCHW
    image batch. ``freeze_at``: Detectron2 semantics (1 = stem, 2 = stem
    and res2, ...): a detach at the boundary keeps every earlier
    parameter's gradient out."""

    def __init__(self, depth: int = 50, stride_in_1x1: bool = False,
                 freeze_at: int = 0):
        super().__init__()
        self.freeze_at = freeze_at
        self.stem = BasicStem()
        in_ch = 64
        self.stage_names = []
        for stage, (n_blocks, filters) in enumerate(
                zip(BLOCKS_PER_STAGE[depth], (64, 128, 256, 512))):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                blocks.append(Bottleneck(in_ch, filters, stride,
                                         stride_in_1x1))
                in_ch = filters * 4
            name = f"res{stage + 2}"
            self.add_module(name, nn.Sequential(*blocks))
            self.stage_names.append(name)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        y = self.stem(x)
        if self.freeze_at == 1:
            y = y.detach()
        outs = []
        for i, name in enumerate(self.stage_names):
            y = getattr(self, name)(y)
            if self.freeze_at == i + 2:
                y = y.detach()
            outs.append(y)
        return tuple(outs)
