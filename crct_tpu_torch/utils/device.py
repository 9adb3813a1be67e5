"""Where the port runs: the card, unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``. A CUDA device with no card visible
    raises: the port never carries on on the CPU unless told to."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for but no card is visible; pass "
                           "device='cpu' (-device cpu) to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def params_device(params) -> torch.device:
    """The device of an entry point's ``-device`` / ``-cuda_num`` flags."""
    device = params["device"]
    if device == "cuda" and params["cuda_num"] >= 0:
        device = f"cuda:{params['cuda_num']}"
    return resolve_device(device)
