"""The system under test, set up as its entry points set it up: the port's
kernels built (once a checkout, into its ``build/kernels/``), the model
built on the device and given the benchmark's weights."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import torch


def build_kernels(device, names=("attention_fwd", "attention_bwd")) -> None:
    """nvcc every kernel the cell launches, in parallel, and load them: a
    no-op after the first run in a checkout."""
    if torch.device(device).type != "cuda":
        return
    from crct_tpu_torch.ops import build
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(build.build, names))
    for name in names:
        build.load(name)


def model(cfg, weights: Dict[str, torch.Tensor], device, dtype: str,
          train: bool):
    """``CRCTModel`` of the configuration, as ``build_model`` makes it
    (the CLIs' defaults), built on ``device`` (torch's default init there
    is a few hundred launches; on the host it takes seconds, and on the
    meta device the first draw imports much of torch) and loaded from
    ``weights``: fp32 masters in training (autocast to ``dtype``), in eval
    the parameters in ``dtype``."""
    from crct_tpu_torch.config import CRCTModelConfig
    from crct_tpu_torch.models.crct import CRCTModel
    d = cfg["dataset"]
    mcfg = CRCTModelConfig.from_dict(dict(cfg["model"]))
    mcfg.dtype = dtype
    with torch.device(device):
        m = CRCTModel(mcfg, categories=d["categories"], dataset=d["dataset"],
                      binary_answers=d["binary_answers"])
    m.load_state_dict(weights, strict=True)
    if train:
        return m.train()
    return m.set_compute_dtype().eval()
