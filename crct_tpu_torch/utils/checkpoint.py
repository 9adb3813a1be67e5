"""Checkpoint IO with the reference's save/load semantics.

The port of ``crct_tpu/utils/checkpoint.py``: saves named
``plotqa_encoder_<epoch>_<iter>.ckpt`` (reference CRCT/train.py:284-291),
here one ``torch.save`` file holding ``model_state_dict`` in the reference
layout (the ``bert_pretrained.`` prefix; ``utils.convert.
load_torch_checkpoint`` reads it back), ``optimizer_state_dict`` and
``iter_id``. Two load modes match the reference (train.py:91-130):

  * *transfer* -- copy only the parameters whose name and shape match into a
    freshly initialized model (weight transplant across head variants),
  * *continue* -- params + optimizer state + step, with the epoch parsed
    from the checkpoint's file name.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from crct_tpu_torch.utils.convert import strip_reference_keys

PREFIX = "bert_pretrained."


def checkpoint_name(epoch: int, iter_id: int) -> str:
    return f"plotqa_encoder_{epoch}_{iter_id}.ckpt"


def epoch_from_name(path: str) -> int:
    """Parse the epoch number out of plotqa_encoder_<epoch>_<iter>.ckpt."""
    return int(os.path.basename(path).split("_")[2])


def epoch_iter_from_name(path: str) -> tuple:
    """(epoch, iter) recency key: a preemption save shares its epoch
    number with the regular epoch save, so epoch alone cannot order them."""
    parts = os.path.basename(path).split("_")
    return int(parts[2]), int(parts[3].split(".")[0])


def to_host(tree):
    """A copy of a nested dict of tensors on the CPU (a copy also where a
    tensor already lies there, so later updates cannot reach it)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree


def save_checkpoint(path: str, model_state: Dict[str, torch.Tensor],
                    optimizer_state: Optional[Dict[str, Any]] = None,
                    iter_id: int = 0) -> None:
    """Write a model state dict (in the reference layout), the optimizer's
    state and the step; the file appears whole or not at all."""
    tree: Dict[str, Any] = {
        "model_state_dict": {PREFIX + k: v.detach().cpu()
                             for k, v in model_state.items()},
        "iter_id": int(iter_id)}
    if optimizer_state is not None:
        tree["optimizer_state_dict"] = optimizer_state
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The saved dict, with ``model_state_dict`` in the port's keys."""
    loaded = torch.load(path, map_location="cpu", weights_only=False)
    if "model_state_dict" not in loaded:      # a bare reference state dict
        loaded = {"model_state_dict": loaded}
    loaded["model_state_dict"] = strip_reference_keys(
        loaded["model_state_dict"])
    return loaded


def transfer_params(model: torch.nn.Module, loaded: Dict[str, torch.Tensor],
                    verbose: bool = True) -> int:
    """Copy the tensors whose key and shape match into ``model`` (reference
    'transfer' load, train.py:93-104). Returns how many were copied."""
    own = model.state_dict()
    picked = {k: v for k, v in loaded.items()
              if k in own and tuple(own[k].shape) == tuple(v.shape)}
    if not picked:
        raise ValueError("no keys transferred from checkpoint")
    with torch.no_grad():
        for k, v in picked.items():
            own[k].copy_(v)
    if verbose:
        print(f"number of keys transferred: {len(picked)}")
    return len(picked)
