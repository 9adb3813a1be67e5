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

The detector's checkpoints (``detector_<iter>.ckpt``) hold its state dict,
the step and the build facts it needs (:func:`save_detector_checkpoint`);
``detector.convert.restore_detector_params`` reads them back.

:func:`load_checkpoint` also reads the JAX package's checkpoints: Orbax
OCDBT directories of the same names, holding the flax parameter tree, the
serialized optax state and ``iter_id`` (``crct_tpu/utils/checkpoint.py``;
a detector's holds ``detector_meta`` beside its params). tensorstore reads
them, imported where it is needed: a host without it moves such a
checkpoint with ``cli.convert_checkpoint`` on a host that has it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from crct_tpu_torch.utils.convert import (FAST_SCORER_PREFIX,
                                          flax_to_state_dict,
                                          strip_reference_keys)

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


def is_orbax_checkpoint(path: str) -> bool:
    """A checkpoint directory the JAX package wrote (it holds
    ``_METADATA``)."""
    return os.path.isfile(os.path.join(path, "_METADATA"))


def load_orbax_checkpoint(path: str) -> Dict[str, Any]:
    """A JAX package checkpoint as the nested dict of numpy arrays that its
    ``load_checkpoint`` returns. Each leaf is read by its key path, which
    ``_METADATA`` lists (``tree_metadata[*].key_metadata``), from the OCDBT
    store through tensorstore's zarr driver; empty nodes (optax's empty
    states) are left out."""
    import tensorstore as ts

    path = os.path.abspath(path)
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", True):
        raise ValueError(f"{path}: not an OCDBT checkpoint")
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    context = ts.Context()
    tree: Dict[str, Any] = {}
    for entry in meta["tree_metadata"].values():
        if entry.get("value_metadata", {}).get("skip_deserialize"):
            continue
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        store = ts.open({"driver": driver, "kvstore": {
            "driver": "ocdbt", "base": f"file://{path}",
            "path": ".".join(keys) + "/"}}, context=context, open=True,
            read=True).result()
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(store.read().result())
    return tree


def _is_ce_regressor(tree: Dict[str, Any]) -> bool:
    """A JAX CE regressor's fusion MLP ends in the 65 float bins, the
    plain one in a scalar."""
    out = tree.get("regressor", {}).get("fusion_out", {}).get("kernel")
    return out is not None and np.shape(out)[-1] > 1


def adamw_state(saved: Dict[str, Any], ce_reg: bool = False
                ) -> Dict[str, Any]:
    """The JAX optimizer's serialized state (``flax.serialization.
    to_state_dict`` of ``make_optimizer``'s, ``optax.MultiSteps``-wrapped
    under ``-batch_multiply``) in ``AdamW.state_dict()``'s form. Each
    group's chain holds Adam's ``count``/``mu``/``nu`` at index 0 (only the
    group's parameters) and the schedule's ``count`` after it; every group
    counts the same updates. ``mu``, ``nu`` and MultiSteps' ``acc_grads``
    are keyed and transposed as their parameters are."""
    multi = "inner_opt_state" in saved
    inner = saved["inner_opt_state"] if multi else saved
    state: Dict[str, Dict[str, torch.Tensor]] = {}
    counts = set()
    for group in inner["inner_states"].values():
        for idx, sub in group["inner_state"].items():
            if "count" in sub:
                counts.add(int(sub["count"]))
            if idx != "0":
                continue
            for slot in ("mu", "nu"):
                for key, t in flax_to_state_dict(sub.get(slot, {}), ce_reg,
                                                 dtype=None).items():
                    state.setdefault(key, {})[slot] = t
    if len(counts) != 1:
        raise ValueError(f"optimizer groups disagree on the step: {counts}")
    out = {"count": counts.pop(), "mini_step": 0, "state": state}
    if multi:
        out["mini_step"] = int(saved["mini_step"])
        for key, t in flax_to_state_dict(saved["acc_grads"], ce_reg).items():
            state.setdefault(key, {})["acc"] = t
    return out


def restore_opt_state(optimizer, saved: Dict[str, Any]) -> None:
    """Load a saved optimizer state into the port's ``AdamW``: its own
    ``state_dict()``, or the JAX optimizer's serialized state (the
    counterpart of ``crct_tpu/utils/checkpoint.py::restore_opt_state``)."""
    if "inner_states" in saved or "inner_opt_state" in saved:
        saved = adamw_state(saved, ce_reg=any(
            k.startswith("regressor.ce_fusion.") for k in optimizer.state))
    optimizer.load_state_dict(saved)


def _from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX checkpoint tree as the port's checkpoint dict."""
    params = tree.get("model_state_dict", {})
    out: Dict[str, Any] = {"iter_id": int(tree.get("iter_id", 0))}
    if "backbone" in params:                  # a detector's
        from crct_tpu_torch.detector.convert import \
            detector_flax_to_state_dict
        out["model_state_dict"] = detector_flax_to_state_dict(params)
    else:
        ce_reg = _is_ce_regressor(params)
        out["model_state_dict"] = flax_to_state_dict(params, ce_reg)
        if "optimizer_state_dict" in tree:
            out["optimizer_state_dict"] = adamw_state(
                tree["optimizer_state_dict"], ce_reg)
    if "detector_meta" in tree:
        out["detector_meta"] = tree["detector_meta"]
    return out


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint of the port's (a torch file, or a reference
    ``crct.ckpt``) or of the JAX package's (an Orbax directory), as the
    port's dict: ``model_state_dict`` in the port's keys, the optimizer
    state in ``AdamW.state_dict()``'s form and ``iter_id`` where saved, and
    a detector's ``detector_meta``."""
    if is_orbax_checkpoint(path):
        return _from_jax(load_orbax_checkpoint(path))
    loaded = torch.load(path, map_location="cpu", weights_only=False)
    if "model_state_dict" not in loaded:      # a bare reference state dict
        loaded = {"model_state_dict": loaded}
    loaded["model_state_dict"] = strip_reference_keys(
        loaded["model_state_dict"])
    return loaded


_FUSION = ("regressor.fusion.", "regressor.ce_fusion.")


def _own_key(key: str, own) -> str:
    """``key``, or its name in the other regressor head where only that
    one is in ``own``: the JAX tree calls both heads' MLP
    ``fusion_hidden``, so its transfer crosses between them."""
    if key in own:
        return key
    for a, b in (_FUSION, _FUSION[::-1]):
        if key.startswith(a):
            return b + key[len(a):]
    return key


def transfer_params(model: torch.nn.Module, loaded: Dict[str, torch.Tensor],
                    verbose: bool = True) -> int:
    """Copy the tensors whose key and shape match into ``model`` (reference
    'transfer' load, train.py:93-104; ``crct_tpu/utils/checkpoint.py::
    transfer_params``). Returns how many were copied; raises if none."""
    own = model.state_dict()
    picked = {}
    for k, v in loaded.items():
        k = _own_key(k, own)
        if k in own and tuple(own[k].shape) == tuple(v.shape):
            picked[k] = v
    if not picked:
        raise ValueError("no keys transferred from checkpoint")
    with torch.no_grad():
        for k, v in picked.items():
            own[k].copy_(v)
    if verbose:
        print(f"number of keys transferred: {len(picked)}")
    return len(picked)


def load_start_checkpoint(model: torch.nn.Module, path: str,
                          warn_head: bool = True) -> Dict[str, torch.Tensor]:
    """``-start_checkpoint`` into ``model`` in transfer mode, as the JAX
    entry points load it; with ``warn_head``, warns where the model has a
    fast-scorer head that the checkpoint lacks (the head keeps its init).
    Returns the checkpoint's state dict."""
    loaded = load_checkpoint(path)["model_state_dict"]
    transfer_params(model, loaded)
    if warn_head and getattr(model, "has_fast_scorer", False) and not any(
            k.startswith(FAST_SCORER_PREFIX) for k in loaded):
        print("WARNING: -fast_scorer, but the checkpoint carries no "
              "fast_scorer head: the head is RANDOM. Train one with "
              "cli.train_fast_scorer first.", flush=True)
    return loaded


def detector_checkpoint_name(iter_id: int) -> str:
    return f"detector_{iter_id}.ckpt"


def save_detector_checkpoint(path: str, model_state: Dict[str, torch.Tensor],
                             iter_id: int, detector_meta: Dict[str, Any]
                             ) -> None:
    """Write a detector checkpoint (the JAX ``cli/detector_train.py``'s
    ``detector_<iter>.ckpt``): the model's state dict in Detectron2 names,
    frozen-norm buffers included, the step, and ``detector_meta`` (stride
    convention, pixel mean and std, depth), which extraction and serving
    rebuild the model from. The file appears whole or not at all."""
    tree = {"model_state_dict": {k: v.detach().cpu()
                                 for k, v in model_state.items()},
            "iter_id": int(iter_id), "detector_meta": dict(detector_meta)}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)
