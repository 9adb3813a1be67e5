"""Detector weights: Detectron2 / torchvision files, the port's own
checkpoints, and the JAX package's params.

The port of ``crct_tpu/detector/convert.py``. The port's modules carry
Detectron2's names, so a Detectron2 model-zoo ``.pkl``
(``{"model": {key: ndarray}}``) or ``.pth`` state dict needs no renaming;
a torchvision ResNet (``conv1``/``bn1``/``layer{1..4}``) is renamed onto
the trunk. Detectron2 (Caffe2-heritage) weights expect BGR input: the
stem's input channels are flipped so the model consumes RGB like the rest
of the pipeline, and ``stride_in_1x1`` and mean-only normalization come
with them (:func:`detector_file_meta`).

:func:`detector_flax_to_state_dict` carries the JAX package's detector
params (as numpy) into the port's state dict, for the tests that hold the
two packages against each other.
"""

from __future__ import annotations

import pickle
import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

def load_detector_torch_file(path: str) -> Dict[str, np.ndarray]:
    """A Detectron2 ``.pkl`` or a torch ``.pth``/``.bin`` state dict as
    {key: ndarray}."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        sd = data.get("model", data)
    else:
        data = torch.load(path, map_location="cpu", weights_only=False)
        sd = data.get("model", data.get("state_dict",
                                        data.get("model_state_dict", data)))
    return {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v))
            for k, v in sd.items() if hasattr(v, "shape") or
            isinstance(v, (list, tuple, np.ndarray))}


def _is_detectron2(keys) -> bool:
    return any(k.startswith(("backbone.bottom_up", "roi_heads."))
               for k in keys)


def _layout_meta(detectron2: bool) -> Dict[str, Any]:
    """Build and preprocessing facts a weights layout implies: Detectron2
    zoo weights are stride-in-1x1 with mean-only normalization (means in
    RGB, the stem being flipped to RGB); torchvision keeps ImageNet
    mean/std."""
    if detectron2:
        return {"stride_in_1x1": True,
                "pixel_mean": [123.675, 116.28, 103.53],
                "pixel_std": [1.0, 1.0, 1.0], "depth": None}
    return {"stride_in_1x1": False,
            "pixel_mean": [123.675, 116.28, 103.53],
            "pixel_std": [58.395, 57.12, 57.375], "depth": None}


def _depth_from_keys(sd) -> Any:
    """The ResNet depth from the stage-4 block count (R50: blocks 0-5,
    R101: 0-22); None when unrecognized."""
    mx = -1
    for k in sd:
        m = re.search(r"(?:res4|layer3)\.(\d+)\.", k)
        if m:
            mx = max(mx, int(m.group(1)))
    return {5: 50, 22: 101}.get(mx)


_TRUNK = "backbone.bottom_up."
_TV_LAYER = re.compile(r"^layer(\d)\.(\d+)\.(conv\d|bn\d|downsample\.[01])\."
                       r"(\w+)$")


def _torchvision_key(key: str):
    """A torchvision ResNet key as the port's trunk key, else None."""
    leaf = key.rsplit(".", 1)[-1]
    if key.startswith("conv1."):
        return _TRUNK + "stem." + key
    if key.startswith("bn1."):
        return _TRUNK + "stem.conv1.norm." + leaf
    m = _TV_LAYER.match(key)
    if not m:
        return None
    stage, block, sub = int(m.group(1)) + 1, m.group(2), m.group(3)
    node = {"downsample.0": "shortcut",
            "downsample.1": "shortcut.norm"}.get(
        sub, sub if sub.startswith("conv") else
        sub.replace("bn", "conv") + ".norm")
    return f"{_TRUNK}res{stage}.{block}.{node}.{leaf}"


def convert_detector_state_dict(sd: Dict[str, np.ndarray]
                                ) -> Tuple[Dict[str, torch.Tensor], List[str],
                                           Dict[str, Any]]:
    """A Detectron2 or torchvision state dict in the port's keys. Returns
    (state dict, keys not mapped, meta)."""
    detectron2 = _is_detectron2(sd)
    out: Dict[str, torch.Tensor] = {}
    skipped: List[str] = []
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        name = k if detectron2 else _torchvision_key(k)
        if name is None:
            skipped.append(k)
            continue
        out[name] = torch.from_numpy(np.ascontiguousarray(v))
    stem = _TRUNK + "stem.conv1.weight"
    if detectron2 and stem in out:
        out[stem] = out[stem].flip(1).contiguous()      # BGR -> RGB input
    meta = _layout_meta(detectron2)
    meta["depth"] = _depth_from_keys(sd)
    return out, skipped, meta


def detector_file_meta(path: str) -> Dict[str, Any]:
    """The stride convention, pixel normalization and depth a weights file
    needs, before the model is built. The port's own checkpoints carry
    them in ``detector_meta``; a file without it gets torchvision's."""
    if not path:
        return _layout_meta(False)
    if not path.endswith((".pkl", ".pth", ".bin")):
        m = torch.load(path, map_location="cpu",
                       weights_only=False).get("detector_meta")
        if m is None:
            return _layout_meta(False)
        return {"stride_in_1x1": bool(m["stride_in_1x1"]),
                "pixel_mean": [float(x) for x in m["pixel_mean"]],
                "pixel_std": [float(x) for x in m["pixel_std"]],
                "depth": m.get("depth")}
    sd = load_detector_torch_file(path)
    meta = _layout_meta(_is_detectron2(sd))
    meta["depth"] = _depth_from_keys(sd)
    return meta


def transfer_state(model: torch.nn.Module, loaded: Dict[str, torch.Tensor],
                   verbose: bool = True) -> int:
    """Copy the tensors whose key and shape match into ``model``'s
    parameters and buffers; class-count-dependent heads of another class
    count are skipped. Returns how many were copied."""
    own = model.state_dict()
    picked = {k: v for k, v in loaded.items()
              if k in own and tuple(own[k].shape) == tuple(v.shape)}
    if not picked:
        raise ValueError("no keys transferred from the weights file")
    with torch.no_grad():
        for k, v in picked.items():
            own[k].copy_(v)
    if verbose:
        print(f"number of keys transferred: {len(picked)} of {len(own)}")
    return len(picked)


def restore_detector_params(model: torch.nn.Module, path: str,
                            verbose: bool = True) -> Dict[str, Any]:
    """Load a port detector checkpoint, a torch ``.pth``/``.bin`` or a
    Detectron2 ``.pkl`` into ``model``. Returns the file's meta."""
    if path.endswith((".pkl", ".pth", ".bin")):
        sd, skipped, meta = convert_detector_state_dict(
            load_detector_torch_file(path))
        if verbose and skipped:
            print(f"detector import: {len(skipped)} source keys unmapped "
                  f"(e.g. {skipped[:3]})")
        transfer_state(model, sd, verbose)
        return meta
    loaded = torch.load(path, map_location="cpu", weights_only=False)
    transfer_state(model, loaded["model_state_dict"], verbose)
    return detector_file_meta(path)


# ---------------------------------------------------------------------------
# JAX params -> the port's state dict (the tests' bridge)
# ---------------------------------------------------------------------------

_FLAX_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}


def _conv_weight(kernel: np.ndarray) -> np.ndarray:
    return np.transpose(kernel, (3, 2, 0, 1))           # HWIO -> OIHW


def detector_flax_to_state_dict(params: Dict[str, Any],
                                pooled: int = 7) -> Dict[str, torch.Tensor]:
    """The JAX ``MaskRCNN`` params tree (numpy leaves), or the part of it
    that is present (``{"backbone": ...}`` alone for a ResNet), as the
    port's state dict: conv kernels HWIO -> OIHW, dense kernels transposed,
    the box head's fc1 input reordered from flax's (h, w, c) flatten to
    torch's (c, h, w), the 2x2 deconv flipped spatially (flax's
    ConvTranspose mirrors the taps), FrozenBN params as buffers."""
    sd: Dict[str, np.ndarray] = {}

    def put_conv(name, node, bias=True):
        sd[f"{name}.weight"] = _conv_weight(np.asarray(node["kernel"]))
        if bias and "bias" in node:
            sd[f"{name}.bias"] = np.asarray(node["bias"])

    def put_bn(name, node):
        for k, v in node.items():
            sd[f"{name}.{_FLAX_BN[k]}"] = np.asarray(v)

    def put_dense(name, node):
        sd[f"{name}.weight"] = np.asarray(node["kernel"]).T
        sd[f"{name}.bias"] = np.asarray(node["bias"])

    bb = params["backbone"]
    put_conv(_TRUNK + "stem.conv1", bb["stem_conv"], bias=False)
    put_bn(_TRUNK + "stem.conv1.norm", bb["stem_bn"])
    for name, blk in bb.items():
        m = re.match(r"stage(\d)_block(\d+)$", name)
        if not m:
            continue
        base = f"{_TRUNK}res{m.group(1)}.{m.group(2)}"
        for sub, node in blk.items():
            if sub.startswith("bn"):
                put_bn(f"{base}.conv{sub[2:]}.norm", node)
            elif sub == "shortcut_bn":
                put_bn(f"{base}.shortcut.norm", node)
            else:
                put_conv(f"{base}.{sub}", node, bias=False)
    for name, node in params.get("fpn", {}).items():
        kind, level = name[:-1], name[-1]
        put_conv(f"backbone.fpn_{kind}{level}", node)
    if "rpn_head" in params:
        rpn = params["rpn_head"]
        put_conv("proposal_generator.rpn_head.conv", rpn["conv"])
        put_conv("proposal_generator.rpn_head.objectness_logits",
                 rpn["objectness"])
        put_conv("proposal_generator.rpn_head.anchor_deltas", rpn["deltas"])
    if "box_head" in params:
        fc1 = np.asarray(params["box_head"]["fc1"]["kernel"])  # [(h,w,c), o]
        C = fc1.shape[0] // (pooled * pooled)
        sd["roi_heads.box_head.fc1.weight"] = (
            fc1.reshape(pooled, pooled, C, -1).transpose(3, 2, 0, 1)
            .reshape(fc1.shape[1], -1))
        sd["roi_heads.box_head.fc1.bias"] = np.asarray(
            params["box_head"]["fc1"]["bias"])
        put_dense("roi_heads.box_head.fc2", params["box_head"]["fc2"])
    for name in ("cls_score", "bbox_pred"):
        if name in params.get("box_predictor", {}):
            put_dense(f"roi_heads.box_predictor.{name}",
                      params["box_predictor"][name])
    if "mask_head" in params:
        mh = params["mask_head"]
        for i in range(1, 5):
            put_conv(f"roi_heads.mask_head.mask_fcn{i}", mh[f"mask_fcn{i}"])
        # flax [kh, kw, in, out] with mirrored taps -> torch [in, out, kh, kw]
        sd["roi_heads.mask_head.deconv.weight"] = np.transpose(
            np.asarray(mh["deconv"]["kernel"])[::-1, ::-1], (2, 3, 0, 1))
        sd["roi_heads.mask_head.deconv.bias"] = np.asarray(
            mh["deconv"]["bias"])
        put_conv("roi_heads.mask_head.predictor", mh["predictor"])
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
