"""Weights into the port: JAX parameter trees and reference checkpoints.

``flax_to_state_dict`` turns a JAX ``CRCTModel`` parameter tree (nested dict
of numpy arrays, as ``jax.device_get(params)`` gives) into the port's
``state_dict``: the logic of ``crct_tpu/utils/convert.py::inverse_convert``
without the ``bert_pretrained.`` prefix (Linear kernels transposed from
flax's [in, out] to torch's [out, in]; LayerNorm scale -> weight; Embedding
embedding -> weight). ``load_torch_checkpoint`` reads a reference
``crct.ckpt`` (or a state dict the port saved) into the same layout, with
the legacy heads the forward never uses dropped. ``CRCTModel.load_state_dict
(..., strict=True)`` takes either; a fast-scorer head (``fast_scorer``
subtree) maps to the ``fast_scorer.*`` keys.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

import numpy as np
import torch

PREFIXES = ("bert_pretrained.", "module.bert_pretrained.", "module.")

# state_dict keys of the reference torch model that are not part of the
# graph (crct_tpu/utils/convert.py:25-38)
SKIPPED_PATTERNS = [
    r"^cls\.predictions\.",            # tied LM head (returns None, vilbert.py:1059)
    r"^cls\.imagePredictions\.",       # masked-image head (loss hard-zeroed)
    r"\.q_dense1\.", r"\.q_dense2\.",  # defined but unused in BertBiOutput
    r"^bert\.v_embeddings\.type_embeddings\.",  # unused 13-way embedding
    r"^bert\.v_embeddings\.sep_emb\.",          # figure_qa-only, unused in fwd
    r"^inconsistency_head\.",
    # plain HF BERT checkpoints (bert-base-uncased init path):
    r"^bert\.embeddings\.token_type_embeddings",
    r"^bert\.embeddings\.position_ids$",
    r"^bert\.pooler\.",
    r"^cls\.seq_relationship\.",
]

_TXT_EMB = ("word_embeddings", "position_embeddings", "plotqa_type_embeddings")
# torch submodule of a BertLayer -> (flax module path, kind)
_LAYER_SUB = {
    "attention.self.query": (("attention", "query"), "linear"),
    "attention.self.key": (("attention", "key"), "linear"),
    "attention.self.value": (("attention", "value"), "linear"),
    "attention.output.dense": (("attention", "out"), "linear"),
    "attention.output.LayerNorm": (("attention", "out_ln"), "ln"),
    "intermediate.dense": (("ffn", "inter"), "linear"),
    "output.dense": (("ffn", "out"), "linear"),
    "output.LayerNorm": (("ffn", "out_ln"), "ln"),
}
_CONN_SUB = {
    "biattention.query1": (("biattention", "v_query"), "linear"),
    "biattention.key1": (("biattention", "v_key"), "linear"),
    "biattention.value1": (("biattention", "v_value"), "linear"),
    "biattention.query2": (("biattention", "t_query"), "linear"),
    "biattention.key2": (("biattention", "t_key"), "linear"),
    "biattention.value2": (("biattention", "t_value"), "linear"),
    "biOutput.dense1": (("v_dense",), "linear"),
    "biOutput.LayerNorm1": (("v_ln",), "ln"),
    "biOutput.dense2": (("t_dense",), "linear"),
    "biOutput.LayerNorm2": (("t_ln",), "ln"),
    "v_intermediate.dense": (("v_ffn", "inter"), "linear"),
    "v_output.dense": (("v_ffn", "out"), "linear"),
    "v_output.LayerNorm": (("v_ffn", "out_ln"), "ln"),
    "t_intermediate.dense": (("t_ffn", "inter"), "linear"),
    "t_output.dense": (("t_ffn", "out"), "linear"),
    "t_output.LayerNorm": (("t_ffn", "out_ln"), "ln"),
}
# flax pipe dense index -> torch Sequential index
_PIPE_IDX = {0: 0, 1: 2, 2: 4, 3: 6}


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def flax_to_state_dict(flax_params: Dict[str, Any],
                       ce_reg: bool = False) -> Dict[str, torch.Tensor]:
    """JAX ``CRCTModel`` params -> the port's ``state_dict`` (fp32 CPU
    tensors)."""
    out: Dict[str, torch.Tensor] = {}

    def linear(base, node):
        out[f"{base}.weight"] = _tensor(node["kernel"]).T.contiguous()
        if "bias" in node:
            out[f"{base}.bias"] = _tensor(node["bias"])

    def layernorm(base, node):
        out[f"{base}.weight"] = _tensor(node["scale"])
        out[f"{base}.bias"] = _tensor(node["bias"])

    def embed(base, node):
        out[f"{base}.weight"] = _tensor(node["embedding"])

    def walk(node, path):
        for k in path:
            node = node[k]
        return node

    bert = flax_params["bert"]
    emb = bert["embeddings"]
    for name in _TXT_EMB:
        embed(f"bert.embeddings.{name}", emb[name])
    linear("bert.embeddings.txt_location_embeddings",
           emb["txt_location_embeddings"])
    layernorm("bert.embeddings.LayerNorm", emb["LayerNorm"])

    vemb = bert["v_embeddings"]
    linear("bert.v_embeddings.new_image_embeddings",
           vemb["new_image_embeddings"])
    linear("bert.v_embeddings.new_loc_emb", vemb["new_loc_emb"])
    embed("bert.v_embeddings.color_emb", vemb["color_emb"])
    layernorm("bert.v_embeddings.LayerNorm", vemb["LayerNorm"])
    if "areas_emb" in vemb:
        linear("bert.v_embeddings.areas_emp", vemb["areas_emb"])

    for name, layer in bert["encoder"].items():
        kind, idx = name.rsplit("_", 1)
        if kind in ("t_layer", "v_layer"):
            prefix = "layer" if kind == "t_layer" else "v_layer"
            table = _LAYER_SUB
        else:
            prefix, table = "c_layer", _CONN_SUB
        for sub, (path, ptype) in table.items():
            base = f"bert.encoder.{prefix}.{idx}.{sub}"
            (linear if ptype == "linear" else layernorm)(base,
                                                         walk(layer, path))

    linear("bert.t_pooler.dense", bert["t_pooler"]["dense"])
    linear("bert.v_pooler.dense", bert["v_pooler"]["dense"])
    linear("cls.bi_seq_relationship", flax_params["cls"]["bi_seq_relationship"])

    if "regressor" in flax_params:
        reg = flax_params["regressor"]
        for pipe in ("txt_pipe", "vis_pipe"):
            for dname, node in reg[pipe].items():
                idx = _PIPE_IDX[int(dname.rsplit("_", 1)[1])]
                linear(f"regressor.{pipe}.{idx}", node)
        fusion = "ce_fusion" if ce_reg else "fusion"
        for dname, node in reg["fusion_hidden"].items():
            idx = _PIPE_IDX[int(dname.rsplit("_", 1)[1])]
            linear(f"regressor.{fusion}.{idx}", node)
        linear(f"regressor.{fusion}.6", reg["fusion_out"])

    if "fast_scorer" in flax_params:
        out.update(fast_scorer_state_dict(flax_params["fast_scorer"]))
    return out


def fast_scorer_state_dict(head: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``FastScorer`` subtree -> the port's ``fast_scorer.*`` keys."""
    out = {"fast_scorer.cand_embeddings.weight":
           _tensor(head["cand_embeddings"]["embedding"])}
    for name in ("cand_proj1", "cand_proj2", "question_proj"):
        out[f"fast_scorer.{name}.weight"] = \
            _tensor(head[name]["kernel"]).T.contiguous()
        out[f"fast_scorer.{name}.bias"] = _tensor(head[name]["bias"])
    return out


_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "bias": "bias"}
_FLAX_LAYER = {path: sub for sub, (path, _) in _LAYER_SUB.items()}
_FLAX_CONN = {path: sub for sub, (path, _) in _CONN_SUB.items()}
_FLAX_VEMB = {"new_image_embeddings": "new_image_embeddings",
              "new_loc_emb": "new_loc_emb", "color_emb": "color_emb",
              "LayerNorm": "LayerNorm", "areas_emb": "areas_emp"}


def torch_key(flax_path: str) -> str:
    """The port's state-dict key of one JAX parameter, given by its flax
    path (``bert/encoder/t_layer_0/attention/key/kernel`` ->
    ``bert.encoder.layer.0.attention.self.key.weight``): the key table of
    :func:`flax_to_state_dict`, for the backbone and the NSP head."""
    parts = flax_path.split("/")
    *mods, leaf = parts
    if leaf not in _LEAF or len(mods) < 2:
        raise KeyError(flax_path)
    head, tail = mods[:2], tuple(mods[2:])
    if head == ["bert", "embeddings"] and len(tail) == 1:
        base = f"bert.embeddings.{tail[0]}"
    elif head == ["bert", "v_embeddings"] and len(tail) == 1 \
            and tail[0] in _FLAX_VEMB:
        base = f"bert.v_embeddings.{_FLAX_VEMB[tail[0]]}"
    elif head == ["bert", "encoder"] and tail:
        kind, idx = tail[0].rsplit("_", 1)
        table = _FLAX_CONN if kind == "c_layer" else _FLAX_LAYER
        prefix = {"t_layer": "layer", "v_layer": "v_layer",
                  "c_layer": "c_layer"}[kind]
        base = f"bert.encoder.{prefix}.{idx}.{table[tail[1:]]}"
    elif head[0] == "bert" and head[1] in ("t_pooler", "v_pooler") \
            and tail == ("dense",):
        base = f"bert.{head[1]}.dense"
    elif mods == ["cls", "bi_seq_relationship"]:
        base = "cls.bi_seq_relationship"
    else:
        raise KeyError(flax_path)
    return f"{base}.{_LEAF[leaf]}"


def strip_reference_keys(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Reference state-dict keys -> the port's: the ``bert_pretrained.``
    prefix stripped, old TF-era ``gamma``/``beta`` renamed, and the keys of
    ``SKIPPED_PATTERNS`` dropped."""
    out = {}
    for key, value in state_dict.items():
        for p in PREFIXES:
            if key.startswith(p):
                key = key[len(p):]
                break
        if any(re.search(p, key) for p in SKIPPED_PATTERNS):
            continue
        base, _, param = key.rpartition(".")
        param = {"gamma": "weight", "beta": "bias"}.get(param, param)
        out[f"{base}.{param}"] = value
    return out


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint in the reference layout (``crct.ckpt``, with or
    without its ``model_state_dict`` wrapper) as the port's state dict on
    the CPU."""
    loaded = torch.load(path, map_location="cpu", weights_only=False)
    sd = loaded.get("model_state_dict", loaded)
    return strip_reference_keys(
        {k: torch.as_tensor(v) for k, v in sd.items()})


FAST_SCORER_PREFIX = "fast_scorer."


def load_weights(model: torch.nn.Module,
                 state_dict: Dict[str, torch.Tensor]) -> List[str]:
    """Load ``state_dict`` into ``model``, every key of the model required
    apart from the fast-scorer head's: a backbone-only checkpoint loads
    into a model with the head (the head keeps its init), and a head in the
    checkpoint is left out of a model without one. Returns the head keys the
    checkpoint lacked; any other missing or unexpected key raises."""
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    head = [k for k in missing if k.startswith(FAST_SCORER_PREFIX)]
    other = ([k for k in missing if not k.startswith(FAST_SCORER_PREFIX)]
             + [k for k in unexpected
                if not k.startswith(FAST_SCORER_PREFIX)])
    if other:
        raise RuntimeError(f"checkpoint does not fit the model: {other[:8]}")
    return head
