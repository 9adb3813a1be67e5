"""Weights into the port: JAX parameter trees and reference checkpoints.

:func:`flax_key` maps one leaf of a JAX ``CRCTModel`` parameter tree, given
by its flax path, to the port's ``state_dict`` key, and says whether the
tensor is transposed on the way (Linear kernels from flax's [in, out] to
torch's [out, in]; LayerNorm scale -> weight; Embedding embedding ->
weight). It covers every module of the model: the text and vision
embeddings, the three layer kinds, the poolers, the NSP head, the regressor
(``fusion`` or ``ce_fusion``) and the fast-scorer head, so a *partial* tree
(the text stream ``cli.import_bert`` writes, a checkpoint of another head
variant) converts leaf by leaf. :func:`flax_to_state_dict` applies it to a
whole tree (nested dict of numpy arrays, as ``jax.device_get(params)`` or
an Orbax checkpoint gives).

``load_torch_checkpoint`` reads a reference ``crct.ckpt`` (or a state dict
the port saved) into the same layout, with the legacy heads the forward
never uses dropped; :func:`convert_torch_state_dict` also lists what it
dropped, as ``crct_tpu/utils/convert.py``'s converter does.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, List, Sequence, Tuple

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

_TXT_EMB = ("word_embeddings", "position_embeddings", "plotqa_type_embeddings",
            "txt_location_embeddings", "LayerNorm")
# flax v_embeddings module -> torch module (the reference's "areas_emp")
_VEMB = {"new_image_embeddings": "new_image_embeddings",
         "new_loc_emb": "new_loc_emb", "color_emb": "color_emb",
         "LayerNorm": "LayerNorm", "areas_emb": "areas_emp"}
# torch submodule of a BertLayer -> flax module path
_LAYER_SUB = {
    "attention.self.query": ("attention", "query"),
    "attention.self.key": ("attention", "key"),
    "attention.self.value": ("attention", "value"),
    "attention.output.dense": ("attention", "out"),
    "attention.output.LayerNorm": ("attention", "out_ln"),
    "intermediate.dense": ("ffn", "inter"),
    "output.dense": ("ffn", "out"),
    "output.LayerNorm": ("ffn", "out_ln"),
}
_CONN_SUB = {
    "biattention.query1": ("biattention", "v_query"),
    "biattention.key1": ("biattention", "v_key"),
    "biattention.value1": ("biattention", "v_value"),
    "biattention.query2": ("biattention", "t_query"),
    "biattention.key2": ("biattention", "t_key"),
    "biattention.value2": ("biattention", "t_value"),
    "biOutput.dense1": ("v_dense",),
    "biOutput.LayerNorm1": ("v_ln",),
    "biOutput.dense2": ("t_dense",),
    "biOutput.LayerNorm2": ("t_ln",),
    "v_intermediate.dense": ("v_ffn", "inter"),
    "v_output.dense": ("v_ffn", "out"),
    "v_output.LayerNorm": ("v_ffn", "out_ln"),
    "t_intermediate.dense": ("t_ffn", "inter"),
    "t_output.dense": ("t_ffn", "out"),
    "t_output.LayerNorm": ("t_ffn", "out_ln"),
}
_FLAX_LAYER = {path: sub for sub, path in _LAYER_SUB.items()}
_FLAX_CONN = {path: sub for sub, path in _CONN_SUB.items()}
_LAYER_PREFIX = {"t_layer": "layer", "v_layer": "v_layer", "c_layer": "c_layer"}
# flax pipe dense index -> torch Sequential index
_PIPE_IDX = {0: 0, 1: 2, 2: 4, 3: 6}
_FAST_SCORER = ("cand_embeddings", "cand_proj1", "cand_proj2",
                "question_proj")
_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "bias": "bias"}


def _dense_idx(name: str) -> int:
    kind, idx = name.rsplit("_", 1)
    if kind != "dense":
        raise KeyError(name)
    return _PIPE_IDX[int(idx)]


def _module_key(mods: Tuple[str, ...], ce_reg: bool) -> str:
    """The torch module of a flax module path (KeyError if none)."""
    top = mods[:2]
    rest = mods[2:]
    if top == ("bert", "embeddings") and len(rest) == 1 \
            and rest[0] in _TXT_EMB:
        return f"bert.embeddings.{rest[0]}"
    if top == ("bert", "v_embeddings") and len(rest) == 1:
        return f"bert.v_embeddings.{_VEMB[rest[0]]}"
    if top == ("bert", "encoder") and rest:
        kind, idx = rest[0].rsplit("_", 1)
        table = _FLAX_CONN if kind == "c_layer" else _FLAX_LAYER
        return (f"bert.encoder.{_LAYER_PREFIX[kind]}.{int(idx)}."
                f"{table[tuple(rest[1:])]}")
    if top in (("bert", "t_pooler"), ("bert", "v_pooler")) \
            and rest == ("dense",):
        return f"bert.{top[1]}.dense"
    if mods == ("cls", "bi_seq_relationship"):
        return "cls.bi_seq_relationship"
    fusion = "ce_fusion" if ce_reg else "fusion"
    if top in (("regressor", "txt_pipe"), ("regressor", "vis_pipe")) \
            and len(rest) == 1:
        return f"regressor.{top[1]}.{_dense_idx(rest[0])}"
    if top == ("regressor", "fusion_hidden") and len(rest) == 1:
        return f"regressor.{fusion}.{_dense_idx(rest[0])}"
    if mods == ("regressor", "fusion_out"):
        return f"regressor.{fusion}.6"
    if len(mods) == 2 and mods[0] == "fast_scorer" \
            and mods[1] in _FAST_SCORER:
        return f"fast_scorer.{mods[1]}"
    raise KeyError("/".join(mods))


def flax_key(path: Sequence[str], ce_reg: bool = False) -> Tuple[str, bool]:
    """(the port's state-dict key, transposed?) of the JAX parameter at the
    flax ``path`` (``("bert", "encoder", "t_layer_0", "attention", "key",
    "kernel")`` -> ``("bert.encoder.layer.0.attention.self.key.weight",
    True)``). ``ce_reg`` sends the regressor's fusion MLP to ``ce_fusion``.
    Raises KeyError for a path that is no parameter of the port's model."""
    *mods, leaf = path
    if leaf not in _LEAF:
        raise KeyError("/".join(path))
    try:
        base = _module_key(tuple(mods), ce_reg)
    except (KeyError, ValueError, IndexError):
        raise KeyError("/".join(path)) from None
    return f"{base}.{_LEAF[leaf]}", leaf == "kernel"


def torch_key(flax_path: str) -> str:
    """The port's key of one JAX parameter, given by its ``/``-joined flax
    path."""
    return flax_key(flax_path.split("/"))[0]


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
                ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of every leaf of a nested dict, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_tensor(x, transpose: bool = False) -> torch.Tensor:
    """A numpy (or ml_dtypes bfloat16) array as a CPU tensor of its own
    dtype, transposed when asked; a bfloat16 array crosses as its bits
    (``torch.from_numpy`` takes no ml_dtypes type)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.T.contiguous() if transpose else t


def flax_to_state_dict(flax_params: Dict[str, Any], ce_reg: bool = False,
                       dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """JAX ``CRCTModel`` params, whole or in part -> the port's keys (CPU
    tensors of ``dtype``; ``None`` keeps each leaf's own dtype). Raises
    KeyError for a leaf that is no parameter of the port's model."""
    out = {}
    for path, leaf in _leaves(flax_params):
        key, transpose = flax_key(path, ce_reg)
        t = _to_tensor(leaf, transpose)
        out[key] = t if dtype is None else t.to(dtype)
    return out


def fast_scorer_state_dict(head: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``FastScorer`` subtree -> the port's ``fast_scorer.*`` keys."""
    return flax_to_state_dict({"fast_scorer": head})


def _strip(key: str) -> str:
    for p in PREFIXES:
        if key.startswith(p):
            return key[len(p):]
    return key


def strip_reference_keys(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Reference state-dict keys -> the port's: the ``bert_pretrained.``
    prefix stripped, old TF-era ``gamma``/``beta`` renamed, and the keys of
    ``SKIPPED_PATTERNS`` dropped."""
    return convert_torch_state_dict(state_dict, keep_unknown=True)[0]


# a reference module the JAX converter maps (crct_tpu/utils/convert.py::
# _convert_one): the port's modules apart from the fast-scorer head
_KNOWN_BASE = re.compile(
    r"^(bert\.embeddings\.(" + "|".join(_TXT_EMB) + r")"
    r"|bert\.v_embeddings\.(" + "|".join(_VEMB.values()) + r")"
    r"|bert\.encoder\.(layer|v_layer)\.\d+\.("
    + "|".join(re.escape(s) for s in _LAYER_SUB) + r")"
    r"|bert\.encoder\.c_layer\.\d+\.("
    + "|".join(re.escape(s) for s in _CONN_SUB) + r")"
    r"|bert\.(t_pooler|v_pooler)\.dense|cls\.bi_seq_relationship"
    r"|regressor\.(txt_pipe|vis_pipe|fusion|ce_fusion)\.[0246])$")


def convert_torch_state_dict(state_dict: Dict[str, Any],
                             keep_unknown: bool = False
                             ) -> Tuple[Dict[str, Any], List[str]]:
    """A reference state dict in the port's keys, and the keys it dropped:
    those of ``SKIPPED_PATTERNS`` (as given), then each module the model
    has no counterpart of (by its stripped name, once), as the JAX
    converter reports them. ``keep_unknown`` keeps the latter."""
    out: Dict[str, Any] = {}
    skipped: List[str] = []
    unknown: Dict[str, None] = {}
    for full_key, value in state_dict.items():
        key = _strip(full_key)
        if any(re.search(p, key) for p in SKIPPED_PATTERNS):
            skipped.append(full_key)
            continue
        base, _, param = key.rpartition(".")
        param = {"gamma": "weight", "beta": "bias"}.get(param, param)
        if not (keep_unknown or _KNOWN_BASE.match(base)):
            unknown[base] = None
            continue
        out[f"{base}.{param}"] = value
    return out, skipped + list(unknown)


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint in the reference layout (``crct.ckpt``, with or
    without its ``model_state_dict`` wrapper) as the port's state dict on
    the CPU."""
    loaded = torch.load(path, map_location="cpu", weights_only=False)
    sd = loaded.get("model_state_dict", loaded)
    return strip_reference_keys(
        {k: torch.as_tensor(v) for k, v in sd.items()})


FAST_SCORER_PREFIX = "fast_scorer."
