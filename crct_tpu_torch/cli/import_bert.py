"""Import plain BERT weights into the text stream (pretrained init; the
port of ``crct_tpu/cli/import_bert.py``).

Replaces the reference's bert-base-uncased download + key remap
(CRCT/backbone/vilbert.py:1112-1285): takes a BERT state dict and writes a
port checkpoint whose text-stream weights are the BERT ones. Loaded by
``cli.train -start_checkpoint`` in transfer mode, the remaining (vision /
co-attention / heads) parameters keep their fresh initialization, the
reference's from_pretrained behavior.

Usage:
    # a local HF-style torch state dict (pytorch_model.bin; old
    # gamma/beta naming included)
    python -m crct_tpu_torch.cli.import_bert pytorch_model.bin out/bert.ckpt
    # through transformers: a save_pretrained directory (offline), or a
    # hub name (downloads and caches on first use)
    python -m crct_tpu_torch.cli.import_bert hf:bert-base-uncased out/b.ckpt
    # a Google-released TensorFlow checkpoint (the bert_model.ckpt prefix;
    # the reference's from_tf path, vilbert.py:48-108), read by tensorflow
    python -m crct_tpu_torch.cli.import_bert tf:uncased_L-12/bert_model.ckpt out/b
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Dict

import numpy as np


def hf_state_dict(model_name: str) -> Dict[str, np.ndarray]:
    """A BERT state dict through transformers (``AutoModel.
    from_pretrained``): a local directory, or a hub name, which needs the
    network on first use only. Keys get the ``bert.`` prefix."""
    from transformers import AutoModel
    model = AutoModel.from_pretrained(model_name)
    return {k if k.startswith("bert.") else f"bert.{k}":
            v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def tf_state_dict(ckpt_prefix: str) -> Dict[str, np.ndarray]:
    """A Google-released TensorFlow BERT checkpoint as the torch-style state
    dict :func:`utils.convert.convert_torch_state_dict` takes (the
    reference's ``load_tf_weights_in_bert``, vilbert.py:48-108): optimizer
    slots skipped, ``layer_N`` -> ``layer.N``, kernel -> weight
    transposed (TF stores dense kernels [in, out]), gamma/beta and
    output_weights/output_bias -> weight/bias, bare ``*_embeddings``
    tables get ``.weight``."""
    import tensorflow as tf

    reader = tf.train.load_checkpoint(ckpt_prefix)
    sd = {}
    for name in sorted(reader.get_variable_to_shape_map()):
        if any(p in ("adam_v", "adam_m", "global_step")
               for p in name.split("/")):
            continue                    # optimizer slots (vilbert.py:62-66)
        arr = np.asarray(reader.get_tensor(name))
        parts = []
        for piece in name.split("/"):
            m = re.fullmatch(r"layer_(\d+)", piece)
            parts.append(f"layer.{m.group(1)}" if m else piece)
        last = parts[-1]
        if last == "kernel":
            parts[-1], arr = "weight", arr.T
        elif last in ("gamma", "output_weights"):
            parts[-1] = "weight"
        elif last in ("beta", "output_bias"):
            parts[-1] = "bias"
        elif last.endswith("_embeddings"):
            parts.append("weight")      # vilbert.py:101-102
        sd[".".join(parts)] = arr
    return sd


def source_state_dict(src: str):
    """The BERT state dict of a ``src`` argument: ``hf:<name-or-dir>``,
    ``tf:<prefix>`` (or a prefix whose ``.index`` file exists), else a
    torch state dict file."""
    import torch
    if src.startswith("hf:"):
        return hf_state_dict(src[3:])
    if src.startswith("tf:") or os.path.exists(src + ".index"):
        return tf_state_dict(src[3:] if src.startswith("tf:") else src)
    loaded = torch.load(src, map_location="cpu", weights_only=False)
    return loaded.get("model_state_dict", loaded)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("src", help="HF pytorch_model.bin / torch state dict, "
                               "hf:<model-name-or-dir> through "
                               "transformers, or tf:<ckpt-prefix> / a TF "
                               "checkpoint prefix (<prefix>.index exists)")
    p.add_argument("dst", help="output port checkpoint (torch file)")
    args = p.parse_args(argv)

    import torch

    from crct_tpu_torch.utils.checkpoint import save_checkpoint
    from crct_tpu_torch.utils.convert import convert_torch_state_dict

    sd, skipped = convert_torch_state_dict(source_state_dict(args.src))
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}
    print(f"imported {len(sd)} BERT tensors; skipped {len(skipped)} "
          f"(heads/pooler/type embeddings)")
    save_checkpoint(args.dst, sd)
    print(f"wrote {args.dst}")
    return args.dst


if __name__ == "__main__":
    main()
