"""Synthetic PlotQA-style fixtures: fig-feature shards + QA files.

The PyTorch port's copy of ``crct_tpu/data/synthetic.py``: the same seed
writes the same files.

Generates on-disk data in exactly the reference's record schema
(Detector/extract_features.py:567-575 for feature records;
PlotQA qa_pairs fields used by CRCT/fig_dataloader.py): sharded `.npy`
list-of-dicts feature files keyed by ``image_id // division`` and a
`qa_pairs.npy` per split. Used by tests, the benchmark and the end-to-end
smoke slice — no real PlotQA download required.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np

WORDS = ["revenue", "exports", "imports", "population", "growth", "cost",
         "energy", "income", "rainfall", "apples", "bananas", "cars", "ships",
         "dogs", "cats", "students", "teachers", "books", "north", "south",
         "east", "west", "alpha", "beta", "gamma", "delta", "years", "value",
         "country", "region", "annual", "total", "average", "difference",
         "sum", "what", "is", "the", "of", "in", "across", "all", "how",
         "many", "does", "exceed", "legend", "title", "axis"]

FIG_TYPES = ["vbar", "hbar", "line", "dot_line"]
QIDS_STRUCT = ["S1", "S2", "S7"]
QIDS_DATA = ["D7", "D14", "D15"]
QIDS_REASON = ["A1", "M4", "C2"]


def _make_text_feat(rng: np.random.Generator) -> Tuple[Dict, List[str], List[float]]:
    n_xticks = int(rng.integers(3, 6))
    n_yticks = int(rng.integers(3, 6))
    n_legend = int(rng.integers(0, 3))
    cats = list(rng.choice(WORDS[:20], size=n_xticks, replace=False))
    y_max = float(rng.choice([1, 10, 100, 1000])) * float(rng.integers(1, 9))
    y_vals = np.linspace(0, y_max, n_yticks)
    text_feat: Dict[str, Any] = {
        "title": {"text": " ".join(rng.choice(WORDS, size=3)),
                  "bbox": [0.3, 1.1, 0.7, 1.15]},
        "x_axis": {
            "label": " ".join(rng.choice(WORDS, size=2)),
            "ticks": [(cats[i], (i + 1) / (n_xticks + 1))
                      for i in range(n_xticks)],
            "x": 0.5, "y": 0.0, "w": 1.0, "h": 0.02,
        },
        "y_axis": {
            "label": " ".join(rng.choice(WORDS, size=2)),
            "ticks": [(f"{y_vals[i]:g}", (i + 1) / (n_yticks + 1))
                      for i in range(n_yticks)],
            "x": 0.0, "y": 0.5, "w": 0.02, "h": 1.0,
        },
    }
    legend_labels: List[str] = []
    if n_legend:
        legend_labels = list(rng.choice(WORDS[20:32], size=n_legend,
                                        replace=False))
        text_feat["legend"] = {
            "label": np.asarray(legend_labels),
            "bbox": [[0.8, 0.9 - 0.05 * i, 0.95, 0.93 - 0.05 * i]
                     for i in range(n_legend)],
        }
    return text_feat, cats, list(y_vals)


def make_fig_feat(image_id: int, rng: np.random.Generator,
                  feat_dim: int = 1024, max_boxes: int = 20) -> Dict[str, Any]:
    text_feat, cats, y_vals = _make_text_feat(rng)
    n_vis = int(rng.integers(4, max_boxes))
    n = n_vis + 1  # + <IMG> token at slot 0
    cls = np.zeros(n, np.int64)
    cls[0] = 1000
    cls[1:] = rng.integers(8, 81, size=n_vis)  # plotqa bar class range
    bbox = rng.random((n, 4)).astype(np.float32)
    # make boxes well-formed: x1<x2, y2<y1 in plot coords
    bbox[:, 2] = bbox[:, 0] + 0.1 + 0.2 * rng.random(n)
    bbox[:, 1] = bbox[:, 3] + 0.3 + 0.4 * rng.random(n)
    return {
        "image_id": image_id,
        "vis_feat": rng.standard_normal((n, feat_dim)).astype(np.float32),
        "vis_bbox": bbox,
        "class": cls,
        "text_feat": text_feat,
        "width": 640,
        "height": 480,
        "_cats": cats,
        "_yvals": y_vals,
    }


def make_qa_pairs(fig: Dict[str, Any], rng: np.random.Generator,
                  n_questions: int = 4,
                  task: str = "random") -> List[Dict[str, Any]]:
    """QA pairs for one figure.

    task="random" (default): the reference-schema smoke mix — answers are
    random, so the task is NOT learnable (used for shape/parity/throughput
    tests). task="retrieval": a deterministic, learnable rule — the
    question names one x-tick label and the answer IS that label, so the
    answer-ranking head (the NSP score, reference
    CRCT/backbone/vilbert.py:1042,1060) can learn lexical matching between
    the candidate answer and the question; used by the end-to-end
    convergence proof in tests/test_train.py."""
    out = []
    cats, y_vals = fig["_cats"], fig["_yvals"]
    for q in range(n_questions):
        if task == "retrieval":
            # the queried tick label is the only candidate string that
            # appears verbatim in the question (template words are not
            # chart texts; other ticks/legend entries are absent from it)
            cat = cats[int(rng.integers(0, len(cats)))]
            out.append({"question_string": f"which bar is {cat} ?",
                        "answer": cat,
                        "qid": str(rng.choice(QIDS_DATA)), "type": "vbar",
                        "template": "data_retrieval",
                        "image_index": fig["image_id"]})
            continue
        kind = rng.integers(0, 4)
        fig_type = str(rng.choice(FIG_TYPES))
        if kind == 0:   # yes/no structural
            qa = {"question_string": f"does the {cats[0]} value exceed the "
                                     f"{cats[-1]} value ?",
                  "answer": str(rng.choice(["Yes", "No"])),
                  "qid": str(rng.choice(QIDS_STRUCT)), "type": fig_type,
                  "template": "structural"}
        elif kind == 1:  # fixed-vocab count
            qa = {"question_string": "how many legend labels are there ?",
                  "answer": int(rng.integers(0, 9)),
                  "qid": str(rng.choice(QIDS_STRUCT)), "type": fig_type,
                  "template": "structural"}
        elif kind == 2:  # chart-text retrieval
            qa = {"question_string": f"what is the label across the {cats[0]} ?",
                  "answer": str(rng.choice(cats)),
                  "qid": str(rng.choice(QIDS_DATA)), "type": fig_type,
                  "template": "data_retrieval"}
        else:            # regression (answer not in any vocab)
            val = float(np.round(rng.random() * max(y_vals[-1], 1.0), 3))
            qa = {"question_string": f"what is the average {cats[0]} value ?",
                  "answer": val,
                  "qid": str(rng.choice(QIDS_REASON)), "type": fig_type,
                  "template": "reasoning"}
        qa["image_index"] = fig["image_id"]
        out.append(qa)
    return out


def generate_dataset(root: str, *, n_images: int = 8, division: int = 4,
                     n_questions: int = 4, feat_dim: int = 1024,
                     splits=("train", "val", "test"), seed: int = 0,
                     qa_file: str = "qa_pairs.npy",
                     task: str = "random") -> Dict[str, Any]:
    """Write a full synthetic dataset tree; returns dataset-config values."""
    rng = np.random.default_rng(seed)
    feat_root = os.path.join(root, "fig_features")
    qa_root = os.path.join(root, "QA")
    for split in splits:
        os.makedirs(os.path.join(feat_root, split), exist_ok=True)
        os.makedirs(os.path.join(qa_root, split), exist_ok=True)
        qa_pairs: List[Dict[str, Any]] = []
        shard: List[Dict[str, Any]] = []
        shard_id = 0
        for img_id in range(n_images):
            fig = make_fig_feat(img_id, rng, feat_dim=feat_dim)
            qa_pairs.extend(make_qa_pairs(fig, rng, n_questions, task=task))
            fig = {k: v for k, v in fig.items() if not k.startswith("_")}
            shard.append(fig)
            if len(shard) == division or img_id == n_images - 1:
                np.save(os.path.join(feat_root, split, f"{shard_id}.npy"),
                        np.asarray(shard, dtype=object), allow_pickle=True)
                shard, shard_id = [], shard_id + 1
        np.save(os.path.join(qa_root, split, qa_file),
                np.asarray(qa_pairs, dtype=object), allow_pickle=True)
    config = {
        "name": "Synthetic PlotQA config",
        "dataset": "plotqa",
        "categories": 228,
        "max_vis_features": 44,
        "max_seq_len": 124,
        "binary_answers": False,
        "main_folder": root,
        "figure_feat_path": feat_root + "/",
        "qa_parent_dir": qa_root + "/",
        "dataset_files_divisions": {s: division for s in splits},
        "splits": list(splits),
    }
    with open(os.path.join(root, "dataset_config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return config
