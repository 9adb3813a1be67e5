"""Synthetic chart PNG + PlotQA-format annotation generator.

The port's copy of ``crct_tpu/detector/synthetic_charts.py``; PIL is
imported inside ``render_chart``.

Renders simple bar charts with PIL and emits annotations in the PlotQA
layout the extractor's GT-oracle path consumes (title / axis labels / ticks
/ legend under ``general_figure_info``, reference
Detector/extract_features.py:182-254), plus COCO detection annotations for
detector training. Used by the end-to-end PNG -> detection -> features ->
QA tests and demos; no real PlotQA download required.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np

WORDS = ["revenue", "exports", "imports", "growth", "cost", "energy",
         "income", "apples", "bananas", "cars", "north", "south", "east",
         "west", "years", "value"]


def _bbox(x, y, w, h):
    return {"x": float(x), "y": float(y), "w": float(w), "h": float(h)}


def render_chart(image_id: int, rng: np.random.Generator, *,
                 size: Tuple[int, int] = (320, 240)):
    """Draw one vbar chart; returns (PIL image, plotqa annotation,
    coco annotations)."""
    from PIL import Image, ImageDraw
    W, H = size
    img = Image.new("RGB", (W, H), (255, 255, 255))
    draw = ImageDraw.Draw(img)

    # plot area
    x0, y0 = int(W * 0.18), int(H * 0.12)   # top-left of plot area
    x1, y1 = int(W * 0.92), int(H * 0.82)   # bottom-right
    draw.line([x0, y1, x1, y1], fill=(0, 0, 0), width=2)   # x axis
    draw.line([x0, y0, x0, y1], fill=(0, 0, 0), width=2)   # y axis

    n_bars = int(rng.integers(2, 5))
    cats = list(rng.choice(WORDS[:10], size=n_bars, replace=False))
    y_max = float(rng.choice([10, 100, 1000]))
    values = np.round(rng.random(n_bars) * y_max, 1)

    title = " ".join(rng.choice(WORDS, size=2))
    xlabel, ylabel = str(rng.choice(WORDS)), str(rng.choice(WORDS))

    coco_anns: List[Dict] = []
    models = []
    bar_w = (x1 - x0) / (n_bars * 2)
    bar_boxes = []
    for i, v in enumerate(values):
        bx0 = x0 + (2 * i + 0.5) * bar_w
        bx1 = bx0 + bar_w
        bh = (v / y_max) * (y1 - y0)
        by0 = y1 - bh
        color = tuple(int(c) for c in rng.integers(40, 220, 3))
        draw.rectangle([bx0, by0, bx1, y1], fill=color)
        bar_boxes.append([bx0, by0, bx1, y1])
        coco_anns.append({"category_id": 9 + i,  # bar_i classes
                          "bbox": [bx0, by0, bx1 - bx0, y1 - by0],
                          "segmentation": [[bx0, by0, bx1, by0, bx1, y1,
                                            bx0, y1]]})
        models.append({"name": cats[i], "ys": [float(v)]})

    # text (drawn as small rectangles is enough for the detector; real glyphs
    # for OCR realism)
    def put_text(x, y, s):
        draw.text((x, y), s, fill=(0, 0, 0))
        tw, th = max(6 * len(s), 8), 10
        return [x, y, x + tw, y + th]

    title_box = put_text(W * 0.35, H * 0.03, title)
    xlabel_box = put_text(W * 0.45, H * 0.92, xlabel)
    ylabel_box = put_text(W * 0.01, H * 0.45, ylabel)

    xtick_boxes, ytick_info = [], []
    for i, cat in enumerate(cats):
        cx = x0 + (2 * i + 1) * bar_w
        xtick_boxes.append(put_text(cx - 3 * len(cat), y1 + 4, cat))
    n_yticks = 3
    ytick_labels = [f"{y_max * j / (n_yticks - 1):g}" for j in range(n_yticks)]
    for j, lab in enumerate(ytick_labels):
        cy = y1 - j * (y1 - y0) / (n_yticks - 1)
        ytick_info.append((lab, put_text(x0 - 6 * len(lab) - 4, cy - 5, lab)))

    legend_items = []
    if rng.random() < 0.5:
        for i, cat in enumerate(cats[:2]):
            ly = y0 + 12 * i
            draw.rectangle([x1 - 60, ly, x1 - 48, ly + 8],
                           fill=tuple(int(c) for c in rng.integers(40, 220, 3)))
            box = put_text(x1 - 44, ly, cat)
            legend_items.append({"label": {
                "text": cat, "bbox": _bbox(box[0], box[1], box[2] - box[0],
                                           box[3] - box[1])}})

    def xyxy(b):
        return _bbox(b[0], b[1], b[2] - b[0], b[3] - b[1])

    # tick bboxes are duplicated in PlotQA annotations (major_labels lists
    # values twice; the GT-oracle halves them, extract_features.py:229-231)
    xtick_vals = cats + cats
    xtick_bxs = [xyxy(b) for b in xtick_boxes] * 2
    ytick_vals = [t for t, _ in ytick_info] * 2
    ytick_bxs = [xyxy(b) for _, b in ytick_info] * 2

    annotation = {
        "image_index": image_id,
        "models": models,
        "type": "vbar",
        "general_figure_info": {
            "title": {"text": title, "bbox": xyxy(title_box)},
            "x_axis": {
                "label": {"text": xlabel, "bbox": xyxy(xlabel_box)},
                "major_labels": {"values": xtick_vals, "bboxes": xtick_bxs},
                "rule": {"bbox": _bbox(x0, y1 - 1, x1 - x0, 3)},
            },
            "y_axis": {
                "label": {"text": ylabel, "bbox": xyxy(ylabel_box)},
                "major_labels": {"values": ytick_vals, "bboxes": ytick_bxs},
                "rule": {"bbox": _bbox(x0 - 1, y0, 3, y1 - y0)},
            },
        },
    }
    if legend_items:
        annotation["general_figure_info"]["legend"] = {"items": legend_items}

    # axis-rule + text coco annotations (classes 1-8 per plotqa taxonomy)
    def add_coco(cid, box):
        coco_anns.append({"category_id": cid,
                          "bbox": [box[0], box[1], box[2] - box[0],
                                   box[3] - box[1]],
                          "segmentation": [[box[0], box[1], box[2], box[1],
                                            box[2], box[3], box[0], box[3]]]})
    add_coco(2, title_box)
    add_coco(3, xlabel_box)
    add_coco(5, ylabel_box)
    for b in xtick_boxes:
        add_coco(4, b)
    for _, b in ytick_info:
        add_coco(6, b)
    add_coco(7, [x0, y1 - 1, x1, y1 + 2])     # x_axis rule
    add_coco(8, [x0 - 1, y0, x0 + 2, y1])     # y_axis rule

    qa_meta = {"cats": cats, "values": values.tolist(), "y_max": y_max,
               "title": title}
    return img, annotation, coco_anns, qa_meta


def generate_png_dataset(root: str, *, n_images: int = 4, seed: int = 0,
                         split: str = "test") -> Dict[str, Any]:
    """Write <root>/<split>/png/*.png + annotations.json + qa_pairs.npy +
    a COCO detection json. Returns paths."""
    rng = np.random.default_rng(seed)
    png_dir = os.path.join(root, split, "png")
    os.makedirs(png_dir, exist_ok=True)
    annotations, qa_pairs, coco_images, coco_annotations = [], [], [], []
    aid = 0
    for img_id in range(n_images):
        img, ann, coco_anns, meta = render_chart(img_id, rng)
        img.save(os.path.join(png_dir, f"{img_id}.png"))
        annotations.append(ann)
        coco_images.append({"id": img_id, "file_name": f"{img_id}.png",
                            "width": img.width, "height": img.height})
        for a in coco_anns:
            a.update(id=aid, image_id=img_id, iscrowd=0,
                     area=a["bbox"][2] * a["bbox"][3])
            coco_annotations.append(a)
            aid += 1
        qa_pairs.append({
            "image_index": img_id, "qid": "S1", "type": "vbar",
            "template": "structural",
            "question_string": "how many bars are there ?",
            "answer": len(meta["cats"]),
        })
        qa_pairs.append({
            "image_index": img_id, "qid": "D7", "type": "vbar",
            "template": "data_retrieval",
            "question_string": f"what is the value of {meta['cats'][0]} ?",
            "answer": float(meta["values"][0]),
        })
    with open(os.path.join(root, split, "annotations.json"), "w") as f:
        json.dump(annotations, f)
    np.save(os.path.join(root, split, "qa_pairs.npy"),
            np.asarray(qa_pairs, dtype=object), allow_pickle=True)
    cats = ([{"id": 1, "name": "legend_label"}, {"id": 2, "name": "title"},
             {"id": 3, "name": "xlabel"}, {"id": 4, "name": "xticklabel"},
             {"id": 5, "name": "ylabel"}, {"id": 6, "name": "yticklabel"},
             {"id": 7, "name": "x_axis"}, {"id": 8, "name": "y_axis"}]
            + [{"id": 9 + i, "name": f"bar_{i}"} for i in range(8)])
    coco = {"images": coco_images, "annotations": coco_annotations,
            "categories": cats}
    coco_path = os.path.join(root, split, "coco.json")
    with open(coco_path, "w") as f:
        json.dump(coco, f)
    return {"png_dir": png_dir, "root": root, "split": split,
            "coco": coco_path,
            "annotations": os.path.join(root, split, "annotations.json"),
            "qa_file": os.path.join(root, split, "qa_pairs.npy")}
