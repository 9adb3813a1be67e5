"""COCO-format dataset layer for detector training/eval.

The port of ``crct_tpu/detector/coco.py`` (numpy; PIL imported inside the
functions that decode, resize or draw). Replaces Detectron2's dataset
registry + loaders (reference
Detector/frcnn.py:86-128 registers COCO-format PlotQA/FigureQA/DVQA
annotation jsons). Loads annotations into numpy, resizes with the
shortest-edge transform, pads images and GT boxes to fixed shapes (one
compile for the whole run), and rasterizes polygon segmentations into
28x28 per-box mask targets for the mask head.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

# pixel normalization (ImageNet BGR means, Detectron2 convention uses
# mean subtraction only; we use RGB mean/std)
PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)


class CocoDataset:
    """COCO-format annotations + images, fixed-shape examples."""

    # Detectron2 zoo INPUT defaults the reference trainer inherits
    # (Detector/frcnn.py:182-205 -> DefaultTrainer): random horizontal
    # flip + multi-scale shortest-edge sampling
    TRAIN_SCALES = (640, 672, 704, 736, 768, 800)

    def __init__(self, annotations_path: str, image_dir: str, *,
                 max_boxes: int = 100, short_edge: int = 800,
                 max_size: int = 1344, with_masks: bool = False,
                 pixel_mean: Optional[Sequence[float]] = None,
                 pixel_std: Optional[Sequence[float]] = None,
                 augment: bool = False,
                 train_scales: Optional[Sequence[int]] = None,
                 aug_seed: int = 0):
        # comma-separated annotation jsons concatenate (the reference
        # registers plotqa_train1..3 as one training set, frcnn.py:91-93)
        paths = str(annotations_path).split(",")
        with open(paths[0]) as f:
            coco = json.load(f)
        for extra in paths[1:]:
            with open(extra) as f:
                more = json.load(f)
            coco["images"] += more["images"]
            coco["annotations"] += more["annotations"]
        self.image_dir = image_dir
        # normalization must match the pretrained weights' convention
        # (detector_file_meta): mean-only for Caffe2-heritage zoo weights
        self.pixel_mean = np.asarray(
            PIXEL_MEAN if pixel_mean is None else pixel_mean, np.float32)
        self.pixel_std = np.asarray(
            PIXEL_STD if pixel_std is None else pixel_std, np.float32)
        self.max_boxes = max_boxes
        self.short_edge = short_edge
        self.max_size = max_size
        self.with_masks = with_masks
        # train-time augmentation: every sampled scale pads into the SAME
        # (max_size, max_size) canvas, so the whole multi-scale schedule
        # compiles exactly ONE train-step shape
        self.augment = augment
        self.train_scales = tuple(train_scales if train_scales is not None
                                  else self.TRAIN_SCALES)
        self.aug_rng = np.random.default_rng(aug_seed)
        self.categories = [c['name'] for c in coco.get('categories', [])]
        cat_ids = {c['id']: i for i, c in enumerate(coco.get('categories', []))}
        self.images = coco['images']
        anns_by_image: Dict[int, List[Dict]] = {}
        for ann in coco.get('annotations', []):
            anns_by_image.setdefault(ann['image_id'], []).append(ann)
        self.anns_by_image = anns_by_image
        self.cat_ids = cat_ids

    def __len__(self) -> int:
        return len(self.images)

    def load_image(self, file_name: str) -> np.ndarray:
        from PIL import Image
        img = Image.open(os.path.join(self.image_dir, file_name))
        return np.asarray(img.convert("RGB"), np.float32)

    def resize_factor(self, h: int, w: int,
                      short_edge: Optional[int] = None) -> float:
        scale = (short_edge or self.short_edge) / min(h, w)
        if max(h, w) * scale > self.max_size:
            scale = self.max_size / max(h, w)
        return scale

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        info = self.images[idx]
        img = self.load_image(info['file_name'])
        h, w = img.shape[:2]
        short = self.short_edge
        flip = False
        if self.augment:
            short = int(self.aug_rng.choice(self.train_scales))
            flip = bool(self.aug_rng.random() < 0.5)
        scale = self.resize_factor(h, w, short)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        from PIL import Image
        img = np.asarray(
            Image.fromarray(img.astype(np.uint8)).resize(
                (nw, nh), Image.BILINEAR), np.float32)
        if flip:
            img = img[:, ::-1]
        img = (img - self.pixel_mean) / self.pixel_std
        padded = np.zeros((self.max_size, self.max_size, 3), np.float32)
        padded[:nh, :nw] = img

        anns = self.anns_by_image.get(info['id'], [])
        boxes = np.zeros((self.max_boxes, 4), np.float32)
        classes = np.zeros((self.max_boxes,), np.int32)
        valid = np.zeros((self.max_boxes,), bool)
        masks = (np.zeros((self.max_boxes, 28, 28), np.float32)
                 if self.with_masks else None)
        for i, ann in enumerate(anns[: self.max_boxes]):
            x, y, bw, bh = ann['bbox']
            box = np.array([x, y, x + bw, y + bh], np.float32) * scale
            if self.with_masks and ann.get('segmentation'):
                # rasterize in the UNFLIPPED box frame; a horizontal image
                # flip mirrors the content of an axis-aligned box about its
                # vertical centerline, so the 28x28 target flips left-right
                m = rasterize_mask28(ann['segmentation'], box, scale)
                masks[i] = m[:, ::-1] if flip else m
            if flip:
                box = np.array([nw - box[2], box[1], nw - box[0], box[3]],
                               np.float32)
            boxes[i] = box
            classes[i] = self.cat_ids.get(ann['category_id'], 0)
            valid[i] = True
        out = {"image": padded, "gt_boxes": boxes, "gt_classes": classes,
               "gt_valid": valid, "image_id": info['id'],
               "hw": (nh, nw), "scale": scale, "flipped": flip}
        if self.with_masks:
            out["gt_masks28"] = masks
        return out


def rasterize_mask28(segmentation, box_xyxy: np.ndarray,
                     scale: float) -> np.ndarray:
    """Rasterize COCO polygon(s) into a 28x28 grid aligned to the box."""
    from PIL import Image, ImageDraw
    x1, y1, x2, y2 = box_xyxy
    w = max(x2 - x1, 1e-3)
    h = max(y2 - y1, 1e-3)
    img = Image.new("L", (28, 28), 0)
    draw = ImageDraw.Draw(img)
    polys = segmentation if isinstance(segmentation, list) else []
    for poly in polys:
        if not isinstance(poly, list) or len(poly) < 6:
            continue
        pts = np.asarray(poly, np.float32).reshape(-1, 2) * scale
        pts[:, 0] = (pts[:, 0] - x1) / w * 28
        pts[:, 1] = (pts[:, 1] - y1) / h * 28
        draw.polygon([tuple(p) for p in pts], fill=1)
    return np.asarray(img, np.float32)


# ---------------------------------------------------------------------------
# COCO bbox mAP evaluator (replaces detectron2 COCOEvaluator, frcnn.py:74-83)
# ---------------------------------------------------------------------------

def average_precision(recalls: np.ndarray, precisions: np.ndarray) -> float:
    """101-point interpolated AP (COCO convention)."""
    rec_points = np.linspace(0, 1, 101)
    # precision envelope
    order = np.argsort(recalls)
    recalls, precisions = recalls[order], precisions[order]
    prec_env = np.maximum.accumulate(precisions[::-1])[::-1]
    idx = np.searchsorted(recalls, rec_points, side="left")
    vals = np.where(idx < len(prec_env), prec_env[np.minimum(idx,
                                                             len(prec_env) - 1)],
                    0.0)
    return float(np.mean(vals))


def evaluate_detections(all_dets: List[Dict[str, np.ndarray]],
                        all_gts: List[Dict[str, np.ndarray]],
                        num_classes: int,
                        iou_thresholds: Optional[Sequence[float]] = None
                        ) -> Dict[str, float]:
    """bbox mAP over IoU 0.5:0.95 (plus AP50), numpy implementation.

    all_dets[i]: {boxes [N,4], scores [N], classes [N]}
    all_gts[i]:  {boxes [M,4], classes [M]}
    """
    import torch

    from crct_tpu_torch.ops.nms import iou_matrix
    if iou_thresholds is None:
        iou_thresholds = np.arange(0.5, 1.0, 0.05)
    ap_per_thr: List[List[float]] = [[] for _ in iou_thresholds]
    ap50: List[float] = []
    for c in range(num_classes):
        records = []   # (score, is_tp at each threshold)
        n_gt = 0
        per_image = []
        for dets, gts in zip(all_dets, all_gts):
            d_sel = dets['classes'] == c
            g_sel = gts['classes'] == c
            d_boxes = dets['boxes'][d_sel]
            d_scores = dets['scores'][d_sel]
            g_boxes = gts['boxes'][g_sel]
            n_gt += len(g_boxes)
            per_image.append((d_boxes, d_scores, g_boxes))
        if n_gt == 0:
            continue
        for ti, thr in enumerate(iou_thresholds):
            scores_all, tp_all = [], []
            for d_boxes, d_scores, g_boxes in per_image:
                order = np.argsort(-d_scores)
                used = np.zeros(len(g_boxes), bool)
                if len(d_boxes) and len(g_boxes):
                    # fp32, as jnp computes it
                    ious = iou_matrix(
                        torch.as_tensor(d_boxes, dtype=torch.float32),
                        torch.as_tensor(g_boxes, dtype=torch.float32)
                    ).numpy()
                else:
                    ious = np.zeros((len(d_boxes), len(g_boxes)))
                for di in order:
                    tp = False
                    if len(g_boxes):
                        gi = int(np.argmax(np.where(used, -1.0, ious[di])))
                        if not used[gi] and ious[di, gi] >= thr:
                            used[gi] = True
                            tp = True
                    scores_all.append(d_scores[di])
                    tp_all.append(tp)
            if not scores_all:
                ap_per_thr[ti].append(0.0)
                continue
            order = np.argsort(-np.asarray(scores_all))
            tp_sorted = np.asarray(tp_all)[order]
            cum_tp = np.cumsum(tp_sorted)
            precision = cum_tp / (np.arange(len(tp_sorted)) + 1)
            recall = cum_tp / n_gt
            ap = average_precision(recall, precision)
            ap_per_thr[ti].append(ap)
            if abs(thr - 0.5) < 1e-6:
                ap50.append(ap)
    maps = [np.mean(a) if a else 0.0 for a in ap_per_thr]
    return {"bbox_mAP": float(np.mean(maps)) if maps else 0.0,
            "bbox_AP50": float(np.mean(ap50)) if ap50 else 0.0}
