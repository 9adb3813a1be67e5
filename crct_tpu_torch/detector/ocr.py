"""Text attachment: Hungarian OCR oracle + (gated) real OCR.

The port's copy of ``crct_tpu/detector/ocr.py``; scipy is imported
inside the function that needs it.

Host-side (offline) components of the feature extractor:
  * IoU + Hungarian assignment matching predicted text boxes to GT text
    (reference Detector/feature_extraction/bbox_match.py) — scipy on CPU,
    it never touches the accelerator path;
  * real OCR via pytesseract when available (reference
    Detector/extract_features.py:579-627), including the vertical-tick
    rotation heuristic and FigureQA color-name fuzzy match.
"""

from __future__ import annotations

import difflib
from typing import Dict, List

import numpy as np

COLORS_FIGUREQA = [
    'Dark Turquoise', 'Light Slate', 'Sandy Brown', 'Slate', 'Cadet Blue',
    'Indigo', 'Deep Pink', 'Light Sky Blue', 'Web Gray', 'Turquoise',
    'Dark Salmon', 'Coral', 'Saddle Brown', 'Light Salmon', 'Dark Periwinkle',
    'Dark Magenta', 'Black', 'Violet', 'Orange Red', 'Brown', 'Crimson',
    'Dark Blue', 'Dark Orchid', 'Midnight Blue', 'Purple', 'Dark Red', 'Peru',
    'Medium Aqua', 'Dark Gold', 'Light Gold', 'Medium Seafoam',
    'Green Yellow', 'Aqua', 'Orchid', 'Royal Blue', 'Gold', 'Medium Purple',
    'Blue Violet', 'Pale Green', 'Dark Seafoam', 'Rebecca Purple',
    'Deep Sky Blue', 'Web Purple', 'Green', 'Olive Drab', 'Chocolate',
    'Mint', 'Dark Cyan', 'Burlywood', 'Olive', 'Seafoam', 'Light Green',
    'Cornflower', 'Cyan', 'Medium Orchid', 'Firebrick', 'Violet Red',
    'Dark Khaki', 'Teal', 'Hot Pink', 'Sienna', 'Dodger Blue', 'Gray',
    'Salmon', 'Sky Blue', 'Web Green', 'Dark Gray', 'Web Maroon',
    'Dark Olive', 'Maroon', 'Periwinkle', 'Red', 'Dark Slate',
    'Forest Green', 'Rosy Brown', 'Chartreuse', 'Lime Green', 'Dim Gray',
    'Medium Mint', 'Tan', 'Navy Blue', 'Steel Blue', 'Light Seafoam',
    'Khaki', 'Yellow', 'Light Coral', 'Bubblegum', 'Orange',
    'Medium Periwinkle', 'Indian Red', 'Lawn Green', 'Dark Orange',
    'Dark Violet', 'Medium Blue', 'Blue', 'Tomato', 'Medium Turquoise',
    'Yellow Green', 'Magenta', 'Dark Green']


def pairwise_iou_plus_one(boxes_a: np.ndarray, boxes_b: np.ndarray
                          ) -> np.ndarray:
    """Pixel-inclusive IoU matrix with -1 for non-overlap (reference
    bbox_match.py:6-27 convention: +1 on widths, reject non-overlap)."""
    n, m = len(boxes_a), len(boxes_b)
    out = np.full((n, m), -1.0)
    for i in range(n):
        xA = np.maximum(boxes_a[i, 0], boxes_b[:, 0])
        yA = np.maximum(boxes_a[i, 1], boxes_b[:, 1])
        xB = np.minimum(boxes_a[i, 2], boxes_b[:, 2])
        yB = np.minimum(boxes_a[i, 3], boxes_b[:, 3])
        iw = xB - xA + 1
        ih = yB - yA + 1
        ok = (iw > 0) & (ih > 0)
        inter = iw * ih
        area_a = (boxes_a[i, 2] - boxes_a[i, 0] + 1) * \
            (boxes_a[i, 3] - boxes_a[i, 1] + 1)
        area_b = (boxes_b[:, 2] - boxes_b[:, 0] + 1) * \
            (boxes_b[:, 3] - boxes_b[:, 1] + 1)
        iou = inter / (area_a + area_b - inter)
        out[i] = np.where(ok, iou, -1.0)
    return out


def match_bboxes(bbox_gt: np.ndarray, bbox_pred: np.ndarray,
                 iou_thresh: float = 0.5):
    """Optimal one-to-one GT<->prediction assignment above an IoU threshold.
    Returns (idx_gt, idx_pred, ious) for accepted matches."""
    import scipy.optimize
    n_true, n_pred = len(bbox_gt), len(bbox_pred)
    iou = pairwise_iou_plus_one(bbox_gt, bbox_pred)
    size = max(n_true, n_pred)
    padded = np.zeros((size, size))
    padded[:n_true, :n_pred] = iou
    idx_true, idx_pred = scipy.optimize.linear_sum_assignment(1 - padded)
    sel = (idx_true < n_true) & (idx_pred < n_pred)
    idx_true, idx_pred = idx_true[sel], idx_pred[sel]
    ious = iou[idx_true, idx_pred]
    ok = ious > iou_thresh
    return idx_true[ok], idx_pred[ok], ious[ok]


def ocr_oracle(pred_feats: Dict[str, np.ndarray],
               gt_feats: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Attach GT text to matched predicted text boxes (bbox_match.py:81-98)."""
    idx_gt, idx_pred, _ = match_bboxes(gt_feats['bboxes'],
                                       pred_feats['bboxes'], iou_thresh=0.2)
    out = {
        'bboxes': pred_feats['bboxes'][idx_pred],
        'class': pred_feats['class'][idx_pred],
        'text': np.asarray(gt_feats['text'])[idx_gt],
    }
    assert len(out['text']) == len(out['bboxes']) == len(out['class'])
    return out


def apply_ocr(image: np.ndarray, boxes: np.ndarray, classes: np.ndarray,
              cls_dict: Dict[str, int]) -> List[str]:
    """Real OCR per crop. Includes the 5px box dilation, the >=3 aspect
    vertical-tick rotation and numeric / FigureQA-color cleanup of the
    reference. Engine: pytesseract when importable (the reference's,
    extract_features.py:602), else the built-in template-matching
    fallback (detector/ocr_lite.py) so the --OCR path still runs end to
    end without the Tesseract binary."""
    try:
        import pytesseract
    except ImportError:  # no Tesseract binary in this environment
        from crct_tpu_torch.detector import ocr_lite as pytesseract
        if not getattr(apply_ocr, "_lite_notice", False):
            apply_ocr._lite_notice = True
            print("apply_ocr: pytesseract not installed - using the "
                  "built-in template OCR (crct_tpu_torch/detector/ocr_lite.py); "
                  "exact on PIL-default-font text, approximate otherwise")

    c = boxes.astype(int).copy()
    h, w = image.shape[:2]
    c[:, 0] = np.maximum(c[:, 0] - 5, 0)
    c[:, 1] = np.maximum(c[:, 1] - 5, 0)
    c[:, 2] = np.minimum(c[:, 2] + 5, w - 1)
    c[:, 3] = np.minimum(c[:, 3] + 5, h - 1)

    xticks = boxes[classes == cls_dict['xticklabel']]
    prop = 1.0
    if len(xticks) > 0:
        prop = np.median((xticks[:, 3] - xticks[:, 1])
                         / np.maximum(xticks[:, 2] - xticks[:, 0], 1e-6))

    texts: List[str] = []
    for k in range(len(boxes)):
        crop = image[c[k][1]:c[k][3], c[k][0]:c[k][2]]
        if classes[k] == cls_dict['xticklabel'] and prop >= 3:
            crop = np.rot90(crop, k=3)  # rotate vertical ticks upright
        raw = pytesseract.image_to_string(crop).split("\n")[0]
        if raw in ('\x0c', '\n\x0c', ''):
            texts.append("0")
            continue
        closest = difflib.get_close_matches(raw, COLORS_FIGUREQA)
        if closest:
            texts.append(closest[0])
            continue
        for num in (raw, raw[1:], raw[:-1], raw[1:-1]):
            try:
                float(num)
                texts.append(num)
                break
            except ValueError:
                pass
        else:
            texts.append(raw)
    return texts
