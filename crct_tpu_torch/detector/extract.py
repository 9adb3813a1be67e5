"""Chart feature extraction: detections -> `.npy` records for the QA stage.

The port of ``crct_tpu/detector/extract.py`` (the reference's offline
extractor, Detector/extract_features.py): detect elements, inject the
whole-image ``<IMG>`` token as element 0 (class 1000, score 1), split
detections into textual vs visual classes, attach text via the GT oracle /
Hungarian OCR oracle / real OCR, derive axes geometry (with fallback
synthesis when an axis isn't detected), normalize tick positions and visual
boxes to unit R^2 axes coordinates, handle pie charts by circle geometry and
DVQA axes by parsing tick values, and write chunked `.npy` shards with range
resume.

The detector forward runs on the card (:func:`detect`: one trunk pass
yields the detections and the <IMG> feature); everything else in this
module is host-side numpy over its outputs, as the reference keeps OCR and
geometry on the CPU.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from crct_tpu_torch.detector.ocr import apply_ocr, ocr_oracle
from crct_tpu_torch.detector.pie import Point, get_pie_areas

IMG_TOKEN_CLASS = 1000


# ---------------------------------------------------------------------------
# dataset class dictionaries (reference get_nonvis_ids,
# extract_features.py:369-389)
# ---------------------------------------------------------------------------

def get_nonvis_ids(dataset: str):
    if dataset == "plotqa":
        cls_dict = {'legend_label': 0, 'title': 1, 'xlabel': 2,
                    'xticklabel': 3, 'ylabel': 4, 'yticklabel': 5,
                    'x_axis': 6, 'y_axis': 7}
        return np.arange(8), cls_dict
    if dataset == "plotqa_colorless":
        cls_dict = {'legend_label': 2, 'title': 5, 'xlabel': 6,
                    'xticklabel': 7, 'ylabel': 8, 'yticklabel': 9,
                    'x_axis': 10, 'y_axis': 11}
        return np.array([2, 5, 6, 7, 8, 9, 10, 11]), cls_dict
    if dataset == "figure_qa":
        cls_dict = {'legend_label': 6, 'title': None, 'xlabel': 2,
                    'xticklabel': 1, 'ylabel': 5, 'yticklabel': 4,
                    'x_axis': 0, 'y_axis': 3}
        return np.arange(8), cls_dict
    if dataset == "dvqa":
        cls_dict = {'legend_label': np.arange(4, 62), 'title': 2,
                    'xlabel': None, 'xticklabel': 0, 'ylabel': 1,
                    'yticklabel': 3, 'x_axis': None, 'y_axis': None}
        return np.arange(62), cls_dict
    raise ValueError(dataset)


# ---------------------------------------------------------------------------
# axes geometry
# ---------------------------------------------------------------------------

def validate_both_axes(axes_boxes: Dict[str, np.ndarray], boxes: np.ndarray,
                       img_path: str = "", verbose: bool = True
                       ) -> Optional[bool]:
    """Ensure both axis rules exist; synthesize missing ones from detection
    extents (extract_features.py:154-179). Returns None when neither axis was
    detected (pie-chart signal), False when one was synthesized, True when
    both were detected."""
    x_missing = len(axes_boxes['x_axis']) == 0
    y_missing = len(axes_boxes['y_axis']) == 0
    if x_missing and y_missing:
        if verbose:
            print("Warning: No axes were detected!", img_path)
        axes_boxes['x_axis'] = np.array([np.min(boxes[:, 0]),
                                         np.max(boxes[:, 1]),
                                         np.max(boxes[:, 2]),
                                         np.max(boxes[:, 1])])
        axes_boxes['y_axis'] = np.array([np.min(boxes[:, 0]),
                                         np.min(boxes[:, 1]),
                                         np.min(boxes[:, 0]),
                                         np.max(boxes[:, 3])])
        return None
    if x_missing:
        axes_boxes['y_axis'] = axes_boxes['y_axis'][0]
        y = axes_boxes['y_axis']
        axes_boxes['x_axis'] = np.array([(y[0] + y[2]) / 2, y[3],
                                         np.max(boxes[:, 2]), y[3]])
        return False
    if y_missing:
        axes_boxes['x_axis'] = axes_boxes['x_axis'][0]
        x = axes_boxes['x_axis']
        axes_boxes['y_axis'] = np.array([x[0], np.max(boxes[:, 1]),
                                         x[0], (x[1] + x[3]) / 2])
        return False
    axes_boxes['x_axis'] = axes_boxes['x_axis'][0]
    axes_boxes['y_axis'] = axes_boxes['y_axis'][0]
    return True


def get_axes_info(axes_boxes: Dict[str, Any], ocr_output: Dict[str, Any],
                  cls_dict: Dict[str, Any], img_path: str = "",
                  dataset: str = "plotqa") -> Dict[str, Any]:
    """Axis rule geometry + tick (text, normalized-position) pairs
    (extract_features.py:257-309)."""
    info: Dict[str, Any] = {'x_axis': {}, 'y_axis': {},
                            'values_are_x': axes_boxes.get('values_are_x',
                                                           False)}
    for ax in ('x_axis', 'y_axis'):
        b = axes_boxes[ax]
        bbox = {'x': b[0], 'y': b[1], 'w': b[2] - b[0], 'h': b[3] - b[1]}
        info[ax]['x'] = bbox['x'] + bbox['w'] / 2
        info[ax]['y'] = bbox['y'] + bbox['h'] / 2
        info[ax]['w'] = bbox['w']
        info[ax]['h'] = bbox['h']

    for ax in ('x_axis', 'y_axis'):
        ticks = _class_mask(ocr_output['class'], cls_dict[f"{ax[0]}ticklabel"])
        tick_boxes = ocr_output['bboxes'][ticks]
        horizontal = ((ax == 'x_axis' and not info['values_are_x'])
                      or (ax == 'y_axis' and info['values_are_x']))
        c2, c1 = (2, 0) if horizontal else (3, 1)
        vals = (tick_boxes[:, c2] + tick_boxes[:, c1]) / 2
        if horizontal:
            vals = (vals - info['y_axis']['x']) / max(info['x_axis']['w'], 1e-9)
        else:
            vals = (info['x_axis']['y'] - vals) / max(info['y_axis']['h'], 1e-9)
        texts = list(np.asarray(ocr_output['text'])[ticks])
        if dataset == 'dvqa' and texts and 'mathdefault' in str(texts[0]):
            texts = [_mathdefault_to_sci(t) for t in texts]
        info[ax]['ticks'] = sorted(zip(texts, vals), key=lambda t: t[1])
        labels = np.asarray(ocr_output['text'])[
            _class_mask(ocr_output['class'], cls_dict[f"{ax[0]}label"])]
        if len(labels) > 0:
            info[ax]['label'] = labels[0]
        else:
            info[ax]['label'] = ""
            if 'plotqa' in dataset:
                print(f"Warning: no {ax} label was found. {img_path}")
    return info


def _class_mask(classes: np.ndarray, cls) -> np.ndarray:
    if cls is None:
        return np.zeros(len(classes), bool)
    if isinstance(cls, np.ndarray):
        return np.isin(classes, cls)
    return classes == cls


def _mathdefault_to_sci(val: str) -> str:
    m = re.findall(r'(-?[0-9]+)\^{(-?[0-9]+)}', val)
    if m:
        b, e = m[0]
        return f"{b}e{e}"
    return val


def get_title_legends(axes_info: Dict[str, Any], ocr_output: Dict[str, Any],
                      cls_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Title text/box + legend labels/boxes, normalized
    (extract_features.py:312-336)."""
    out: Dict[str, Any] = {}
    title_mask = _class_mask(ocr_output['class'], cls_dict.get('title'))
    titles = np.asarray(ocr_output['text'])[title_mask]
    if len(titles) > 0:
        bbox = ocr_output['bboxes'][title_mask][0]
        out['title'] = {'text': titles[0],
                        'bbox': normalize_bbox(bbox[None], axes_info)[0]}
    legend_mask = _class_mask(ocr_output['class'], cls_dict['legend_label'])
    labels = np.asarray(ocr_output['text'])[legend_mask]
    if len(labels) > 0:
        out['legend'] = {
            'label': labels,
            'bbox': normalize_bbox(ocr_output['bboxes'][legend_mask],
                                   axes_info),
        }
    return out


def normalize_bbox(bbox: np.ndarray, info: Dict[str, Any]) -> np.ndarray:
    """Image coordinates -> unit R^2 axes coordinates
    (extract_features.py:354-366): x relative to the y-axis rule / x width,
    y flipped about the x-axis rule / y height."""
    bbox = bbox.astype(np.float32).copy()
    bbox[:, 0] = (bbox[:, 0] - info['y_axis']['x']) / info['x_axis']['w']
    bbox[:, 2] = (bbox[:, 2] - info['y_axis']['x']) / info['x_axis']['w']
    bbox[:, 1] = (info['x_axis']['y'] - bbox[:, 1]) / info['y_axis']['h']
    bbox[:, 3] = (info['x_axis']['y'] - bbox[:, 3]) / info['y_axis']['h']
    return bbox


def dvqa_axes(cls_dict, oracle_ocr, vis_boxes):
    """Infer DVQA axis rules from numeric tick text (the dataset has no axis
    detections; extract_features.py:392-444). Returns (zero_loc, axes_boxes)
    or None when no tick parses as a number."""
    ytick_mask = _class_mask(oracle_ocr['class'], cls_dict['yticklabel'])
    xtick_mask = _class_mask(oracle_ocr['class'], cls_dict['xticklabel'])
    values = np.asarray(oracle_ocr['text'])[ytick_mask]
    yboxes = oracle_ocr['bboxes'][ytick_mask]
    zero = np.array([0, 0, 0, 0], np.float32)
    y_ticks, is_value = [], np.ones(len(values), bool)
    for i, t in enumerate(values):
        t = _mathdefault_to_sci(str(t))
        try:
            v = float(str(t).replace("−", "-"))
            y_ticks.append(v)
            if v == 0:
                zero = yboxes[i]
        except ValueError:
            is_value[i] = False
            print(f"\t   failed to float() this: {t}")
    if not y_ticks:
        return None
    low_i, high_i = int(np.argmin(y_ticks)), int(np.argmax(y_ticks))
    low = yboxes[is_value][low_i]
    high = yboxes[is_value][high_i]
    xboxes = oracle_ocr['bboxes'][xtick_mask]
    if high[0] - low[0] >= 50:
        # numeric ticks run horizontally: values are on the x axis
        h = (low[3] - low[1]) / 2
        z = (zero[0] + zero[2]) / 2
        y_start = np.max(xboxes[:, 2]) if z == 0 else z
        a = (np.min(vis_boxes[1:, 1]) if len(vis_boxes) > 1
             else np.min(xboxes[:, 1]))
        y_axis = np.array([[y_start - 5, a, y_start + 5, low[1] - h]])
        x_axis = np.array([[y_start, low[1] - h,
                            (high[0] + high[2]) / 2, high[3] - h]])
        return z, {'x_axis': x_axis, 'y_axis': y_axis, 'values_are_x': True}
    w = (high[2] - high[0]) / 2
    if (zero[1] + zero[2]) / 2 > 0:
        low = zero
    z = (zero[1] + zero[2]) / 2
    a = (np.max(vis_boxes[1:, 3]) if len(vis_boxes) > 1
         else np.max(xboxes[:, 3]))
    b = (np.max(vis_boxes[1:, 2]) if len(vis_boxes) > 1
         else np.max(xboxes[:, 3]))
    x_axis = np.array([[low[2], low[1] if min(y_ticks) <= 0 else (a - 5), b,
                        low[3] if min(y_ticks) <= 0 else (a + 5)]])
    y_axis = np.array([[high[0] + w, (high[1] + high[3]) / 2, high[2] + w,
                        (x_axis[0][1] + x_axis[0][3]) / 2]])
    return z, {'x_axis': x_axis, 'y_axis': y_axis, 'values_are_x': False}


# ---------------------------------------------------------------------------
# GT text collection (oracle mode; extract_features.py:182-254)
# ---------------------------------------------------------------------------

def get_gt_texts(annotation: Dict[str, Any], cls_dict: Dict[str, Any],
                 dataset: str = "plotqa") -> Dict[str, np.ndarray]:
    """Collect GT texts/boxes/classes from a PlotQA/FigureQA/DVQA annotation."""
    bboxes, texts, classes = [], [], []
    if dataset == 'dvqa':
        for text in annotation['texts']:
            if text['text_function'] == 'legend_heading':
                continue
            box = text['bbox']
            if text['text_function'] == 'legend':
                leg = 10 + box[2] / 2
                box = [box[0] - leg, box[1], box[2] + leg, box[3]]
            bboxes.append([box[0] + 10, box[1] + 10,
                           box[0] + box[2] - 10, box[1] + box[3] - 10])
            texts.append(text['text'])
        return {'bboxes': np.asarray(bboxes), 'text': np.asarray(texts)}

    gfi = annotation['general_figure_info']
    if dataset != 'figure_qa':
        bbox = gfi['title']['bbox']
        bboxes.append([bbox['x'], bbox['y'],
                       bbox['x'] + bbox['w'], bbox['y'] + bbox['h']])
        texts.append(gfi['title']['text'])
        classes.append(cls_dict['title'])
    for ax in ('x_axis', 'y_axis'):
        if ax not in gfi:
            continue
        labels = gfi[ax]['major_labels']['values']
        ticks = gfi[ax]['major_labels']['bboxes'][: len(labels) // 2]
        assert labels[: len(labels) // 2] == labels[len(labels) // 2:]
        labels = labels[: len(labels) // 2]
        texts += labels
        bboxes += [[b['x'], b['y'], b['x'] + b['w'], b['y'] + b['h']]
                   for b in ticks]
        classes += [cls_dict[ax[0] + 'ticklabel']] * len(labels)
        if dataset != 'figure_qa':
            texts.append(gfi[ax]['label']['text'])
            b = gfi[ax]['label']['bbox']
            bboxes.append([b['x'], b['y'], b['x'] + b['w'], b['y'] + b['h']])
            classes.append(cls_dict[ax[0] + 'label'])
    if 'legend' in gfi:
        for item in gfi['legend']['items']:
            b = item['label']['bbox']
            bboxes.append([b['x'], b['y'], b['x'] + b['w'], b['y'] + b['h']])
            texts.append(item['label']['text'])
            classes.append(cls_dict['legend_label'])
    return {'bboxes': np.asarray(bboxes), 'text': np.asarray(texts),
            'class': np.asarray(classes)}


# ---------------------------------------------------------------------------
# detection -> record
# ---------------------------------------------------------------------------

def resize_shortest_edge(h: int, w: int, short_edge: int,
                         max_size) -> Tuple[int, int]:
    """Detectron2 ResizeShortestEdge target shape: scale so the short edge
    hits ``short_edge``, capped so the image fits ``max_size`` — an int
    (square canvas, the MAX_SIZE_TEST semantics) or an (H, W) canvas
    (INPUT.MIN_SIZE_TEST/MAX_SIZE_TEST; the reference resizes every image
    through predictor.aug before detection, extract_features.py:38-44).
    ``short_edge=0`` only downscales oversized images to fit the canvas."""
    mh, mw = (max_size, max_size) if isinstance(max_size, int) else max_size
    scale = (short_edge / min(h, w)) if short_edge else 1.0
    scale = min(scale, mh / h, mw / w)
    return (max(1, min(mh, int(h * scale + 0.5))),
            max(1, min(mw, int(w * scale + 0.5))))


def parse_canvas(spec) -> Tuple[int, int]:
    """'N' or 'H,W' -> (H, W), validated against the FPN's /32 strides.
    Raises ValueError with a user-facing message (CLIs wrap it in
    p.error; the server maps it to HTTP 400)."""
    try:
        dims = [int(x) for x in str(spec).split(",")]
    except ValueError:
        raise ValueError(f"canvas must be N or H,W, got {spec!r}")
    if len(dims) == 1:
        dims = dims * 2
    if len(dims) != 2:
        raise ValueError(f"canvas must be N or H,W, got {spec!r}")
    if dims[0] % 32 or dims[1] % 32:
        raise ValueError(f"canvas dims must be multiples of 32 "
                         f"(FPN strides), got {dims[0]}x{dims[1]}")
    return dims[0], dims[1]


def resolve_depth(cli_depth: int, meta: Dict[str, Any], dataset: str,
                  weights_path: str = "") -> int:
    """The ResNet trunk depth: an explicit CLI value must agree with the
    weights file's recorded or derived depth (a mismatch would transfer
    only the matching prefix and leave deeper blocks random), else the
    file's depth wins, else the dataset rule (R101 for figure_qa, reference
    frcnn.py:137-155)."""
    file_depth = meta.get("depth")
    if cli_depth and file_depth and cli_depth != file_depth:
        raise ValueError(
            f"--depth {cli_depth} does not match the R{file_depth} trunk "
            f"recorded in {weights_path!r}; loading would transfer only "
            f"the matching prefix and leave deeper blocks randomly "
            f"initialized. Drop --depth (it is derived from the weights) "
            f"or point at matching weights.")
    return cli_depth or file_depth or (101 if dataset == "figure_qa" else 50)


def detector_from_weights(weights_path: str, *, dataset: str,
                          num_classes: int, canvas: Tuple[int, int],
                          depth: int = 0, score_thresh: float = 0.5,
                          seed: int = 0, device="cuda"):
    """Build the extraction detector on ``device`` (the card unless the
    caller asks for the CPU) from a weights file, deriving the trunk's
    depth and stride convention and the pixel normalization from its layout
    (detector/convert.py). ``weights_path='none'`` keeps random weights
    drawn from ``seed``. ``canvas`` is the (H, W) every image is padded to
    (multiples of 32). Returns (model in eval mode, pixel_mean, pixel_std):
    the shared setup of the extract CLI and the serving ingestor."""
    import torch

    from crct_tpu_torch.detector.convert import (detector_file_meta,
                                                 restore_detector_params)
    from crct_tpu_torch.detector.mask_rcnn import (MaskRCNN,
                                                   init_detector_weights)
    from crct_tpu_torch.utils.device import resolve_device

    parse_canvas(f"{int(canvas[0])},{int(canvas[1])}")
    device = resolve_device(device)
    meta = detector_file_meta(weights_path if weights_path != "none" else "")
    depth = resolve_depth(depth, meta, dataset, weights_path)
    model = MaskRCNN(num_classes=num_classes, with_mask=dataset == "plotqa",
                     depth=depth, stride_in_1x1=meta["stride_in_1x1"],
                     score_thresh_test=score_thresh)
    if weights_path == "none":
        init_detector_weights(model, torch.Generator().manual_seed(seed))
    else:
        restore_detector_params(model, weights_path)
    return (model.to(device).eval(),
            np.asarray(meta["pixel_mean"], np.float32),
            np.asarray(meta["pixel_std"], np.float32))


def detect(detector, padded_images: np.ndarray, hws: Sequence[Sequence[float]]
           ) -> List[Tuple[Dict[str, np.ndarray], np.ndarray]]:
    """ONE trunk/FPN pass over a group of padded [B, H, W, 3] images on the
    detector's device: each image's detections (no mask branch) and its
    <IMG> whole-image token feature, pooled over the REAL image extent
    [0, 0, w, h] (the reference pools the original image box,
    extract_features.py:54-72, not the zero-padded canvas). ``hws`` holds
    each resized image's [h, w]. Returns per-image (numpy outputs,
    img_feat)."""
    import torch

    device = next(detector.parameters()).device
    hw = np.asarray(hws, np.float32).reshape(-1, 2)
    img_box = np.zeros((len(hw), 1, 4), np.float32)
    img_box[:, 0, 2], img_box[:, 0, 3] = hw[:, 1], hw[:, 0]
    images = torch.from_numpy(np.ascontiguousarray(padded_images,
                                                   np.float32))
    with torch.inference_mode():
        out = detector.detect_with_roi_features(
            images.to(device), torch.from_numpy(img_box).to(device))
        out = {k: v.cpu().numpy() for k, v in out.items()}
    img_feat = out.pop("roi_features")[:, 0]
    return [({k: v[j] for k, v in out.items()}, img_feat[j])
            for j in range(len(hw))]


def batched_detect(detector, padded_images: Sequence[np.ndarray],
                   infer_batch: int, hws: Sequence[Sequence[float]]
                   ) -> List[Tuple[Dict[str, np.ndarray], np.ndarray]]:
    """:func:`detect` over padded [H, W, 3] images in groups of
    ``infer_batch``, one trunk pass and one host fetch per group. The last
    group runs at its own size (the JAX package pads it with its last image
    to keep one compiled shape; the records are the same either way).
    Returns per-image (outputs, img_feat) in input order: the shared inner
    loop of the extract CLI and the chip smoke run."""
    results = []
    for s in range(0, len(padded_images), infer_batch):
        results.extend(detect(detector,
                              np.stack(padded_images[s:s + infer_batch]),
                              hws[s:s + infer_batch]))
    return results


def pad_image(raw: np.ndarray, canvas: Tuple[int, int], short_edge: int,
              pixel_mean: np.ndarray, pixel_std: np.ndarray
              ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """An RGB image [h0, w0, 3] (float, 0..255) as the detector takes it:
    test-time ResizeShortestEdge (PIL bilinear, only when the size changes;
    the reference resizes through predictor.aug, extract_features.py:38-44),
    normalized, zero-padded into the (H, W) canvas. Returns the canvas and
    the resized [h, w]."""
    h0, w0 = raw.shape[:2]
    nh, nw = resize_shortest_edge(h0, w0, short_edge, canvas)
    if (nh, nw) != (h0, w0):
        from PIL import Image
        raw = np.asarray(Image.fromarray(raw.astype(np.uint8)).resize(
            (nw, nh), Image.BILINEAR), np.float32)
    padded = np.zeros((*canvas, 3), np.float32)
    padded[:nh, :nw] = (raw - pixel_mean) / pixel_std
    return padded, (nh, nw)


def record_from_detection(image_id: int, out: Dict[str, np.ndarray],
                          img_feat: np.ndarray, img_hw: Tuple[int, int],
                          resized_hw: Tuple[int, int], *, dataset: str,
                          gt_texts: Optional[Dict[str, Any]] = None,
                          ocr_mode: str = "oracle",
                          image: Optional[np.ndarray] = None
                          ) -> Dict[str, Any]:
    """One image's :func:`detect` outputs -> its feature record: the valid
    detections' boxes scaled from the resized image back to the original
    ``img_hw`` (as Detectron2's _postprocess does), the <IMG> token
    injected, then :func:`build_feature_record`. The shared tail of the
    extract CLI and the serving ingestor."""
    (h, w), (nh, nw) = img_hw, resized_hw
    valid = out["valid"]
    boxes = out["boxes"][valid] * np.asarray(
        [w / nw, h / nh, w / nw, h / nh], np.float32)
    feats, classes, boxes = inject_img_token(
        out["features"][valid], out["classes"][valid], boxes, img_feat,
        (h, w))
    return build_feature_record(image_id, feats, classes, boxes, (h, w),
                                dataset=dataset, gt_texts=gt_texts,
                                ocr_mode=ocr_mode, image=image)


def build_feature_record(image_id: int, feats: np.ndarray,
                         classes: np.ndarray, boxes: np.ndarray,
                         img_shape: Tuple[int, int], *, dataset: str,
                         gt_texts: Optional[Dict[str, Any]] = None,
                         ocr_mode: str = "oracle",
                         image: Optional[np.ndarray] = None,
                         verbose: Optional[bool] = None
                         ) -> Dict[str, Any]:
    """Assemble one `.npy` feature record from detector outputs.

    Inputs include the injected <IMG> token at row 0 (class 1000). ocr_mode:
    'gt' (pure oracle), 'oracle' (Hungarian-matched GT text on predicted
    boxes), 'ocr' (real OCR over predicted boxes). ``img_shape`` is the
    ORIGINAL image (h, w); the record stores width=w / height=h. (The
    reference writes the *resized* tensor's (H, W) swapped into these
    fields, extract_features.py:573-574 — no consumer ever reads them, so
    we standardize on the repo-wide convention instead.)
    """
    if dataset == 'dvqa' and ocr_mode == 'gt':
        # DVQA GT annotations carry no class labels (get_gt_texts returns
        # bboxes/text only), and dvqa_axes needs classes to find the ticks.
        # The reference crashes here too (KeyError -> assert False,
        # extract_features.py:503-510); fail with a real message instead.
        raise ValueError(
            "dvqa does not support --ocr-gt: DVQA GT annotations have no "
            "class labels. Use oracle mode (Hungarian-matched) or --OCR.")
    txt_cls_ids, cls_dict = get_nonvis_ids(dataset)
    n = len(boxes)
    ax_x, ax_y = cls_dict['x_axis'], cls_dict['y_axis']

    def is_axis(c):
        return (ax_x is not None and c == ax_x) or \
            (ax_y is not None and c == ax_y)

    if dataset == 'figure_qa':
        non_vis = np.array([i for i in range(n)
                            if classes[i] in txt_cls_ids
                            and not is_axis(classes[i])
                            and classes[i] != 7])
    else:
        non_vis = np.array([i for i in range(n)
                            if classes[i] in txt_cls_ids
                            and not is_axis(classes[i])])
    vis = np.array([i for i in range(n)
                    if classes[i] not in txt_cls_ids
                    and not is_axis(classes[i])])
    if dataset == 'dvqa':
        legend = np.array([i for i in range(n)
                           if classes[i] in cls_dict['legend_label']],
                          dtype=np.int64)
        vis = np.concatenate([vis, legend])

    empty = {"image_id": image_id, "vis_feat": None, "vis_bbox": None,
             "class": None, "text_feat": None, "width": None, "height": None}
    if len(non_vis) == 0 and ocr_mode != 'gt':
        return empty

    # --- text attachment -------------------------------------------------
    if ocr_mode == 'ocr':
        oracle = {'bboxes': boxes[non_vis], 'class': classes[non_vis]}
        oracle['text'] = np.asarray(apply_ocr(image, boxes[non_vis],
                                              classes[non_vis], cls_dict))
    elif ocr_mode == 'gt':
        oracle = gt_texts
    else:
        oracle = ocr_oracle({'bboxes': boxes[non_vis],
                             'class': classes[non_vis]}, gt_texts)

    # --- axes -------------------------------------------------------------
    if dataset == 'dvqa':
        res = dvqa_axes(cls_dict, oracle, boxes[vis] if len(vis) else boxes)
        if res is None:
            return empty
        _, axes_boxes = res
    else:
        axes_boxes = {'x_axis': boxes[_class_mask(classes, ax_x)],
                      'y_axis': boxes[_class_mask(classes, ax_y)],
                      'values_are_x': False}

    axes_ok = validate_both_axes(
        axes_boxes, boxes, str(image_id),
        verbose='plotqa' in dataset if verbose is None else verbose)
    if axes_ok is None and dataset == 'figure_qa':
        # probably a pie chart: normalize by circle center/radius
        areas, center, r = get_pie_areas(boxes[vis][1:])
        if r is None:
            pie_box = boxes[classes == 7][0]
            r = ((pie_box[2] - pie_box[0]) + (pie_box[3] - pie_box[1])) / 4
            center = Point((pie_box[2] + pie_box[0]) / 2,
                           (pie_box[3] + pie_box[1]) / 2)
        axes_by_radius = {'x_axis': {'y': center.y, 'w': r},
                          'y_axis': {'x': center.x, 'h': r}}
        text_feat = get_title_legends(axes_by_radius, oracle, cls_dict)
        feats_v, classes_v, boxes_v = feats[vis], classes[vis], boxes[vis].copy()
        boxes_v[:, 0] = (boxes_v[:, 0] - center.x) / r
        boxes_v[:, 2] = (boxes_v[:, 2] - center.x) / r
        boxes_v[:, 1] = (center.y - boxes_v[:, 1]) / r
        boxes_v[:, 3] = (center.y - boxes_v[:, 3]) / r
        text_feat['pie'] = {'areas': areas, 'radius': r}
    else:
        axes_info = get_axes_info(axes_boxes, oracle, cls_dict,
                                  str(image_id), dataset)
        text_feat = {**axes_info, **get_title_legends(axes_info, oracle,
                                                      cls_dict)}
        feats_v, classes_v = feats[vis], classes[vis]
        boxes_v = normalize_bbox(boxes[vis], text_feat)

    return {"image_id": image_id,
            "vis_feat": np.asarray(feats_v, np.float32),
            "vis_bbox": boxes_v,
            "class": np.asarray(classes_v),
            "text_feat": text_feat,
            "width": img_shape[1],
            "height": img_shape[0]}


def inject_img_token(feats: np.ndarray, classes: np.ndarray,
                     boxes: np.ndarray, img_feat: np.ndarray,
                     img_hw: Tuple[int, int]):
    """Prepend the whole-image <IMG> element (class 1000, full-image box;
    extract_features.py:54-98)."""
    h, w = img_hw
    feats = np.concatenate([img_feat[None], feats])
    classes = np.concatenate([[IMG_TOKEN_CLASS], classes])
    boxes = np.concatenate([[[0, 0, w, h]], boxes]).astype(np.float32)
    return feats, classes, boxes


def chunk_gen(lst: Sequence[Any], chunk_size: int,
              chunk_range: Optional[str] = None):
    """Chunk generator with `a:b` range resume (extract_features.py:630-639)."""
    bounds = None
    if chunk_range:
        bounds = [int(x) for x in chunk_range.split(":")]
    for c_id, k in enumerate(range(0, len(lst), chunk_size)):
        if bounds and not (bounds[0] <= c_id < bounds[1]):
            continue
        yield c_id, lst[k: k + chunk_size]


def sorted_image_files(png_dir: str) -> List[str]:
    files = glob.glob(os.path.join(png_dir, "*.png"))
    return sorted(files, key=lambda x: float(re.findall(r"(\d+)", x)[-1]))


def path_to_img_id(path: str) -> int:
    return int(os.path.basename(path).split(".")[0])
