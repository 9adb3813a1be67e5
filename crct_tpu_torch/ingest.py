"""Chart-image ingestion for serving, on the card.

The port of ``crct_tpu/ingest.py``. The reference pipeline is offline:
``extract_features.py`` writes `.npy` feature shards, then the QA stage
loads them (reference Detector/extract_features.py:460-575,
CRCT/fig_dataloader.py:119-160). Serving composes the two online: a chart
arrives over HTTP, the detector and the extraction build its feature record
in-process, and the QA model answers questions about it.

``FigureIngestor`` runs the extract CLI's per-image pipeline
(cli/extract_features.py) behind one call:

    resize_shortest_edge -> normalize -> pad to the canvas ->
    detect (ONE trunk pass for the detections and the <IMG> token) ->
    boxes back to original coordinates -> inject_img_token ->
    build_feature_record

Text attachment per request: a caller-supplied chart annotation (the GT
oracle / Hungarian-matched oracle the reference evaluates with) or real
OCR over the predicted boxes when pytesseract is available. Every image
pads into the one (H, W) canvas. A lock serializes the detector's use of
the card: ingestion runs on HTTP request threads.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np


class IngestError(ValueError):
    """The image could not be turned into a usable feature record
    (no text elements detected / axes missing / annotation mismatch)."""


class FigureIngestor:
    """Image -> feature record through the detector.

    ``detector`` is the port's ``MaskRCNN`` on its device (the card unless
    it was built for the CPU). ``canvas`` is the (H, W) every image is
    padded to (multiples of 32); ``short_edge`` the test-time
    ResizeShortestEdge target (0 = only downscale oversized images to fit
    the canvas).
    """

    def __init__(self, detector, *, dataset: str = "plotqa",
                 canvas: Tuple[int, int] = (832, 1344),
                 short_edge: int = 800,
                 pixel_mean: Optional[np.ndarray] = None,
                 pixel_std: Optional[np.ndarray] = None):
        import torch

        from crct_tpu_torch.detector.coco import PIXEL_MEAN, PIXEL_STD
        from crct_tpu_torch.detector.extract import parse_canvas

        # the detector runs in fp32 at full precision, as the detector
        # trainer runs it: TF32 off for matmuls and cuDNN convolutions
        # (cuDNN's is on by default), so that the card's records match
        # the CPU's within fp32 rounding
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.canvas = parse_canvas(f"{int(canvas[0])},{int(canvas[1])}")
        self.detector = detector.eval()
        self.dataset = dataset
        self.short_edge = int(short_edge)
        self.pixel_mean = np.asarray(
            PIXEL_MEAN if pixel_mean is None else pixel_mean, np.float32)
        self.pixel_std = np.asarray(
            PIXEL_STD if pixel_std is None else pixel_std, np.float32)
        self._lock = threading.Lock()

    @classmethod
    def from_weights(cls, weights_path: str, *, dataset: str = "plotqa",
                     num_classes: int = 228,
                     canvas: Tuple[int, int] = (832, 1344),
                     short_edge: int = 800, device="cuda"
                     ) -> "FigureIngestor":
        """Production constructor: the detector's geometry and the
        preprocessing conventions derived from the weights file, as the
        extract CLI derives them (cli/extract_features.py)."""
        from crct_tpu_torch.detector.extract import detector_from_weights
        model, pixel_mean, pixel_std = detector_from_weights(
            weights_path, dataset=dataset, num_classes=num_classes,
            canvas=canvas, device=device)
        return cls(model, dataset=dataset, canvas=canvas,
                   short_edge=short_edge, pixel_mean=pixel_mean,
                   pixel_std=pixel_std)

    def warmup(self) -> None:
        """One detect on a blank canvas before traffic is accepted: cuDNN
        picks its convolution algorithms and the allocator warms up."""
        from crct_tpu_torch.detector.extract import detect
        h, w = self.canvas
        with self._lock:
            detect(self.detector, np.zeros((1, h, w, 3), np.float32),
                   [[h, w]])

    def ingest(self, image, image_id: int, *,
               annotation: Optional[Dict[str, Any]] = None,
               ocr_mode: Optional[str] = None) -> Dict[str, Any]:
        """Run the full extraction pipeline on one image.

        ``image``: PIL image or HxWx3 uint8/float array (RGB).
        ``annotation``: the chart's GT annotation dict (the reference's
        annotations.json entry) for 'gt'/'oracle' text attachment.
        ``ocr_mode``: 'gt' | 'oracle' | 'ocr'; defaults to 'oracle' when an
        annotation is supplied, else 'ocr' (requires pytesseract).
        Returns the feature record `.npy` shards carry; raises IngestError
        when the chart yields no usable record.
        """
        from crct_tpu_torch.detector.extract import (detect, get_gt_texts,
                                                     get_nonvis_ids,
                                                     pad_image,
                                                     record_from_detection)

        if ocr_mode is None:
            ocr_mode = "oracle" if annotation is not None else "ocr"
        if ocr_mode not in ("gt", "oracle", "ocr"):
            raise IngestError(f"unknown ocr_mode {ocr_mode!r}: expected "
                              f"'gt', 'oracle' or 'ocr'")
        if ocr_mode in ("gt", "oracle") and annotation is None:
            raise IngestError(f"ocr_mode={ocr_mode!r} needs a chart "
                              f"annotation; supply one or use real OCR")
        if ocr_mode == "ocr":
            try:
                import pytesseract  # noqa: F401
            except ImportError:
                raise IngestError(
                    "ocr_mode='ocr' needs pytesseract; it is not "
                    "installed — supply an annotation for oracle mode")

        raw = np.asarray(getattr(image, "convert", lambda _m: image)("RGB"),
                         np.float32)
        if raw.ndim != 3 or raw.shape[2] != 3:
            raise IngestError(f"expected an RGB image, got {raw.shape}")
        padded, resized_hw = pad_image(raw, self.canvas, self.short_edge,
                                       self.pixel_mean, self.pixel_std)
        with self._lock:
            [(out, img_feat)] = detect(self.detector, padded[None],
                                       [resized_hw])

        gt_texts = None
        if annotation is not None and ocr_mode != "ocr":
            _, cls_dict = get_nonvis_ids(self.dataset)
            gt_texts = get_gt_texts(annotation, cls_dict, self.dataset)
        record = record_from_detection(
            int(image_id), out, img_feat, raw.shape[:2], resized_hw,
            dataset=self.dataset, gt_texts=gt_texts, ocr_mode=ocr_mode,
            image=raw.astype(np.uint8) if ocr_mode == "ocr" else None)
        if record["vis_feat"] is None:
            raise IngestError(
                "chart yielded no usable record (no text elements "
                "detected or axes could not be derived)")
        return record
