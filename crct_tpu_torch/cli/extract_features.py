"""Feature extraction entry point of the PyTorch port (reference
Detector/extract_features.py; the port of
``crct_tpu/cli/extract_features.py``).

Runs the detector on the card unless ``--device cpu`` is given:

    python -m crct_tpu_torch.cli.extract_features --load-weights det.ckpt \\
        --dir-path data/PlotQA/ --split train --output out/ \\
        --batch-size 64 [--chunk a:b] [--ocr-gt | --OCR] --dataset plotqa

``--cuda-num N`` picks the card. The flags are the JAX CLI's. Per image:
resize, normalize and pad to the canvas, detect in groups of
``--infer-batch`` (one trunk pass gives the detections and the <IMG>
whole-image feature), attach text (GT oracle / Hungarian oracle / real
OCR), derive axes and normalize geometry, then append to chunked `.npy`
shards with ``--chunk`` range resume. The shards are the JAX CLI's. The
detector runs in fp32 with TF32 off. PNGs are decoded with PIL.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from crct_tpu_torch.utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Extract chart features")
    p.add_argument('--dir-path', type=str, default="")
    p.add_argument('--load-weights', type=str, required=True,
                   help="a port or JAX detector checkpoint, a torch "
                        ".pth/.bin, a "
                        "Detectron2 .pkl, or 'none' for random weights")
    p.add_argument('--split', type=str, default="train")
    p.add_argument('--output', type=str, required=True)
    p.add_argument('--batch-size', type=int, required=True,
                   help="images per output shard (chunk size)")
    p.add_argument('--chunk', type=str, default=None, help="resume range a:b")
    p.add_argument('--ocr-gt', action="store_true", help="pure GT-oracle text")
    p.add_argument('--OCR', action="store_true", help="real OCR (pytesseract)")
    p.add_argument('--dataset', type=str, default='plotqa',
                   choices=['figure_qa', 'plotqa', 'dvqa'])
    p.add_argument('--num-classes', type=int, default=228)
    p.add_argument('--image-size', type=str, default="1344",
                   help="the canvas every image is padded to: one number "
                        "(square) or 'H,W' (e.g. '832,1344' for landscape "
                        "charts at short-edge 800); dims must be multiples "
                        "of 32 (FPN strides)")
    p.add_argument('--short-edge', type=int, default=800,
                   help="test-time ResizeShortestEdge target (Detectron2 "
                        "INPUT.MIN_SIZE_TEST; the reference resizes via "
                        "predictor.aug, extract_features.py:38-44). Capped "
                        "so the image fits the --image-size canvas. 0 "
                        "disables resizing (oversized images are then "
                        "downscaled to fit rather than cropped).")
    p.add_argument('--infer-batch', type=int, default=8,
                   help="images per trunk pass")
    p.add_argument('--depth', type=int, default=0, choices=[0, 14, 50, 101],
                   help="ResNet trunk depth (default 0 = derived from the "
                        "weights file, else the dataset rule: R101 for "
                        "figure_qa, R50 otherwise); an explicit value that "
                        "contradicts the weights file is an error")
    p.add_argument('--score-thresh', type=float, default=0.5,
                   help="detection score cut (reference SCORE_THRESH_TEST "
                        "0.5, Detector/frcnn.py:133). Lower it for weakly "
                        "trained detectors whose text classes would "
                        "otherwise all fall below the cut")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--cuda-num", type=int, default=-1,
                   help="which card (default: the current one)")
    args = p.parse_args(argv)
    if args.dataset == 'dvqa' and args.ocr_gt:
        p.error("dvqa does not support --ocr-gt: DVQA GT annotations have "
                "no class labels (the reference crashes on this path too, "
                "extract_features.py:503-510). Use oracle mode or --OCR.")
    from crct_tpu_torch.detector.extract import parse_canvas
    try:
        args.canvas = parse_canvas(args.image_size)
    except ValueError as exc:
        p.error(f"--image-size: {exc}")
    return args


def main(argv=None):
    args = parse_args(argv)
    device = args.device
    if device == "cuda" and args.cuda_num >= 0:
        device = f"cuda:{args.cuda_num}"
    device = resolve_device(device)

    import torch
    from PIL import Image

    from crct_tpu_torch.detector.extract import (batched_detect, chunk_gen,
                                                 detector_from_weights,
                                                 get_gt_texts, get_nonvis_ids,
                                                 pad_image, path_to_img_id,
                                                 record_from_detection,
                                                 sorted_image_files)

    # fp32 at full precision, as the ingestor and the detector trainer run
    # the detector: TF32 off (cuDNN's is on by default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    canvas_h, canvas_w = args.canvas
    ann_path = os.path.join(args.dir_path, args.split, "annotations.json")
    gt_ann = None
    if os.path.isfile(ann_path):
        print(f"Reading ground [{args.split}] annotations...")
        with open(ann_path) as f:
            gt_ann = json.load(f)

    # the trunk's geometry and the preprocessing conventions follow the
    # weights file's layout; masks are never written to feature records,
    # so the mask branch is skipped
    model, pixel_mean, pixel_std = detector_from_weights(
        args.load_weights, dataset=args.dataset,
        num_classes=args.num_classes, canvas=(canvas_h, canvas_w),
        depth=args.depth, score_thresh=args.score_thresh, device=device)

    ocr_mode = "ocr" if args.OCR else ("gt" if args.ocr_gt else "oracle")
    png_dir = os.path.join(args.dir_path, args.split, "png")
    files = sorted_image_files(png_dir)
    os.makedirs(args.output, exist_ok=True)
    n_chunks = len(range(0, len(files), args.batch_size))
    print(f"Dataset images path: {png_dir} ({device})")
    print(f"Start to calculate. Total chunks: {n_chunks}", flush=True)

    _, cls_dict = get_nonvis_ids(args.dataset)
    start = time.time()
    for c_id, chunk_files in chunk_gen(files, args.batch_size, args.chunk):
        padded, raws, resized_hw = [], [], []
        for img_path in chunk_files:
            # test-time ResizeShortestEdge: detection runs at the scale the
            # detector trained at; boxes are scaled back to the original
            # image afterwards (reference get_input/get_features,
            # extract_features.py:38-70)
            raw = np.asarray(Image.open(img_path).convert("RGB"), np.float32)
            canvas, hw = pad_image(raw, (canvas_h, canvas_w), args.short_edge,
                                   pixel_mean, pixel_std)
            padded.append(canvas)
            raws.append(raw)
            resized_hw.append(hw)
        det_out = batched_detect(model, padded, max(1, args.infer_batch),
                                 resized_hw)
        records = []
        for img_path, raw, hw, (out, img_feat) in zip(
                chunk_files, raws, resized_hw, det_out):
            image_id = path_to_img_id(img_path)
            gt_texts = None
            if gt_ann is not None and ocr_mode != "ocr":
                if args.dataset == 'dvqa':
                    ann = gt_ann[image_id - 1]
                    name = ann['image'].split("_")[-1].split(".")[0]
                else:
                    ann = gt_ann[image_id]
                    name = ann['image_index']
                if image_id != int(name):
                    raise ValueError(f"{img_path}: annotation {ann_path} "
                                     f"holds figure {name} at its index")
                gt_texts = get_gt_texts(ann, cls_dict, args.dataset)
            records.append(record_from_detection(
                image_id, out, img_feat, raw.shape[:2], hw,
                dataset=args.dataset, gt_texts=gt_texts, ocr_mode=ocr_mode,
                image=raw.astype(np.uint8) if ocr_mode == "ocr" else None))
        np.save(os.path.join(args.output, f"{c_id}.npy"),
                np.asarray(records, dtype=object), allow_pickle=True)
        print(f"Chunk saved: {c_id}/{n_chunks}. "
              f"elapsed: {time.time() - start:.1f}s", flush=True)


if __name__ == "__main__":
    main()
