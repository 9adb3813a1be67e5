"""Detector training entry point of the PyTorch port (reference
Detector/frcnn.py; the port of ``crct_tpu/cli/detector_train.py``).

Trains on the card unless ``--device cpu`` is given:

    python -m crct_tpu_torch.cli.detector_train --dataset plotqa \\
        --annotations train.json --image-dir pngs/ [--test]

``--cuda-num N`` picks the card. The flags are the JAX CLI's. Model choice
follows frcnn.py:137-155: Mask R-CNN R50 for plotqa, Faster R-CNN R50 for
plotqa_colorless/dvqa, R101 for figure_qa. ``--load-weights`` takes a port
or JAX detector checkpoint (the latter an Orbax directory, read with
tensorstore), a torch ``.pth`` or a Detectron2 model-zoo ``.pkl``.
``--bf16`` trains under bf16 autocast over fp32 parameters (box decoding
and losses stay fp32).

Over N cards, one process each, ``--batch-size`` images a step in all
(the world size must divide it):

    torchrun --nproc_per_node 2 -m crct_tpu_torch.cli.detector_train \
        --annotations train.json --image-dir pngs/ --batch-size 2

Rank 0 alone logs, evaluates (``--test``) and saves checkpoints.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from crct_tpu_torch import parallel
from crct_tpu_torch.utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="plotqa",
                   choices=["plotqa", "plotqa_colorless", "figure_qa", "dvqa"])
    p.add_argument("--annotations", required=True)
    p.add_argument("--image-dir", required=True)
    p.add_argument("--val-annotations", default="")
    p.add_argument("--val-image-dir", default="")
    p.add_argument("--output-dir", default="./output/detector")
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--max-iter", type=int, default=100000)
    p.add_argument("--base-lr", type=float, default=2.5e-4)
    p.add_argument("--max-boxes", type=int, default=100)
    p.add_argument("--image-size", type=int, default=1344)
    p.add_argument("--checkpoint-every", type=int, default=5000)
    p.add_argument("--load-weights", default="",
                   help="port or JAX detector ckpt, torch .pth, or "
                        "Detectron2 "
                        "model-zoo .pkl (e.g. mask_rcnn_R_50_FPN_1x, the "
                        "reference's default init, frcnn.py:215)")
    p.add_argument("--freeze-at", type=int, default=None,
                   help="freeze backbone through this stage (1=stem, "
                        "2=res2...); default 2 when fine-tuning from "
                        "--load-weights (reference FREEZE_AT), else 0")
    p.add_argument("--test", action="store_true", help="evaluation only")
    p.add_argument("--eval-images", type=int, default=0)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 autocast over fp32 parameters (box decoding "
                        "and losses stay fp32); the reference recipe is "
                        "fp32")
    p.add_argument("--depth", type=int, default=0,
                   choices=[0, 14, 50, 101],
                   help="ResNet depth override (0 = the dataset rule: R101 "
                        "for figure_qa, R50 otherwise; 14 = tiny trunk for "
                        "CPU smoke runs)")
    p.add_argument("--fast-nms", action="store_true",
                   help="parallel fast-NMS for train-time RPN proposals "
                        "(keep set is a subset of exact NMS; inference "
                        "stays exact)")
    p.add_argument("--no-augment", action="store_true",
                   help="disable train-time random hflip + multi-scale "
                        "shortest-edge sampling (on by default, as in the "
                        "Detectron2 INPUT pipeline, frcnn.py:182-205)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--cuda-num", type=int, default=-1,
                   help="which card (default: the current one)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    # torchrun's environment forms the process group (one rank a card)
    where = {"device": args.device, "cuda_num": args.cuda_num}
    parallel.maybe_initialize_distributed(where)
    device = args.device
    if device == "cuda" and where["cuda_num"] >= 0:
        device = f"cuda:{where['cuda_num']}"
    device = resolve_device(device)
    rank0 = parallel.rank() == 0

    from crct_tpu_torch.detector.coco import CocoDataset
    from crct_tpu_torch.detector.convert import (detector_file_meta,
                                                 restore_detector_params)
    from crct_tpu_torch.detector.extract import resolve_depth
    from crct_tpu_torch.detector.trainer import (BATCH_KEYS, DetectorTrainer,
                                                 coco_evaluate,
                                                 detector_batch_iterator)
    from crct_tpu_torch.utils.checkpoint import (detector_checkpoint_name,
                                                 save_detector_checkpoint)

    with_mask = args.dataset == "plotqa"
    # the stride convention and pixel normalization follow the weights
    # file's layout (see detector.convert.detector_file_meta)
    meta = detector_file_meta(args.load_weights)
    depth = resolve_depth(args.depth, meta, args.dataset, args.load_weights)
    stride_in_1x1 = meta["stride_in_1x1"]
    augment = not (args.test or args.no_augment)
    ds = CocoDataset(args.annotations, args.image_dir,
                     max_boxes=args.max_boxes, max_size=args.image_size,
                     with_masks=with_mask, pixel_mean=meta["pixel_mean"],
                     pixel_std=meta["pixel_std"], augment=augment)
    if augment and rank0:
        print(f"augmentation: hflip p=0.5 + short-edge {ds.train_scales} "
              f"(fixed {args.image_size}px canvas)")
    if rank0:
        print(f"{len(ds)} images, {len(ds.categories)} classes, {device}, "
              f"{parallel.world_size()} rank(s)")
    freeze_at = args.freeze_at
    if freeze_at is None:
        freeze_at = 2 if args.load_weights else 0
    trainer = DetectorTrainer(num_classes=len(ds.categories),
                              with_mask=with_mask, depth=depth,
                              batch_size=args.batch_size,
                              base_lr=args.base_lr,
                              stride_in_1x1=stride_in_1x1,
                              freeze_at=freeze_at, bf16=args.bf16,
                              fast_nms=args.fast_nms, device=device)
    if args.load_weights:
        restore_detector_params(trainer.model, args.load_weights)

    if args.test:
        if not rank0:
            return None
        trainer.model.eval()
        metrics = coco_evaluate(trainer.model, ds,
                                max_images=args.eval_images or None)
        print(json.dumps(metrics, indent=2))
        return metrics

    os.makedirs(args.output_dir, exist_ok=True)
    keys = BATCH_KEYS if with_mask else BATCH_KEYS[:4]
    batches = detector_batch_iterator(ds, args.batch_size, keys,
                                      args.max_iter)
    t0 = time.time()
    for it, batch in enumerate(batches):
        losses = trainer.run_step(batch)
        if it % 20 == 0 and rank0:
            msg = " ".join(f"{k}:{v:.4f}" for k, v in losses.items())
            print(f"[{it}/{args.max_iter}] [{time.time() - t0:.1f}s] {msg}",
                  flush=True)
        if rank0 and ((it + 1) % args.checkpoint_every == 0
                      or it + 1 == args.max_iter):
            path = os.path.join(args.output_dir,
                                detector_checkpoint_name(it + 1))
            # extraction and serving rebuild the same stride placement,
            # normalization and depth from this
            save_detector_checkpoint(
                path, trainer.model.state_dict(), it + 1,
                {"stride_in_1x1": bool(stride_in_1x1),
                 "pixel_mean": list(meta["pixel_mean"]),
                 "pixel_std": list(meta["pixel_std"]), "depth": depth})
            print(f"saved {path}")
    return trainer


if __name__ == "__main__":
    main()
