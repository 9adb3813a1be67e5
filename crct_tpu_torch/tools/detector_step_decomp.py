"""Measured decomposition of the 800 x 1088 detector train step by knockout
(the port of ``tools/detector_step_decomp.py``).

The production-shape Mask R-CNN step (800 x 1088 canvas, batch 2 a card, the
Detectron2 recipe at Detector/frcnn.py:133-175; fp32 without TF32, the
RoIAlign backward through K3 on the card) is timed whole, then again with
one component stubbed out at a time, patched at the
``crct_tpu_torch.detector.mask_rcnn`` namespace (and its ``box_ops``) so the
step simply omits that work:

  full            the baseline step
  no_mask         with_mask=False          -> mask branch (RoIAlign 14 +
                                              head + loss, fwd + bwd)
  stub_roialign   RoIAlign -> broadcast    -> RoIAlign gathers fwd + bwd
  stub_nms        propose -> fixed slices  -> proposal NMS (sort + iou loop)
  stub_rpn_loss   rpn_losses -> tiny       -> RPN target matching/sampling
  stub_roi_match  + match/sample -> fixed  -> RoI matching/sampling
                                              (delta vs stub_rpn_loss)
  backbone_only   loss = sum(mean(P_i))    -> ResNet + FPN fwd + bwd floor
  optimizer_only  the SGD step alone       -> SGD + momentum update cost

Every patch is undone in a ``finally``: nothing outlives the tool. A
knockout's delta is the cost that component adds to the step's critical
path (on the card the host dispatches the step, and the NMS loop's
dispatch is host time); deltas need not sum to ``full``. Each time is the
median of ``--repeats`` windows of ``--steps`` steps after ``--warmup``
steps (3).

Usage: python -m crct_tpu_torch.tools.detector_step_decomp [--hw 800x1088]
       [--batch 2] [--steps 10] [--device cpu] [--tiny]
"""
from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch


@contextlib.contextmanager
def patched(module, **repls):
    olds = {k: getattr(module, k) for k in repls}
    try:
        for k, v in repls.items():
            setattr(module, k, v)
        yield
    finally:
        for k, v in olds.items():
            setattr(module, k, v)


def stub_roialign(features, boxes, *, output_size=7, **_):
    base = features[0][:output_size, :output_size, :]
    return base[None].expand((boxes.shape[0],) + tuple(base.shape))


def stub_propose(logits, deltas, anchors, image_hw, *, post_nms_topk=512,
                 **_):
    boxes = torch.cat(list(anchors))[:post_nms_topk].float()
    scores = torch.cat([l.reshape(-1) for l in logits])[:post_nms_topk]
    return boxes, scores, torch.ones(boxes.shape[0], dtype=torch.bool,
                                     device=boxes.device)


def stub_rpn_losses(logits, deltas, anchors, gt_boxes, gt_valid, generator,
                    **_):
    return {"rpn_obj": sum(l.float().mean() for l in logits) * 1e-9,
            "rpn_box": sum(d.float().mean() for d in deltas) * 1e-9}


def stub_match_anchors(boxes, gt_boxes, gt_valid, *, pos_thr, neg_thr):
    n = boxes.shape[0]
    return (torch.zeros(n, dtype=torch.int64, device=boxes.device),
            torch.arange(n, device=boxes.device) % 2)


def stub_sample_fixed(label, generator, *, num, pos_fraction):
    return (torch.arange(num, device=label.device) % label.shape[0],
            torch.ones(num, device=label.device))


def backbone_loss(model, images):
    return sum(f.float().mean() for f in model.features(images))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hw", default="800x1088")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true",
                    help="depth 14, a 64 x 96 canvas, 16 rois (the CPU)")
    args = ap.parse_args(argv)

    from crct_tpu_torch import bench
    from crct_tpu_torch.detector import mask_rcnn as mr
    from crct_tpu_torch.detector.trainer import (DetectorSGD, device_batch,
                                                 make_detector_train_step)
    from crct_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)     # no card: raise before any work
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    IH, IW = (64, 96) if args.tiny else (int(x) for x in args.hw.split("x"))
    depth, roi_batch = (14, 16) if args.tiny else (50, 256)
    B, MAXB = args.batch, 40
    rng = np.random.default_rng(0)
    raw = np.sort(rng.random((B, MAXB, 2, 2), np.float32) * min(IH, IW),
                  axis=2)
    db = device_batch({
        "image": rng.random((B, IH, IW, 3)).astype(np.float32),
        "gt_boxes": np.concatenate([raw.min(2), raw.max(2)], -1),
        "gt_classes": rng.integers(0, 25, (B, MAXB)).astype(np.int32),
        "gt_valid": (rng.random((B, MAXB)) < 0.5).astype(np.float32),
        "gt_masks28": (rng.random((B, MAXB, 28, 28)) < 0.5).astype(
            np.float32),
    }, device)

    def time_step(with_mask=True, patches=None, box_patches=None,
                  loss_override=None, optimizer_only=False):
        model = mr.MaskRCNN(num_classes=25, depth=depth, with_mask=with_mask,
                            roi_batch=roi_batch)
        mr.init_detector_weights(model, torch.Generator().manual_seed(0))
        model.to(device)
        opt = DetectorSGD(list(model.parameters()), 2.5e-4)
        generator = torch.Generator(device).manual_seed(1)
        with contextlib.ExitStack() as ctx:
            if patches:
                ctx.enter_context(patched(mr, **patches))
            if box_patches:
                ctx.enter_context(patched(mr.box_ops, **box_patches))
            if loss_override is None:
                train_step = make_detector_train_step(model, opt)

                def step():
                    train_step(db, generator)
            else:
                def step():
                    model.zero_grad(set_to_none=True)
                    loss_override(model, db["image"]).backward()
                    opt.step()
            if optimizer_only:
                step()                   # the gradients the update reads
                step = opt.step
            for _ in range(args.warmup):
                step()
            with bench.Launches() as launched:
                seconds = bench.windows(
                    lambda: [step() for _ in range(args.steps)],
                    args.repeats, device)
        return (float(np.median(seconds)) / args.steps * 1e3,
                launched.record["k3"])

    variants = {
        "full": {},
        "no_mask": dict(with_mask=False),
        "stub_roialign": dict(patches={
            "multilevel_roi_align": stub_roialign}),
        "stub_nms": dict(patches={"propose": stub_propose}),
        "stub_rpn_loss": dict(patches={"rpn_losses": stub_rpn_losses}),
        "stub_roi_match": dict(
            patches={"rpn_losses": stub_rpn_losses},
            box_patches={"match_anchors": stub_match_anchors,
                         "sample_fixed": stub_sample_fixed}),
        "backbone_only": dict(loss_override=backbone_loss),
        "optimizer_only": dict(optimizer_only=True),
    }
    out, k3 = {}, {}
    for name, kw in variants.items():
        out[f"{name}_ms"], k3[name] = time_step(**kw)
        print(json.dumps({f"{name}_ms": out[f"{name}_ms"],
                          "k3_launches": k3[name]}), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()

    full = out["full_ms"]
    out["deltas_ms"] = {
        "mask_branch": full - out["no_mask_ms"],
        "roialign": full - out["stub_roialign_ms"],
        "proposal_nms": full - out["stub_nms_ms"],
        "rpn_loss_matching": full - out["stub_rpn_loss_ms"],
        "roi_matching_sampling": (out["stub_rpn_loss_ms"]
                                  - out["stub_roi_match_ms"]),
        "optimizer": out["optimizer_only_ms"],
    }
    out["k3_launches"] = k3
    out.update(hw=[IH, IW], batch=B, **bench.card_info(device))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
