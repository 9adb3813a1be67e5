"""Mask R-CNN / Faster R-CNN assembled, fixed shapes end to end.

The port of ``crct_tpu/detector/mask_rcnn.py``: ResNet -> FPN -> RPN
(fixed-k proposals) -> RoIAlign box head -> class-specific predictor
(-> mask head), the detector the reference trains with Detectron2
(Mask R-CNN R50-FPN for PlotQA). Attribute names are Detectron2's
(``backbone``, ``proposal_generator``, ``roi_heads``).

The JAX module is one image, batched by ``jax.vmap`` in the trainer; here
the backbone, the FPN and the RPN head run the whole NCHW batch, and the
per-image tail (proposals, matching, sampling, RoIAlign, heads, losses)
loops over the images. Train losses are the mean of the images' losses,
as the JAX trainer takes them. Images arrive as the dataset gives them,
[B, H, W, 3].
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from crct_tpu_torch.detector import boxes as box_ops
from crct_tpu_torch.detector.fpn import FPN
from crct_tpu_torch.detector.heads import (ROIHeads, box_head_inference,
                                           box_head_losses, mask_loss)
from crct_tpu_torch.detector.resnet import ResNet
from crct_tpu_torch.detector.rpn import (RPN, level_anchors, propose,
                                         rpn_losses)
from crct_tpu_torch.ops.roi_align import multilevel_roi_align

ROI_STRIDES = (4, 8, 16, 32)


@torch.no_grad()
def init_detector_weights(model: nn.Module, generator: torch.Generator
                          ) -> None:
    """Random weights from a seed, as flax initializes the JAX detector:
    lecun-normal kernels (a normal truncated at 2 sigma, scaled to variance
    1 / fan_in), zero biases; the frozen norms keep their identity
    statistics."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:
                fan_in = w[0].numel()
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            cpu = torch.empty(w.shape)
            torch.nn.init.trunc_normal_(cpu, 0.0, std, -2 * std, 2 * std,
                                        generator=generator)
            w.copy_(cpu)
            if m.bias is not None:
                m.bias.zero_()


class MaskRCNN(nn.Module):
    # caps the positives of the RoI sample and sizes the fg-only mask
    # subset: keeping the two coupled makes the subset's mask loss equal
    # the all-roi one
    ROI_POS_FRACTION = 0.25

    def __init__(self, num_classes: int, depth: int = 50,
                 with_mask: bool = True, fc_dim: int = 1024,
                 post_nms_topk_train: int = 512,
                 post_nms_topk_test: int = 512, roi_batch: int = 256,
                 stride_in_1x1: bool = False, freeze_at: int = 0,
                 fast_train_nms: bool = False,
                 score_thresh_test: float = 0.5):
        super().__init__()
        self.num_classes = num_classes
        self.with_mask = with_mask
        self.post_nms_topk_train = post_nms_topk_train
        self.post_nms_topk_test = post_nms_topk_test
        self.roi_batch = roi_batch
        self.fast_train_nms = fast_train_nms
        self.score_thresh_test = score_thresh_test
        self.backbone = FPN(ResNet(depth, stride_in_1x1, freeze_at), 256)
        self.proposal_generator = RPN(256)
        self.roi_heads = ROIHeads(num_classes, fc_dim, with_mask)
        self._anchors: Dict[Tuple, List[torch.Tensor]] = {}

    def features(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """images [B, H, W, 3] -> FPN maps (P2..P6), each [B, C, h, w]."""
        return self.backbone(images.permute(0, 3, 1, 2))

    def anchors(self, p_feats) -> List[torch.Tensor]:
        """The levels' anchors on the maps' device, built once per shape."""
        shapes = tuple(tuple(f.shape[-2:]) for f in p_feats)
        key = (shapes, p_feats[0].device)
        if key not in self._anchors:
            self._anchors[key] = [torch.from_numpy(a).to(p_feats[0].device)
                                  for a in level_anchors(shapes)]
        return self._anchors[key]

    def forward(self, images: torch.Tensor, *, train: bool = False,
                gt_boxes: Optional[torch.Tensor] = None,
                gt_classes: Optional[torch.Tensor] = None,
                gt_valid: Optional[torch.Tensor] = None,
                gt_masks28: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                compute_masks: bool = True) -> Dict[str, torch.Tensor]:
        """Train: the mean over the images of each loss and their total.
        Inference: the detections of each image, stacked on a leading batch
        axis. ``generator`` feeds the train path's two samplers per image
        (RPN anchors, then RoIs)."""
        H, W = images.shape[1], images.shape[2]
        p_feats = self.features(images)
        logits, deltas = self.proposal_generator.rpn_head(p_feats)
        anchors = self.anchors(p_feats)
        topk = self.post_nms_topk_train if train else self.post_nms_topk_test
        per_image = []
        for i in range(images.shape[0]):
            lg = [x[i] for x in logits]
            dl = [x[i] for x in deltas]
            # one image's P2..P5 in the JAX layout [h, w, C]
            maps = [f[i].permute(1, 2, 0) for f in p_feats[:4]]
            if not train:
                proposals, _, prop_valid = propose(lg, dl, anchors, (H, W),
                                                   post_nms_topk=topk)
                per_image.append(self._infer(maps, proposals, prop_valid,
                                             (H, W), compute_masks))
                continue
            # proposals are training constants (Detectron2 detaches them
            # before the RoI heads): no graph through the NMS loop
            with torch.no_grad():
                proposals, _, prop_valid = propose(
                    lg, dl, anchors, (H, W), post_nms_topk=topk,
                    fast=self.fast_train_nms)
            per_image.append(self._train_losses(
                maps, lg, dl, anchors, proposals, prop_valid, gt_boxes[i],
                gt_classes[i], gt_valid[i],
                None if gt_masks28 is None else gt_masks28[i], generator))
        if train:
            return {k: torch.stack([l[k] for l in per_image]).mean()
                    for k in per_image[0]}
        return {k: torch.stack([o[k] for o in per_image])
                for k in per_image[0]}

    def _train_losses(self, maps, logits, deltas, anchors, proposals,
                      prop_valid, gt_boxes, gt_classes, gt_valid, gt_masks28,
                      generator) -> Dict[str, torch.Tensor]:
        """One image's losses (the training path of the JAX __call__)."""
        losses = rpn_losses(logits, deltas, anchors, gt_boxes, gt_valid,
                            generator)
        gt_valid = gt_valid.to(torch.bool)
        # GT boxes join the proposal pool (early-training trick)
        pool_boxes = torch.cat([proposals, gt_boxes])
        pool_valid = torch.cat([prop_valid, gt_valid])
        matched_gt, label = box_ops.match_anchors(
            pool_boxes, gt_boxes, gt_valid, pos_thr=0.5, neg_thr=0.5)
        label = torch.where(pool_valid, label, torch.full_like(label, -1))
        idx, weight = box_ops.sample_fixed(
            label, generator, num=self.roi_batch,
            pos_fraction=self.ROI_POS_FRACTION)
        rois = pool_boxes[idx]
        is_fg = label[idx] == 1
        matched = matched_gt[idx]
        heads = self.roi_heads
        pooled = multilevel_roi_align(maps, rois, strides=ROI_STRIDES,
                                      output_size=7)
        scores, box_deltas = heads.box_predictor(heads.box_head(pooled))
        losses.update(box_head_losses(scores, box_deltas, rois,
                                      gt_boxes[matched], gt_classes[matched],
                                      weight, is_fg))
        if self.with_mask and gt_masks28 is not None:
            # foreground-only mask branch: sample_fixed caps positives at
            # roi_batch // 4, so the fg-first subset of that many rows holds
            # every foreground roi; background rows carry weight 0
            n_mask = max(1, int(self.roi_batch * self.ROI_POS_FRACTION))
            fg_w = weight * is_fg.float()
            fg_first = torch.argsort((~is_fg).to(torch.int8),
                                     stable=True)[:n_mask]
            m_matched = matched[fg_first]
            mask_pooled = multilevel_roi_align(maps, rois[fg_first],
                                               strides=ROI_STRIDES,
                                               output_size=14)
            losses["mask"] = mask_loss(heads.mask_head(mask_pooled),
                                       gt_masks28[m_matched],
                                       gt_classes[m_matched], fg_w[fg_first])
        losses["total"] = sum(losses.values())
        return losses

    def _infer(self, maps, proposals, prop_valid, hw, compute_masks: bool):
        """One image's inference tail; mask logits in the JAX layout
        [K, 28, 28, num_classes]."""
        heads = self.roi_heads
        pooled = multilevel_roi_align(maps, proposals, strides=ROI_STRIDES,
                                      output_size=7)
        feats = heads.box_head(pooled)
        scores, box_deltas = heads.box_predictor(feats)
        det_boxes, det_scores, det_classes, det_valid, kept_rows = \
            box_head_inference(scores, box_deltas, proposals,
                               prop_valid.to(scores.dtype), hw,
                               score_thresh=self.score_thresh_test)
        out = {"boxes": det_boxes, "scores": det_scores,
               "classes": det_classes, "valid": det_valid,
               "features": feats[kept_rows],
               "proposals": proposals, "proposal_valid": prop_valid}
        if self.with_mask and compute_masks:
            mask_pooled = multilevel_roi_align(maps, det_boxes,
                                               strides=ROI_STRIDES,
                                               output_size=14)
            out["mask_logits"] = heads.mask_head(mask_pooled).permute(
                0, 2, 3, 1)
        return out
