"""Region Proposal Network over the FPN levels.

The port of ``crct_tpu/detector/rpn.py``: a shared 3x3 conv and objectness
/ delta 1x1 convs per level, static pre-NMS top-k per level, fp32 delta
decoding, clipping and one fixed-size NMS over the concatenated
candidates; training losses with IoU 0.7/0.3 matching and a 256-anchor
fixed sample. Named as Detectron2's ``proposal_generator.rpn_head``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from crct_tpu_torch.detector import boxes as box_ops
from crct_tpu_torch.ops.nms import fast_nms, nms, top_k_boxes

RPN_SIZES = (32, 64, 128, 256, 512)        # one size per P2..P6
RPN_STRIDES = (4, 8, 16, 32, 64)
NUM_ANCHOR_RATIOS = 3


class RPNHead(nn.Module):
    """Shared conv + objectness/delta predictions for each level."""

    def __init__(self, channels: int = 256,
                 num_anchors: int = NUM_ANCHOR_RATIOS):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.objectness_logits = nn.Conv2d(channels, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]):
        """Per level: logits [B, h*w*A] and deltas [B, h*w*A, 4], in the
        (y, x, anchor) order of :func:`level_anchors`."""
        logits, deltas = [], []
        for f in feats:
            h = F.relu(self.conv(f))
            B = f.shape[0]
            logits.append(self.objectness_logits(h).permute(0, 2, 3, 1)
                          .reshape(B, -1))
            deltas.append(self.anchor_deltas(h).permute(0, 2, 3, 1)
                          .reshape(B, -1, 4))
        return logits, deltas


class RPN(nn.Module):
    """Holds the head under Detectron2's ``proposal_generator`` name."""

    def __init__(self, channels: int = 256):
        super().__init__()
        self.rpn_head = RPNHead(channels)


def level_anchors(feat_shapes: Sequence[Tuple[int, int]]) -> List[np.ndarray]:
    return [box_ops.generate_anchors(tuple(shape), RPN_STRIDES[i],
                                     [RPN_SIZES[i]])
            for i, shape in enumerate(feat_shapes)]


def propose(logits: Sequence[torch.Tensor], deltas: Sequence[torch.Tensor],
            anchors: Sequence[torch.Tensor], image_hw: Tuple[int, int], *,
            pre_nms_topk: int = 1000, post_nms_topk: int = 512,
            nms_thresh: float = 0.7, fast: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One image: decode + per-level top-k + joint NMS -> a fixed
    post_nms_topk proposals. ``fast`` swaps exact NMS for ``fast_nms``.

    Returns (boxes [K, 4], scores [K], valid [K])."""
    cand_boxes, cand_scores = [], []
    H, W = image_hw
    for lg, dl, an in zip(logits, deltas, anchors):
        # fp32 decode under a bf16 model: box coordinates must keep
        # sub-pixel precision on large canvases
        idx, top_scores = top_k_boxes(lg.float(), pre_nms_topk)
        dec = box_ops.decode_deltas(dl[idx].float(), an[idx])
        cand_boxes.append(box_ops.clip_boxes(dec, H, W))
        cand_scores.append(top_scores)
    all_boxes = torch.cat(cand_boxes)
    all_scores = torch.sigmoid(torch.cat(cand_scores))
    wh_ok = (((all_boxes[:, 2] - all_boxes[:, 0]) > 1e-3)
             & ((all_boxes[:, 3] - all_boxes[:, 1]) > 1e-3))
    all_scores = torch.where(wh_ok, all_scores, torch.zeros_like(all_scores))
    nms_fn = fast_nms if fast else nms
    keep, valid = nms_fn(all_boxes, all_scores, iou_threshold=nms_thresh,
                         score_threshold=0.0, max_outputs=post_nms_topk)
    safe = keep.clamp(min=0)
    return all_boxes[safe], all_scores[safe] * valid, valid


def rpn_losses(logits: Sequence[torch.Tensor], deltas: Sequence[torch.Tensor],
               anchors: Sequence[torch.Tensor], gt_boxes: torch.Tensor,
               gt_valid: torch.Tensor, generator: Optional[torch.Generator],
               *, batch_per_image: int = 256, pos_fraction: float = 0.5
               ) -> Dict[str, torch.Tensor]:
    """One image: objectness BCE + box smooth-L1 over a 256-anchor fixed
    sample, in fp32."""
    all_logits = torch.cat(list(logits)).float()
    all_deltas = torch.cat(list(deltas)).float()
    all_anchors = torch.cat(list(anchors))
    matched_gt, label = box_ops.match_anchors(
        all_anchors, gt_boxes, gt_valid, pos_thr=0.7, neg_thr=0.3)
    idx, weight = box_ops.sample_fixed(label, generator, num=batch_per_image,
                                       pos_fraction=pos_fraction)
    sel_logits = all_logits[idx]
    sel_label = (label[idx] == 1).float()
    bce = (sel_logits.clamp(min=0) - sel_logits * sel_label
           + torch.log1p(torch.exp(-sel_logits.abs())))
    norm = weight.sum().clamp(min=1.0)
    obj_loss = (bce * weight).sum() / norm

    pos_w = weight * sel_label
    target = box_ops.encode_deltas(gt_boxes[matched_gt[idx]],
                                   all_anchors[idx])
    diff = (all_deltas[idx] - target).abs()
    beta = 1.0 / 9
    sl1 = torch.where(diff < beta, 0.5 * diff * diff / beta,
                      diff - 0.5 * beta)
    box_loss = (sl1.sum(-1) * pos_w).sum() / norm
    return {"rpn_obj": obj_loss, "rpn_box": box_loss}
