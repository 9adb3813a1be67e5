"""RoI box head, class-specific box predictor and mask head.

The port of ``crct_tpu/detector/heads.py``, named as Detectron2's
``roi_heads`` (``box_head.fc{1,2}``, ``box_predictor.{cls_score,bbox_pred}``,
``mask_head.{mask_fcn1..4,deconv,predictor}``). Pooled RoI features arrive
in the JAX layout [N, P, P, C]; the box head flattens them as (C, P, P) and
the mask head runs NCHW, as Detectron2's weights expect. Box decoding,
scoring and the losses run in fp32 under a bf16 model.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from crct_tpu_torch.detector import boxes as box_ops
from crct_tpu_torch.ops.nms import batched_nms

BOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


class BoxHead(nn.Module):
    """RoIAlign 7x7 -> flatten -> 2x FC(fc_dim). Its output is the feature
    vector recorded per chart element."""

    def __init__(self, channels: int = 256, pooled: int = 7,
                 fc_dim: int = 1024):
        super().__init__()
        self.fc1 = nn.Linear(channels * pooled * pooled, fc_dim)
        self.fc2 = nn.Linear(fc_dim, fc_dim)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = pooled.permute(0, 3, 1, 2).reshape(pooled.shape[0], -1)
        return F.relu(self.fc2(F.relu(self.fc1(x))))


class BoxPredictor(nn.Module):
    """Classification (num_classes + 1, background last) and class-specific
    deltas."""

    def __init__(self, num_classes: int, fc_dim: int = 1024):
        super().__init__()
        self.num_classes = num_classes
        self.cls_score = nn.Linear(fc_dim, num_classes + 1)
        self.bbox_pred = nn.Linear(fc_dim, num_classes * 4)

    def forward(self, feats: torch.Tensor):
        deltas = self.bbox_pred(feats)
        return (self.cls_score(feats),
                deltas.reshape(feats.shape[0], self.num_classes, 4))


class MaskHead(nn.Module):
    """4x conv3x3 + a 2x2 stride-2 deconv + a 1x1 predictor: [N, 14, 14, C]
    pooled features -> [N, num_classes, 28, 28] mask logits."""

    def __init__(self, num_classes: int, channels: int = 256,
                 conv_dim: int = 256):
        super().__init__()
        for i in range(4):
            self.add_module(f"mask_fcn{i + 1}",
                            nn.Conv2d(channels if i == 0 else conv_dim,
                                      conv_dim, 3, padding=1))
        self.deconv = nn.ConvTranspose2d(conv_dim, conv_dim, 2, 2)
        self.predictor = nn.Conv2d(conv_dim, num_classes, 1)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = pooled.permute(0, 3, 1, 2)
        for i in range(4):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        return self.predictor(F.relu(self.deconv(x)))


class ROIHeads(nn.Module):
    """Holds the heads under Detectron2's ``roi_heads`` name."""

    def __init__(self, num_classes: int, fc_dim: int = 1024,
                 with_mask: bool = True, channels: int = 256):
        super().__init__()
        self.box_head = BoxHead(channels, 7, fc_dim)
        self.box_predictor = BoxPredictor(num_classes, fc_dim)
        self.mask_head = MaskHead(num_classes, channels) if with_mask \
            else None


def _pick_class(deltas: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """deltas [N, K, 4] at class cls [N] -> [N, 4]."""
    return deltas.gather(1, cls[:, None, None].expand(-1, 1, 4))[:, 0]


def box_head_inference(scores: torch.Tensor, deltas: torch.Tensor,
                       proposals: torch.Tensor, proposal_valid: torch.Tensor,
                       image_hw: Tuple[int, int], *,
                       score_thresh: float = 0.5, nms_thresh: float = 0.5,
                       max_detections: int = 100):
    """Per-proposal best-class selection, delta decode, thresholded batched
    NMS; returns fixed-size (boxes, scores, classes, valid, kept_row)."""
    scores = scores.float()
    deltas = deltas.float()
    fg = torch.softmax(scores, dim=-1)[:, :-1]        # drop background col
    cls = torch.argmax(fg, dim=-1)
    cls_score = fg.amax(dim=-1)
    dec = box_ops.decode_deltas(_pick_class(deltas, cls), proposals,
                                weights=BOX_REG_WEIGHTS)
    dec = box_ops.clip_boxes(dec, image_hw[0], image_hw[1])
    cls_score = cls_score * proposal_valid
    keep, valid = batched_nms(dec, cls_score, cls, iou_threshold=nms_thresh,
                              score_threshold=score_thresh,
                              max_outputs=max_detections)
    safe = keep.clamp(min=0)
    return dec[safe], cls_score[safe] * valid, cls[safe], valid, safe


def _smooth_l1(diff: torch.Tensor, beta: float) -> torch.Tensor:
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def box_head_losses(scores: torch.Tensor, deltas: torch.Tensor,
                    proposals: torch.Tensor, matched_gt_boxes: torch.Tensor,
                    gt_class: torch.Tensor, sample_weight: torch.Tensor,
                    is_fg: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Softmax CE over classes (+bg) and smooth-L1 on fg rows, in fp32."""
    scores = scores.float()
    deltas = deltas.float()
    num_classes = deltas.shape[1]
    labels = torch.where(is_fg, gt_class, torch.full_like(gt_class,
                                                          num_classes))
    logp = torch.log_softmax(scores, dim=-1)
    ce = -logp.gather(1, labels[:, None].long())[:, 0]
    norm = sample_weight.sum().clamp(min=1.0)
    cls_loss = (ce * sample_weight).sum() / norm

    fg_w = sample_weight * is_fg.float()
    target = box_ops.encode_deltas(matched_gt_boxes, proposals,
                                   weights=BOX_REG_WEIGHTS)
    sel = _pick_class(deltas, gt_class.long().clamp(0, num_classes - 1))
    sl1 = _smooth_l1((sel - target).abs(), 1.0)
    box_loss = (sl1.sum(-1) * fg_w).sum() / norm
    return {"box_cls": cls_loss, "box_reg": box_loss}


def mask_loss(mask_logits: torch.Tensor, gt_masks: torch.Tensor,
              gt_class: torch.Tensor, fg_weight: torch.Tensor
              ) -> torch.Tensor:
    """Per-class BCE on 28x28 mask targets of the sampled foreground rows;
    mask_logits [N, K, 28, 28]."""
    mask_logits = mask_logits.float()
    K, M = mask_logits.shape[1], mask_logits.shape[2]
    safe_cls = gt_class.long().clamp(0, K - 1)
    sel = mask_logits.gather(
        1, safe_cls[:, None, None, None].expand(-1, 1, M, M))[:, 0]
    t = gt_masks.float()
    bce = sel.clamp(min=0) - sel * t + torch.log1p(torch.exp(-sel.abs()))
    per_row = bce.mean(dim=(1, 2))
    return (per_row * fg_weight).sum() / fg_weight.sum().clamp(min=1.0)
