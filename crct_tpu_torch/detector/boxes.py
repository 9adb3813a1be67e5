"""Anchor generation, box delta coding, IoU matching, fixed-size sampling.

The port of ``crct_tpu/detector/boxes.py``: the geometry layer under the
RPN and RoI heads. Everything is static-shape: matching gives per-anchor
labels, sampling selects a fixed number of rows by a randomized top-k.
Ties go to the lowest index, as in the JAX package (stable sorts, and
``torch.argmax``'s first maximal index).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from crct_tpu_torch.ops.nms import iou_matrix


def generate_anchors(feat_shape: Tuple[int, int], stride: int,
                     sizes: Sequence[float],
                     ratios: Sequence[float] = (0.5, 1.0, 2.0)) -> np.ndarray:
    """Anchors for one level: [H*W*A, 4] (x1,y1,x2,y2), cell-centered."""
    H, W = feat_shape
    base = []
    for size in sizes:
        area = size * size
        for r in ratios:
            w = np.sqrt(area / r)
            h = w * r
            base.append([-w / 2, -h / 2, w / 2, h / 2])
    base = np.asarray(base, np.float32)                       # [A, 4]
    shift_x = (np.arange(W) + 0.5) * stride
    shift_y = (np.arange(H) + 0.5) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    anchors = shifts + base[None, :, :]
    return anchors.reshape(-1, 4).astype(np.float32)


def encode_deltas(boxes: torch.Tensor, anchors: torch.Tensor,
                  weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Box -> (dx, dy, dw, dh) relative to anchors (R-CNN
    parameterization); zero-size anchors and boxes are clamped so padding
    rows give finite targets."""
    aw = (anchors[:, 2] - anchors[:, 0]).clamp(min=1e-6)
    ah = (anchors[:, 3] - anchors[:, 1]).clamp(min=1e-6)
    ax = anchors[:, 0] + aw / 2
    ay = anchors[:, 1] + ah / 2
    bw = (boxes[:, 2] - boxes[:, 0]).clamp(min=1e-6)
    bh = (boxes[:, 3] - boxes[:, 1]).clamp(min=1e-6)
    bx = boxes[:, 0] + bw / 2
    by = boxes[:, 1] + bh / 2
    wx, wy, ww, wh = weights
    return torch.stack([wx * (bx - ax) / aw, wy * (by - ay) / ah,
                        ww * torch.log(bw / aw), wh * torch.log(bh / ah)],
                       dim=-1)


def decode_deltas(deltas: torch.Tensor, anchors: torch.Tensor,
                  weights=(1.0, 1.0, 1.0, 1.0),
                  clip: float = float(np.log(1000.0 / 16))) -> torch.Tensor:
    """(dx, dy, dw, dh) -> boxes."""
    aw = (anchors[:, 2] - anchors[:, 0]).clamp(min=1e-6)
    ah = (anchors[:, 3] - anchors[:, 1]).clamp(min=1e-6)
    ax = anchors[:, 0] + aw / 2
    ay = anchors[:, 1] + ah / 2
    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=clip)
    dh = (deltas[..., 3] / wh).clamp(max=clip)
    cx = dx * aw + ax
    cy = dy * ah + ay
    w = torch.exp(dw) * aw
    h = torch.exp(dh) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def clip_boxes(boxes: torch.Tensor, height, width) -> torch.Tensor:
    return torch.stack([boxes[..., 0].clamp(0, width),
                        boxes[..., 1].clamp(0, height),
                        boxes[..., 2].clamp(0, width),
                        boxes[..., 3].clamp(0, height)], dim=-1)


def match_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_valid: torch.Tensor, *, pos_thr: float, neg_thr: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """IoU matching: (matched_gt_idx [N], label [N]) with label 1 positive,
    0 negative, -1 ignore. Max-IoU >= pos_thr is positive, < neg_thr
    negative; each valid GT's best anchor is forced positive (Detectron2's
    low-quality matches). Padding GTs are dropped from that scatter: their
    argmax lands on anchor 0 and must not clobber a valid GT's."""
    gt_valid = gt_valid.to(torch.bool)
    ious = iou_matrix(anchors, gt_boxes)                  # [N, M]
    ious = torch.where(gt_valid[None, :], ious, torch.full_like(ious, -1.0))
    best_gt = torch.argmax(ious, dim=1)
    best_iou = ious.amax(dim=1)
    label = torch.where(best_iou >= pos_thr, 1,
                        torch.where(best_iou < neg_thr, 0, -1))
    best_anchor_per_gt = torch.argmax(ious, dim=0)        # [M]
    forced = torch.zeros(anchors.shape[0] + 1, dtype=torch.bool,
                         device=anchors.device)
    # row N is the dump row of the padding GTs, cut off after the scatter
    forced[torch.where(gt_valid, best_anchor_per_gt,
                       anchors.shape[0])] = True
    label = torch.where(forced[:-1], 1, label)
    return best_gt, label


def _draw_uniform(generator: Optional[torch.Generator], n: int,
                  device) -> torch.Tensor:
    """The sampler's noise: n U[0, 1) floats on ``device`` from the
    caller's generator (the one random draw of the detector's train path;
    the parity tests patch it to hand in the JAX package's noise)."""
    return torch.rand(n, generator=generator, device=device)


def sample_fixed(label: torch.Tensor, generator: Optional[torch.Generator],
                 *, num: int, pos_fraction: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample a fixed number of rows, positives first (up to
    num * pos_fraction), the rest negatives, by a randomized top-k so that
    shapes stay static. Returns (indices [num], weights [num]), weight 0
    marking padding rows."""
    n = label.shape[0]
    num_pos = int(num * pos_fraction)
    noise = _draw_uniform(generator, n, label.device)
    zero = torch.zeros_like(noise)
    pos_score = torch.where(label == 1, 1.0 + noise, zero)
    pos_idx = torch.sort(pos_score, descending=True, stable=True)[1][:num_pos]
    pos_ok = pos_score[pos_idx] > 0
    n_pos = pos_ok.sum()
    neg_score = torch.where(label == 0, 1.0 + noise, zero)
    neg_idx = torch.sort(neg_score, descending=True, stable=True)[1][:num]
    rank = torch.arange(neg_idx.shape[0], device=label.device)
    neg_ok = (neg_score[neg_idx] > 0) & (rank < (num - n_pos))
    idx = torch.cat([pos_idx, neg_idx])
    ok = torch.cat([pos_ok, neg_ok])
    order = torch.argsort((~ok).to(torch.int8), stable=True)
    return idx[order][:num], ok[order][:num].to(torch.float32)
