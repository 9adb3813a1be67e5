"""Fixed-shape non-maximum suppression in plain torch.

The port of ``crct_tpu/ops/nms.py`` (XLA code, no Pallas kernel): an
iterative masked suppression with a static bound. At each of
``max_outputs`` steps the highest-scoring live box is selected and
everything over the IoU threshold is suppressed. The output is always
[max_outputs] indices plus a validity mask.

The loop runs on the tensors' device with no ``.item()`` and no host sync
inside it: every step is a handful of small kernels queued behind the last.
Ties go to the lowest index, as ``jnp.argmax`` and ``jax.lax.top_k`` break
them (``torch.argmax`` returns the first maximal index; :func:`top_k_boxes`
sorts stably).

Class-aware ("batched") NMS uses the coordinate-offset trick: boxes are
shifted per class so cross-class pairs never overlap.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.profiler import record_function

NEG_INF = -1e10


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of [N,4] x [M,4] (x1,y1,x2,y2) -> [N,M]."""
    area_a = (boxes_a[:, 2] - boxes_a[:, 0]).clamp(min=0) * \
        (boxes_a[:, 3] - boxes_a[:, 1]).clamp(min=0)
    area_b = (boxes_b[:, 2] - boxes_b[:, 0]).clamp(min=0) * \
        (boxes_b[:, 3] - boxes_b[:, 1]).clamp(min=0)
    lt = torch.maximum(boxes_a[:, None, :2], boxes_b[None, :, :2])
    rb = torch.minimum(boxes_a[:, None, 2:], boxes_b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union.clamp(min=1e-9)


def nms(boxes: torch.Tensor, scores: torch.Tensor, *,
        iou_threshold: float = 0.5, score_threshold: float = 0.0,
        max_outputs: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (indices [max_outputs] int64, valid [max_outputs] bool)."""
    with record_function("detector::nms"):
        n = boxes.shape[0]
        dev = boxes.device
        # row i: the boxes that selecting box i suppresses, itself included
        suppress = iou_matrix(boxes, boxes) > iou_threshold
        suppress |= torch.eye(n, dtype=torch.bool, device=dev)
        live = scores > score_threshold
        neg = torch.full_like(scores, NEG_INF)
        keep_idx = torch.full((max_outputs,), -1, dtype=torch.int64,
                              device=dev)
        keep_valid = torch.zeros((max_outputs,), dtype=torch.bool, device=dev)
        for i in range(min(max_outputs, n)):
            masked = torch.where(live, scores, neg)
            best = torch.argmax(masked)
            ok = masked[best] > NEG_INF / 2
            keep_idx[i] = torch.where(ok, best, -1)
            keep_valid[i] = ok
            live &= ~(suppress[best] & ok)
        return keep_idx, keep_valid


def fast_nms(boxes: torch.Tensor, scores: torch.Tensor, *,
             iou_threshold: float = 0.5, score_threshold: float = 0.0,
             max_outputs: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parallel NMS (YOLACT-style): box i survives iff NO higher-scoring
    box overlaps it, including boxes that were themselves suppressed. The
    keep set is a subset of exact :func:`nms`'s; kept boxes still never
    overlap above the threshold. One sort, one IoU matrix, a column max.

    Same interface as :func:`nms`, indices emitted in score order."""
    n = boxes.shape[0]
    dev = boxes.device
    # jnp.argsort(-scores) is stable
    order = torch.argsort(-scores, stable=True)
    b = boxes[order]
    s = scores[order]
    ious = iou_matrix(b, b)
    # row j suppresses column i only for j < i
    ut = torch.triu(torch.ones((n, n), dtype=torch.bool, device=dev),
                    diagonal=1)
    overlapped = torch.where(ut, ious, torch.zeros_like(ious)).amax(dim=0)
    keep = (overlapped <= iou_threshold) & (s > score_threshold)

    # compact the kept rows (already score-ordered) into max_outputs slots
    rank = torch.cumsum(keep.to(torch.int64), 0) - 1
    slot = torch.where(keep & (rank < max_outputs), rank,
                       torch.full_like(rank, max_outputs))
    keep_idx = torch.full((max_outputs + 1,), -1, dtype=torch.int64,
                          device=dev)
    keep_idx[slot] = order
    keep_valid = torch.zeros((max_outputs + 1,), dtype=torch.bool,
                             device=dev)
    keep_valid[slot] = keep
    # the dump slot max_outputs takes many writes; only slots < max_outputs
    # are written once each
    return keep_idx[:max_outputs], keep_valid[:max_outputs]


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor, *, iou_threshold: float = 0.5,
                score_threshold: float = 0.0, max_outputs: int = 100
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware NMS via per-class coordinate offsets."""
    span = boxes.max() - boxes.min() + 1.0
    offset = classes.to(boxes.dtype)[:, None] * span
    return nms(boxes + offset, scores, iou_threshold=iou_threshold,
               score_threshold=score_threshold, max_outputs=max_outputs)


def top_k_boxes(scores: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static top-k (indices, values), ties to the lowest index as
    ``jax.lax.top_k`` breaks them."""
    k = min(k, scores.shape[0])
    vals, idx = torch.sort(scores, descending=True, stable=True)
    return idx[:k], vals[:k]
