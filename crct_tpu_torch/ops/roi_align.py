"""RoIAlign as gathers + bilinear interpolation, and its gradient.

The port of ``crct_tpu/ops/roi_align.py``. For each box, a fixed
``output_size x output_size`` grid of bins is sampled at
``sampling_ratio^2`` bilinear points and averaged, in the "aligned"
convention (half-pixel offset) of Detectron2's ROIAlignV2. Maps keep the
JAX package's layout at these functions: one [H, W, C] tensor per level.

``multilevel_roi_align`` is a ``torch.autograd.Function`` (the counterpart
of the ``custom_vjp`` ``_mlra``): its forward computes the sample geometry
once and gathers from one flat [sum(H*W), C] pyramid; its backward hands
that geometry to ``ops.roi_align_kernel.mlra_backward_kernel``: the
hand-written CUDA kernel K3 on a CUDA tensor, its plain version on a CPU
tensor. Boxes get a zero gradient (Detectron2 RoIAlign semantics).
``_mlra_backward`` is the JAX package's default backward, the
separable-einsum VJP, with the same signature; the port's backward never
calls it, and it is kept as a second reference for comparisons.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def _bilinear_sample(feat: torch.Tensor, y: torch.Tensor, x: torch.Tensor
                     ) -> torch.Tensor:
    """Sample feat [H, W, C] at fractional (y, x) points of shape [...]."""
    H, W, _ = feat.shape
    y = y.clamp(0.0, H - 1.0)
    x = x.clamp(0.0, W - 1.0)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    y1 = (y0 + 1).clamp(max=H - 1)
    x1 = (x0 + 1).clamp(max=W - 1)
    wy1 = y - y0.to(y.dtype)
    wx1 = x - x0.to(x.dtype)
    wy0 = 1.0 - wy1
    wx0 = 1.0 - wx1
    return (feat[y0, x0] * (wy0 * wx0)[..., None]
            + feat[y0, x1] * (wy0 * wx1)[..., None]
            + feat[y1, x0] * (wy1 * wx0)[..., None]
            + feat[y1, x1] * (wy1 * wx1)[..., None])


def roi_align(features: torch.Tensor, boxes: torch.Tensor, *,
              spatial_scale: float = 1.0, output_size: int = 7,
              sampling_ratio: int = 2) -> torch.Tensor:
    """RoIAlign over one [H, W, C] map for [N, 4] (x1, y1, x2, y2) boxes in
    image coordinates -> [N, P, P, C]."""
    P, S = output_size, sampling_ratio
    boxes = boxes.to(torch.float32) * spatial_scale
    x1 = boxes[:, 0] - 0.5
    y1 = boxes[:, 1] - 0.5
    x2 = boxes[:, 2] - 0.5
    y2 = boxes[:, 3] - 0.5
    bin_w = (x2 - x1).clamp(min=1e-6) / P
    bin_h = (y2 - y1).clamp(min=1e-6) / P
    dev = boxes.device
    offs = (torch.arange(S, dtype=torch.float32, device=dev) + 0.5) / S
    grid = torch.arange(P, dtype=torch.float32, device=dev)
    ys = (y1[:, None, None]
          + (grid[None, :, None] + offs[None, None, :]) * bin_h[:, None, None])
    xs = (x1[:, None, None]
          + (grid[None, :, None] + offs[None, None, :]) * bin_w[:, None, None])
    N = boxes.shape[0]
    ys_full = ys.reshape(N, P * S, 1).expand(N, P * S, P * S)
    xs_full = xs.reshape(N, 1, P * S).expand(N, P * S, P * S)
    sampled = _bilinear_sample(features, ys_full, xs_full)
    C = sampled.shape[-1]
    return sampled.reshape(N, P, S, P, S, C).mean(dim=(2, 4))


def level_shapes(features: Sequence[torch.Tensor]) -> Tuple[Tuple[int, int],
                                                             ...]:
    return tuple((int(f.shape[0]), int(f.shape[1])) for f in features)


def mlra_geometry(shapes: Sequence[Tuple[int, int]], boxes: torch.Tensor,
                   strides, output_size, sampling_ratio, canonical_level,
                   canonical_size, min_level, max_level
                   ) -> Dict[str, torch.Tensor]:
    """Per-box level assignment (FPN eq. 1) and the separable 1-D bilinear
    sample positions: integer corner rows/columns and their weights, each
    [N, P*S], plus each box's level, its level's flat row offset and width.
    ``shapes`` are the levels' (H, W)."""
    dev = boxes.device
    boxes = boxes.to(torch.float32)
    w = (boxes[:, 2] - boxes[:, 0]).clamp(min=0.0)
    h = (boxes[:, 3] - boxes[:, 1]).clamp(min=0.0)
    scale = torch.sqrt(w * h)
    lvl = torch.floor(canonical_level
                      + torch.log2(scale.clamp(min=1e-6) / canonical_size))
    lvl = lvl.clamp(min_level, max_level).to(torch.int64) - min_level

    Hs = np.asarray([s[0] for s in shapes])
    Ws = np.asarray([s[1] for s in shapes])
    level_offset = np.concatenate([[0], np.cumsum(Hs * Ws)])[:-1]
    box_H = torch.as_tensor(Hs, dtype=torch.float32, device=dev)[lvl]
    box_W = torch.as_tensor(Ws, dtype=torch.float32, device=dev)[lvl]
    box_off = torch.as_tensor(level_offset, dtype=torch.int64,
                              device=dev)[lvl]
    inv_stride = (1.0 / torch.as_tensor(strides, dtype=torch.float32,
                                        device=dev))[lvl]

    P, S = output_size, sampling_ratio
    b = boxes * inv_stride[:, None]
    x1 = b[:, 0] - 0.5
    y1 = b[:, 1] - 0.5
    bin_w = (b[:, 2] - 0.5 - x1).clamp(min=1e-6) / P
    bin_h = (b[:, 3] - 0.5 - y1).clamp(min=1e-6) / P
    offs = (torch.arange(S, dtype=torch.float32, device=dev) + 0.5) / S
    grid = torch.arange(P, dtype=torch.float32, device=dev)
    ys = (y1[:, None, None]
          + (grid[None, :, None] + offs[None, None, :]) * bin_h[:, None, None])
    xs = (x1[:, None, None]
          + (grid[None, :, None] + offs[None, None, :]) * bin_w[:, None, None])
    N = boxes.shape[0]
    ys = ys.reshape(N, P * S)
    xs = xs.reshape(N, P * S)

    def corners(v, limit):
        v = torch.minimum(v.clamp(min=0.0), limit[:, None])
        lo = torch.floor(v).to(torch.int64)
        hi = torch.minimum(lo + 1, limit[:, None].to(torch.int64))
        w_hi = v - lo.to(v.dtype)
        return lo, hi, 1.0 - w_hi, w_hi

    y0, y1i, wy0, wy1 = corners(ys, box_H - 1.0)
    x0, x1i, wx0, wx1 = corners(xs, box_W - 1.0)
    return dict(lvl=lvl, box_off=box_off, box_W=box_W,
                y0=y0, y1i=y1i, wy0=wy0, wy1=wy1,
                x0=x0, x1i=x1i, wx0=wx0, wx1=wx1)


def flat_pyramid(features: Sequence[torch.Tensor]) -> torch.Tensor:
    """The levels' [H, W, C] maps flattened row-major and concatenated to
    one [sum(H*W), C] tensor."""
    C = features[0].shape[-1]
    return torch.cat([f.reshape(-1, C) for f in features], dim=0)


def _sample_rows(geo: Dict[str, torch.Tensor]):
    """The four bilinear corners of every sample point: (flat row index
    [N, PS, PS], weight [N, PS, PS]) for each corner, in the order the
    forward sums them."""
    base = geo["box_off"][:, None, None]
    Wi = geo["box_W"].to(torch.int64)[:, None, None]
    y0, y1i = geo["y0"][:, :, None], geo["y1i"][:, :, None]
    x0, x1i = geo["x0"][:, None, :], geo["x1i"][:, None, :]
    wy0, wy1 = geo["wy0"][:, :, None], geo["wy1"][:, :, None]
    wx0, wx1 = geo["wx0"][:, None, :], geo["wx1"][:, None, :]
    return [(base + yy * Wi + xx, wy * wx)
            for yy, wy in ((y0, wy0), (y1i, wy1))
            for xx, wx in ((x0, wx0), (x1i, wx1))]


def _mlra_forward(features, geo, output_size, sampling_ratio):
    """Pooled [N, P, P, C] gathered from the flat pyramid of the [H, W, C]
    maps at ``mlra_geometry``'s samples, fp32 (the JAX forward's promotion
    of the maps by the fp32 weights)."""
    flat = flat_pyramid(features)
    N, C = geo["lvl"].shape[0], flat.shape[-1]
    P, S = output_size, sampling_ratio
    corners = _sample_rows(geo)
    idx, w = corners[0]
    sampled = flat[idx] * w[..., None]
    for idx, w in corners[1:]:
        sampled = sampled + flat[idx] * w[..., None]
    return sampled.reshape(N, P, S, P, S, C).mean(dim=(2, 4))


# the einsum backward chunks the roi axis only above this many bytes of its
# [CH, H, P, C] intermediate
_BWD_INTERMEDIATE_BUDGET_BYTES = 384e6


def _bin_weights(lo, hi, w_lo, w_hi, L, P, S):
    """Fold the bilinear corner weights and the 1/S sample mean into a
    dense [N, P, L] per-axis weight matrix (lo/hi/w_*: [N, P*S])."""
    N = lo.shape[0]
    iota = torch.arange(L, dtype=torch.int64, device=lo.device)
    lo = lo.reshape(N, P, S)
    hi = hi.reshape(N, P, S)
    w_lo = w_lo.reshape(N, P, S)
    w_hi = w_hi.reshape(N, P, S)
    W = ((w_lo[..., None] * (lo[..., None] == iota)).sum(2)
         + (w_hi[..., None] * (hi[..., None] == iota)).sum(2))
    return W / float(S)


def _mlra_backward(grad_pooled: torch.Tensor, geo: Dict[str, torch.Tensor],
                   shapes: Sequence[Tuple[int, int]], dtype: torch.dtype,
                   sampling_ratio: int) -> Tuple[torch.Tensor, ...]:
    """Gradient with respect to the [H, W, C] maps of levels ``shapes``
    without a scatter: the bilinear weights are separable, so per level

        grad_feat[y, x, c] = sum_n,p,q Wy[n,p,y] Wx[n,q,x] g[n,p,q,c]

    is two dense einsums, with the S x S sample mean folded into the
    per-axis bin weights. The roi axis is chunked only where the
    [CH, H, P, C] intermediate would pass the budget. Returns one gradient
    per level in ``dtype``, the maps'."""
    N, P, _, C = grad_pooled.shape
    S = sampling_ratio
    g = grad_pooled.to(torch.float32)
    grads = []
    for l, (H, W) in enumerate(shapes):
        on_l = (geo["lvl"] == l).to(torch.float32)
        Wy = _bin_weights(geo["y0"], geo["y1i"], geo["wy0"], geo["wy1"], H,
                          P, S)
        Wx = _bin_weights(geo["x0"], geo["x1i"], geo["wx0"], geo["wx1"], W,
                          P, S)
        Wy = Wy * on_l[:, None, None]
        per_roi = H * P * C * 4
        CH = int(min(N, max(1, _BWD_INTERMEDIATE_BUDGET_BYTES // per_roi)))
        acc = torch.zeros((H, W, C), dtype=torch.float32, device=g.device)
        for s in range(0, N, CH):
            t = torch.einsum("kpy,kpqc->kyqc", Wy[s:s + CH], g[s:s + CH])
            acc = acc + torch.einsum("kqx,kyqc->yxc", Wx[s:s + CH], t)
        grads.append(acc.to(dtype))
    return tuple(grads)


class _MultilevelRoIAlign(torch.autograd.Function):
    """The counterpart of ``_mlra``'s ``custom_vjp``: the forward gathers
    from the flat pyramid and keeps its sample geometry for the backward,
    which runs K3's wrapper on it. Boxes get a zero gradient."""

    @staticmethod
    def forward(ctx, boxes, cfg, *features):
        shapes = level_shapes(features)
        with torch.autocast(boxes.device.type, enabled=False):
            geo = mlra_geometry(shapes, boxes, *cfg)
            pooled = _mlra_forward(features, geo, cfg[1], cfg[2])
        ctx.keys = tuple(geo)
        ctx.save_for_backward(boxes, *geo.values())
        ctx.shapes, ctx.dtype, ctx.sampling_ratio = (shapes,
                                                     features[0].dtype, cfg[2])
        return pooled.to(features[0].dtype)

    @staticmethod
    def backward(ctx, grad_pooled):
        from crct_tpu_torch.ops import roi_align_kernel
        boxes, *saved = ctx.saved_tensors
        geo = dict(zip(ctx.keys, saved))
        with torch.autocast(boxes.device.type, enabled=False):
            grads = roi_align_kernel.mlra_backward_kernel(
                grad_pooled, geo, ctx.shapes, ctx.dtype, ctx.sampling_ratio)
        box_grad = (torch.zeros_like(boxes) if ctx.needs_input_grad[0]
                    else None)
        return (box_grad, None, *grads)


def multilevel_roi_align(features: Sequence[torch.Tensor],
                         boxes: torch.Tensor, *,
                         strides: Tuple[int, ...] = (4, 8, 16, 32),
                         output_size: int = 7, sampling_ratio: int = 2,
                         canonical_level: int = 4, canonical_size: int = 224,
                         min_level: int = 2, max_level: int = 5
                         ) -> torch.Tensor:
    """FPN RoIAlign: assign each box to a pyramid level by scale (FPN eq. 1)
    and bilinear-sample it at that level only, from one flattened pyramid.

    features: [H_l, W_l, C] maps for levels min_level..max_level (fp32 or
    bf16); boxes: [N, 4] image coordinates. Returns [N, P, P, C] in the
    maps' dtype, differentiable in the maps."""
    cfg = (tuple(strides), output_size, sampling_ratio, canonical_level,
           canonical_size, min_level, max_level)
    return _MultilevelRoIAlign.apply(boxes, cfg, *features)
