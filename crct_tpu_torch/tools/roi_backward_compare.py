"""Measure the RoIAlign backward: K3 against the einsum backward and against
autograd through the plain forward (the port of
``tools/roi_backward_compare.py``).

Times grad-of-sum through ``ops.roi_align.multilevel_roi_align`` (its
autograd Function's backward: K3, ``ops.roi_align_kernel.
mlra_backward_kernel``, on the card; or the separable-einsum backward
``ops.roi_align._mlra_backward``, the JAX package's default, patched in its
place and put back after) against autograd through the plain forward
``_mlra_forward`` (torch transposes its gathers into a scatter-add), at the
production 800px-shortest-edge FPN shapes: canvas 800 x 1088, P2 200 x 272
to P5 25 x 34, 256 channels, 512 rois, box pooling (P 7).

Each time is device time under ``torch.profiler`` (``utils.profiling.
device_ms``, as chip_smoke.py takes it): the CUDA kernels of ``--iters``
grad calls after 3, the host's launching left out (on the CPU: the wall
time of a call). The
three gradients are held against each other (``max_abs_diff``).

Usage: python -m crct_tpu_torch.tools.roi_backward_compare [--rois 512]
       [--device cpu] [--tiny]
"""

from __future__ import annotations

import argparse
import json
from unittest import mock

import numpy as np
import torch

from crct_tpu_torch.utils.profiling import device_ms

STRIDES = (4, 8, 16, 32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rois", type=int, default=512)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true",
                    help="a 64 x 96 canvas at 8 channels (the CPU)")
    args = ap.parse_args(argv)

    from crct_tpu_torch import bench
    from crct_tpu_torch.ops import roi_align as ra
    from crct_tpu_torch.ops import roi_align_kernel
    from crct_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)     # no card: raise before any work
    (H, W), C = ((64, 96), 8) if args.tiny else ((800, 1088), 256)
    n_rois, P = args.rois, 7
    rng = np.random.default_rng(0)
    feats = [torch.from_numpy(rng.random((H // s, W // s, C)).astype(
        np.float32)).to(device).requires_grad_() for s in STRIDES]
    raw = np.sort(rng.random((n_rois, 2, 2)).astype(np.float32), axis=1)
    boxes = torch.from_numpy(np.concatenate(
        [raw[:, 0] * [W, H], raw[:, 1] * [W, H]], axis=1).astype(
            np.float32)).to(device)
    cfg = (STRIDES, P, 2, 4, 224, 2, 5)

    def k3():
        return ra.multilevel_roi_align(feats, boxes, strides=STRIDES,
                                       output_size=P)

    def plain():
        geo = ra.mlra_geometry(ra.level_shapes(feats), boxes, *cfg)
        return ra._mlra_forward(feats, geo, P, 2)

    def grads(forward):
        return torch.autograd.grad(forward().sum(), feats)

    out, got = {}, {}
    with bench.Launches() as launched:
        out["k3_ms"] = device_ms(lambda: grads(k3), device, args.iters)
        got["k3"] = grads(k3)
    with mock.patch.object(roi_align_kernel, "mlra_backward_kernel",
                           ra._mlra_backward):
        out["einsum_ms"] = device_ms(lambda: grads(k3), device, args.iters)
        got["einsum"] = grads(k3)
    out["scatter_ms"] = device_ms(lambda: grads(plain), device, args.iters)
    got["scatter"] = grads(plain)
    for tag in ("k3", "einsum", "scatter"):
        print(f"{tag:8s}: {out[f'{tag}_ms']:.4f} ms/grad ({n_rois} rois, "
              f"{H}x{W} FPN, C {C})", flush=True)
    out["scatter_over_einsum"] = out["scatter_ms"] / out["einsum_ms"]
    out["einsum_over_k3"] = out["einsum_ms"] / out["k3_ms"]
    out["max_abs_diff"] = {
        f"{a}_vs_{b}": max(float((x - y).abs().max())
                           for x, y in zip(got[a], got[b]))
        for a, b in (("k3", "scatter"), ("einsum", "scatter"))}
    out["max_abs_grad"] = max(float(g.abs().max()) for g in got["scatter"])
    out.update(rois=n_rois, hw=[H, W], channels=C,
               k3_launches=launched.record["k3"], **bench.card_info(device))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
