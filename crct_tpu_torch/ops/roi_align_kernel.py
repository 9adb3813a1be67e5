"""Multilevel RoIAlign backward: the CUDA kernel K3 and its plain version.

The port of ``crct_tpu/ops/roi_align_pallas.py`` (the Pallas kernel
``_bwd_kernel``, driven by ``_level_backward`` and
``mlra_backward_pallas``). :func:`mlra_backward_kernel` has the signature
of ``roi_align._mlra_backward``: from the cotangent and the sample geometry
that the forward computed (``roi_align.mlra_geometry``), it returns the
gradient of ``multilevel_roi_align`` with respect to each level's [H, W, C]
map, in the maps' dtype. For tensors on the card it launches the
hand-written kernel ``csrc/roi_align_bwd.cu`` once for all levels (a
zeroed fp32 flat pyramid, fp32 atomics, a cast at the end), with no
fallback: what the kernel does not take raises. For tensors on the CPU it
runs
:func:`mlra_backward_reference`, the transpose of the forward's gather
(``index_add_`` of the weighted samples into the flat pyramid) in fp32.
"""

from __future__ import annotations

import ctypes
import threading
from collections import Counter
from typing import Dict, Sequence, Tuple

import torch

from crct_tpu_torch.ops.roi_align import _sample_rows

MAX_SAMPLES = 64        # P * S rows of shared memory in the kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches, keyed by (P, C); bumped only where the kernel is
# launched, never by the plain version
_COUNT_LOCK = threading.Lock()
LAUNCHES: Counter = Counter()


def launch_count() -> int:
    with _COUNT_LOCK:
        return sum(LAUNCHES.values())


def reset_launch_count() -> None:
    with _COUNT_LOCK:
        LAUNCHES.clear()


def _split_levels(flat: torch.Tensor, shapes, dtype: torch.dtype
                  ) -> Tuple[torch.Tensor, ...]:
    """The flat [sum(H*W), C] gradient as one [H, W, C] view per level, in
    the maps' dtype."""
    C = flat.shape[-1]
    flat = flat.to(dtype)
    parts = torch.split(flat, [h * w for h, w in shapes], dim=0)
    return tuple(part.view(h, w, C) for part, (h, w) in zip(parts, shapes))


def mlra_backward_reference(grad_pooled: torch.Tensor,
                            geo: Dict[str, torch.Tensor],
                            shapes: Sequence[Tuple[int, int]],
                            dtype: torch.dtype, sampling_ratio: int
                            ) -> Tuple[torch.Tensor, ...]:
    """K3's plain version: each sample's four bilinear corners receive
    w_y * w_x / S^2 of the bin's cotangent, summed by ``index_add_`` into a
    fp32 flat pyramid, then cast to the maps' dtype per level."""
    S = sampling_ratio
    C = grad_pooled.shape[-1]
    gs = grad_pooled.to(torch.float32) * (1.0 / (S * S))
    # every sample (p*S + sy, q*S + sx) takes its bin's cotangent
    gs = gs.repeat_interleave(S, dim=1).repeat_interleave(S, dim=2)
    flat = torch.zeros((sum(h * w for h, w in shapes), C),
                       dtype=torch.float32, device=grad_pooled.device)
    for idx, w in _sample_rows(geo):
        flat.index_add_(0, idx.reshape(-1), (gs * w[..., None]).reshape(-1, C))
    return _split_levels(flat, shapes, dtype)


def _check(grad_pooled, geo, shapes, dtype, sampling_ratio):
    dev = grad_pooled.device
    N = geo["lvl"].shape[0]
    P, S = grad_pooled.shape[1], sampling_ratio
    if grad_pooled.dtype not in _DTYPES:
        raise TypeError(f"cotangent must be float32 or bfloat16, got "
                        f"{grad_pooled.dtype}")
    if dtype not in _DTYPES:
        raise TypeError(f"maps must be float32 or bfloat16, got {dtype}")
    if any(v.device != dev for v in geo.values()):
        raise ValueError(f"the geometry must lie on the cotangent's {dev}")
    if grad_pooled.dim() != 4 or tuple(grad_pooled.shape[:3]) != (N, P, P):
        raise ValueError(f"cotangent {tuple(grad_pooled.shape)} must be "
                         f"[{N}, P, P, C]")
    if N < 1 or P * S > MAX_SAMPLES or len(shapes) < 1:
        raise ValueError(f"unsupported shape: N={N} (>= 1), P*S={P * S} "
                         f"(<= {MAX_SAMPLES}), {len(shapes)} levels")


def _kernel():
    from crct_tpu_torch.ops.build import load
    fn = load("roi_align_bwd").roi_align_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    return fn


def mlra_backward_kernel(grad_pooled: torch.Tensor,
                         geo: Dict[str, torch.Tensor],
                         shapes: Sequence[Tuple[int, int]],
                         dtype: torch.dtype, sampling_ratio: int
                         ) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``multilevel_roi_align`` with respect to each level's
    [H, W, C] map (levels of ``shapes``, maps of ``dtype``) from the
    cotangent [N, P, P, C] and the forward's ``mlra_geometry``: K3 on CUDA
    tensors (one launch), the plain version on CPU tensors."""
    if grad_pooled.device.type == "cpu":
        return mlra_backward_reference(grad_pooled, geo, shapes, dtype,
                                       sampling_ratio)
    if grad_pooled.device.type != "cuda":
        raise ValueError(f"no RoIAlign-backward kernel for device "
                         f"{grad_pooled.device}")
    _check(grad_pooled, geo, shapes, dtype, sampling_ratio)
    N, P, _, C = grad_pooled.shape
    S = sampling_ratio
    idx = torch.stack([geo["y0"], geo["y1i"], geo["x0"], geo["x1i"]],
                      dim=1).to(torch.int32).contiguous()
    wts = torch.stack([geo["wy0"], geo["wy1"], geo["wx0"], geo["wx1"]],
                      dim=1).contiguous()
    roi = torch.stack([geo["box_off"], geo["box_W"].to(torch.int64)],
                      dim=1).to(torch.int32).contiguous()
    g = grad_pooled.contiguous()
    flat = torch.zeros((sum(h * w for h, w in shapes), C),
                       dtype=torch.float32, device=g.device)
    fn = _kernel()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = fn(g.data_ptr(), idx.data_ptr(), wts.data_ptr(),
                 roi.data_ptr(), flat.data_ptr(), _DTYPES[g.dtype], N, P, S,
                 C, stream)
    if err != 0:
        raise RuntimeError(f"roi_align_bwd kernel launch failed: CUDA error "
                           f"{err} at N {N}, P {P}, S {S}, C {C}")
    with _COUNT_LOCK:
        LAUNCHES[(P, C)] += 1
    return _split_levels(flat, shapes, dtype)
