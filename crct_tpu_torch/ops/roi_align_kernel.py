"""Multilevel RoIAlign backward: the CUDA kernel K3 and its plain version.

The port of ``crct_tpu/ops/roi_align_pallas.py`` (the Pallas kernel
``_bwd_kernel``, driven by ``_level_backward`` and
``mlra_backward_pallas``). :func:`mlra_backward_kernel` has the signature
of ``roi_align._mlra_backward``: from the cotangent and the sample geometry
that the forward computed (``roi_align.mlra_geometry``), it returns the
gradient of ``multilevel_roi_align`` with respect to each level's [H, W, C]
map, in the maps' dtype. For tensors on the card it launches the
hand-written kernel ``csrc/roi_align_bwd.cu`` once for all levels: each
block owns an output tile and writes it once, in the maps' dtype, with no
zeroing, no atomics and no cast, in a fixed order (the same bits from run
to run). It reads the forward's geometry as it lies, with no fallback: what
the kernel does not take raises. For tensors on the CPU it runs
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

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the geometry the kernel reads, in the order of its arguments: name ->
# (dtype, shape given N and P * S)
_GEOMETRY = {"lvl": (torch.int64, lambda n, ps: (n,)),
             **{k: (torch.int64, lambda n, ps: (n, ps))
                for k in ("y0", "y1i", "x0", "x1i")},
             **{k: (torch.float32, lambda n, ps: (n, ps))
                for k in ("wy0", "wy1", "wx0", "wx1")}}
MAX_LEVELS = 8          # levels of the kernel's launch

# kernel launches, keyed by (cotangent dtype, P, C); bumped only where the kernel is
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
    for key, (want, shape) in _GEOMETRY.items():
        v = geo[key]
        if v.dtype != want:
            raise TypeError(f"geometry {key} must be {want}, got {v.dtype}")
        if v.device != dev:
            raise ValueError(f"the geometry must lie on the cotangent's "
                             f"{dev}, {key} lies on {v.device}")
        if tuple(v.shape) != shape(N, P * S) or not v.is_contiguous():
            raise ValueError(f"geometry {key} {tuple(v.shape)} must be a "
                             f"contiguous {list(shape(N, P * S))}")
    if grad_pooled.dim() != 4 or tuple(grad_pooled.shape[:3]) != (N, P, P):
        raise ValueError(f"cotangent {tuple(grad_pooled.shape)} must be "
                         f"[{N}, P, P, C]")
    C = grad_pooled.shape[3]
    if N < 1 or C < 8 or C % 8 or not 1 <= len(shapes) <= MAX_LEVELS:
        raise ValueError(f"unsupported shape: N={N} (>= 1), C={C} (a "
                         f"multiple of 8), {len(shapes)} levels (1 to "
                         f"{MAX_LEVELS})")


def _library():
    from crct_tpu_torch.ops.build import load
    lib = load("roi_align_bwd")
    lib.roi_align_bwd.restype = ctypes.c_int
    lib.roi_align_bwd.argtypes = ([ctypes.c_void_p] * 12
                                  + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.roi_align_bwd_info.restype = ctypes.c_int
    lib.roi_align_bwd_info.argtypes = ([ctypes.c_int] * 5
                                       + [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_void_p])
    return lib


def _levels(shapes):
    return (ctypes.c_int * (2 * len(shapes)))(*[int(v) for hw in shapes
                                                for v in hw])


def launch_info(P: int, S: int, C: int, dtype_g: torch.dtype,
                dtype: torch.dtype, shapes: Sequence[Tuple[int, int]]
                ) -> Dict[str, int]:
    """The kernel's launch for these shapes and dtypes (cotangent, maps):
    its tile, threads and dynamic shared memory a block, resident blocks an
    SM, grid (tiles, channel chunks) and the rois it stages at once. Needs
    the card."""
    info = (ctypes.c_int * 8)()
    err = _library().roi_align_bwd_info(P, S, C, _DTYPES[dtype_g],
                                        _DTYPES[dtype], _levels(shapes),
                                        len(shapes), info)
    if err != 0:
        raise RuntimeError(f"roi_align_bwd_info failed: CUDA error {err} at "
                           f"P {P}, S {S}, C {C}, levels {list(shapes)}")
    return dict(zip(("tile_y", "tile_x", "threads", "smem_bytes",
                     "blocks_per_sm", "tiles", "channel_chunks", "group"),
                    info))


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
    g = grad_pooled.contiguous()
    flat = torch.empty((sum(h * w for h, w in shapes), C), dtype=dtype,
                       device=g.device)
    fn = _library().roi_align_bwd
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = fn(g.data_ptr(), *(geo[k].data_ptr() for k in _GEOMETRY),
                 flat.data_ptr(), _levels(shapes), len(shapes),
                 _DTYPES[g.dtype], _DTYPES[dtype], N, P, S, C, stream)
    if err != 0:
        raise RuntimeError(f"roi_align_bwd kernel launch failed: CUDA error "
                           f"{err} at N {N}, P {P}, S {S}, C {C}")
    with _COUNT_LOCK:
        LAUNCHES[(str(g.dtype)[6:], P, C)] += 1
    return _split_levels(flat, shapes, dtype)
