"""Fused multi-head attention, forward and backward: CUDA kernels and their
plain versions.

``fused_attention`` is the attention core of both of the JAX package's
attention paths (``crct_tpu/models/layers.py::dot_product_attention``): the
Pallas kernels ``_fwd_kernel`` and ``_bwd_kernel`` of
``crct_tpu/ops/attention.py`` (``-pallas``, reached through
``fused_attention`` / ``_attention`` and its ``custom_vjp``) and the default
XLA path. It computes

    out = (softmax(q k^T / sqrt(D) + mask) * keep / (1 - rate)) v

with fp32 scores and a max-subtracted fp32 softmax, storing the output in
the input dtype. ``mode`` picks the numerics of one of the two paths; they
differ only for bf16 inputs:

- ``ROUND_PROBS`` (the default, JAX's XLA path, layers.py:61-64): the
  normalized fp32 probabilities are rounded to bf16; with dropout the kept
  ones are divided in bf16 by bf16(1 - rate) (0.8984375 at 0.1, JAX's weak
  type); out = P V with fp32 sums, rounded to bf16. Its VJP as JAX's: dv
  from that bf16 P; dP = g v^T rounded to bf16, through the keep and
  bf16(1 - rate) steps in bf16, then the fp32 softmax backward.
- ``PALLAS`` (``-pallas``): P stays fp32 through P.V and dv, the keep
  multiplier is fp32 1/(1 - rate), as in the Pallas kernels.

In fp32 the two are one function (one kernel instance). Its gradient
recomputes the probabilities and regenerates
the same keep mask (the ``torch.autograd.Function`` saves q, k, v, the
mask, the int seed and the rate, never a second draw) and returns dq, dk
and dv by the formulas of ``_bwd_kernel``. For tensors on the card the
forward launches the
hand-written kernel ``csrc/attention_fwd.cu`` (K1) and the backward
``csrc/attention_bwd.cu`` (K2), with no fallback: what a kernel does not take
raises. For tensors on the CPU they run :func:`attention_reference` and
:func:`attention_bwd_reference`, the same math in plain torch ops.

Dropout reproduces the JAX kernels' murmur3 counter hash bit for bit: with
the same int seed ``s`` the port in ``PALLAS`` mode equals
``crct_tpu.ops.attention._attention(q, k, v, mask, [[s]], rate, True)`` and
its VJP. ``ROUND_PROBS`` mode draws from the same hash; JAX's XLA path
draws its keep mask from threefry (``jax.random.bernoulli``), so the two
agree with dropout only given the same mask.

The forward also returns the rows' log-sum-exp (fp32 [B, H, Lq]) when a
gradient will be taken; the Function saves it with the output, and the
backward takes P = exp(s - lse) from it: one pass, no row statistics pass.
delta = sum_j dP * P comes from that pass where the keys fit one tile of
the kernel (ONE_PASS_KEYS, every flagship shape), else from
sum_d g * out (FlashAttention-2).

Bounds on an H100 at the flagship shapes: the text self-attention (H16,
D48, 124 x 124) forward at B = 240 rows does ~11.3 GFLOP; it moves ~366 MB
in fp32 (0.17 ms at the 67 TFLOP/s fp32 rate against 0.11 ms of memory
time: operations bound it) and ~183 MB in bf16 (0.055 ms of memory time
against 0.011 ms at 989 TFLOP/s: bytes bound it). The backward at B = 80
does 9.4 GFLOP against ~214 MB in fp32 (0.14 against 0.064 ms) and ~107 MB
in bf16 (0.010 against 0.032 ms). Both kernels run every product on the
tensor cores (``csrc/attention_common.cuh``): 3xTF32 for fp32 inputs,
fp32-accurate; bf16 products for bf16 inputs, where the score gradients,
and in ``PALLAS`` mode the probabilities, enter split into a bf16 high and
low part (about 16 significant bits, finer than TF32, so that they stay
fp32-like as in the JAX Pallas path). In ``ROUND_PROBS`` mode P is bf16
and P.V and dv take one bf16 product. K1 has four designs, picked by
dtype, mode and shape (:func:`fwd_design`): with bf16 inputs in either
mode, up to 128 keys and D a multiple of 8 (every bf16 train, eval and
serve step at the flagship shapes) one pass over the whole key row on
Hopper's ``wgmma`` and TMA copies (in ``PALLAS`` mode P as bf16 hi + lo,
two register-A products a k-step); with fp32 inputs, up to 128 keys, D a
multiple of 4 and at most 64 (every fp32 serve, eval and ingest step at
the flagship shapes) the same pass on TF32 ``wgmma`` in 3xTF32, Q and P
the register A operands, K and V^T split into TF32 hi and lo tiles; past
128 keys in ``ROUND_PROBS`` mode two ``mma.sync`` passes over the key
tiles, the first for the rows' max and sum, so that it rounds the
normalized P as JAX does; the rest an ``mma.sync`` online softmax. K2 has
five (:func:`bwd_design`): with
bf16 inputs in either mode, up to 128 keys and D a multiple of 8 (every
bf16 train step at the flagship shapes) a warpgroup a 64-key slab on
``wgmma`` and TMA copies, P and dS through shared memory for dv, dk and
dq; with fp32 inputs, up to 128 keys, D a multiple of 4 and at most 48
(every flagship shape but the vision self-attention's D 64) the same layout
on TF32 ``wgmma`` in 3xTF32, P and dS the register A operands of dv and dk
and dS through shared memory for dq; with fp32 inputs, up to 64 keys and
48 < D <= 64 a multiple of 4 (the vision self-attention) that layout in
persistent blocks of one warpgroup, two an SM, each over (batch, head)
items whose K, V, Q and G TMA copies while the last item's products run,
the raw Q and G tiles (and Q^T and G^T written from them) read as the
truncated high parts of their B operands, dq's K^T split in registers;
else ``mma.sync``, over key tiles past 128 keys (fp32 at D 64 with 65 to
128 keys among them). A
wgmma design takes 16-byte aligned tensors: a misaligned one raises (CUDA
error 716) at its launch, which is not counted.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from collections import Counter
from typing import Optional, Tuple

import numpy as np
import torch

MAX_HEAD_DIM = 128
MAX_KEYS = 1024
# up to this many keys K2 takes delta = sum_j dP * P from its one pass;
# above it (several key tiles) delta = sum_d g * out
ONE_PASS_KEYS = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the numerics of JAX's two attention paths (see above)
ROUND_PROBS = "round_probs"
PALLAS = "pallas"
MODES = (ROUND_PROBS, PALLAS)

# kernel launches of K1 (forward) and K2 (backward), keyed by (dtype name,
# mode, H, Lq, Lk, D), e.g. ("bfloat16", "round_probs", 16, 124, 124, 48);
# bumped only where a kernel is launched, never by the plain versions
_COUNT_LOCK = threading.Lock()
LAUNCHES: Counter = Counter()
BWD_LAUNCHES: Counter = Counter()


def launch_count() -> int:
    """Launches of the forward kernel since the last reset."""
    with _COUNT_LOCK:
        return sum(LAUNCHES.values())


def bwd_launch_count() -> int:
    """Launches of the backward kernel since the last reset."""
    with _COUNT_LOCK:
        return sum(BWD_LAUNCHES.values())


def reset_launch_count() -> None:
    """Set the counts of both kernels to 0."""
    with _COUNT_LOCK:
        LAUNCHES.clear()
        BWD_LAUNCHES.clear()


def _head_block(H: int) -> int:
    """Heads per JAX grid program (crct_tpu/ops/attention.py::_head_block):
    it fixes which dropout stream each head draws from."""
    for hb in (8, 4, 2, 1):
        if H % hb == 0:
            return hb
    return 1


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32), without overflowing
    int64: the constant is split into 16-bit halves."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def _uniform_hash(seed: torch.Tensor, i0: torch.Tensor, i1: torch.Tensor,
                  i2: torch.Tensor) -> torch.Tensor:
    """``_uniform_hash`` of the JAX kernel: U[0,1) floats from the uint32
    murmur3 finalizer of (seed, iota position), written out in int64 and
    masked to 32 bits. All arguments broadcast; values lie in [0, 2**32)."""
    h = _mul32(i0, 0x9E3779B9)
    h = h ^ _mul32(i1, 0x85EBCA6B)
    h = h ^ _mul32(i2, 0xC2B2AE35)
    h = (h + _mul32(seed, 2654435761)) & 0xFFFFFFFF
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    bits = ((h >> 9) | 0x3F800000).to(torch.int32)
    return bits.view(torch.float32) - 1.0


def _kept(shape: Tuple[int, int, int, int], seed: int, rate: float,
          device) -> torch.Tensor:
    """[B,H,Lq,Lk] bool: the JAX kernel's keep draws. Program (b, h // HB)
    of its grid draws from seed + prog * 1000003 over the iota [HB, Lq, Lk]
    with axis 0 = h % HB."""
    B, H, Lq, Lk = shape
    hb = _head_block(H)
    b = torch.arange(B, device=device, dtype=torch.int64).view(B, 1, 1, 1)
    h = torch.arange(H, device=device, dtype=torch.int64).view(1, H, 1, 1)
    prog = b * (H // hb) + h // hb
    prog_seed = ((seed & 0xFFFFFFFF) + _mul32(prog, 1000003)) & 0xFFFFFFFF
    i1 = torch.arange(Lq, device=device, dtype=torch.int64).view(1, 1, Lq, 1)
    i2 = torch.arange(Lk, device=device, dtype=torch.int64).view(1, 1, 1, Lk)
    u = _uniform_hash(prog_seed, h % hb, i1, i2)
    return u >= float(np.float32(rate))


def keep_mask(shape: Tuple[int, int, int, int], seed: int, rate: float,
              device) -> torch.Tensor:
    """[B,H,Lq,Lk] fp32 dropout multipliers (0 or 1/(1-rate)) of the JAX
    kernel's grid (:func:`_kept`)."""
    return _kept(shape, seed, rate, device).to(torch.float32) \
        * _keep_scale(rate)


def _keep_scale(rate: float) -> float:
    """The Pallas kernels' keep multiplier, fp32 1 / (1 - rate)."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def _rounds(dtype: torch.dtype, mode: str) -> bool:
    """Whether ``mode`` rounds P for inputs of ``dtype``: ROUND_PROBS with
    bf16 inputs (in fp32 the two modes are one function)."""
    if mode not in MODES:
        raise ValueError(f"attention mode {mode!r} is not one of {MODES}")
    return mode == ROUND_PROBS and dtype == torch.bfloat16


def keep_divisor(rate: float) -> float:
    """bf16(1 - rate): what JAX's XLA path divides bf16 probabilities by
    (``probs * keep / (1.0 - rate)``, a weak-typed Python float)."""
    return float(torch.tensor(1.0 - rate, dtype=torch.bfloat16))


def _round_dropout(x: torch.Tensor, kept: Optional[torch.Tensor],
                   rate: float) -> torch.Tensor:
    """``x`` rounded to bf16 and, with dropout, its kept entries divided in
    bf16 by bf16(1 - rate) and the others 0, as fp32 (JAX's XLA path:
    layers.py:61-64 forward, and its VJP on dP)."""
    x = x.to(torch.bfloat16).float()
    if kept is None:
        return x
    return torch.where(kept, (x / keep_divisor(rate)).to(torch.bfloat16)
                       .float(), 0.0)


def _scale(D: int) -> float:
    return float(np.float32(1.0 / math.sqrt(D)))


def _scores(q: torch.Tensor, k: torch.Tensor,
            additive_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """[B,H,Lq,Lk] fp32 q k^T * scale + mask."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores * _scale(q.shape[-1])
    if additive_mask is not None:
        scores = scores + additive_mask.float()
    return scores


def _softmax(scores: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The max-subtracted fp32 softmax of the scores and their rows'
    log-sum-exp, [B,H,Lq]."""
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    total = e.sum(dim=-1, keepdim=True)
    return e / total, (m + torch.log(total)).squeeze(-1)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        additive_mask: Optional[torch.Tensor],
                        dropout_rate: float = 0.0, seed: int = 0,
                        return_lse: bool = False, mode: str = ROUND_PROBS):
    """The forward kernel's plain version: the same arguments as
    :func:`fused_attention` and the same math, in plain torch ops. With
    ``return_lse`` it returns (out, lse), lse the fp32 [B,H,Lq] log-sum-exp
    of the rows' scores, as the kernel writes it."""
    probs, lse = _softmax(_scores(q, k, additive_mask))
    if _rounds(q.dtype, mode):
        kept = (_kept(tuple(probs.shape), seed, dropout_rate, probs.device)
                if dropout_rate > 0.0 else None)
        probs = _round_dropout(probs, kept, dropout_rate)
    elif dropout_rate > 0.0:
        probs = probs * keep_mask(tuple(probs.shape), seed, dropout_rate,
                                  probs.device)
    out = torch.matmul(probs, v.float()).to(q.dtype)
    return (out, lse) if return_lse else out


def attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            additive_mask: Optional[torch.Tensor],
                            g: torch.Tensor, dropout_rate: float = 0.0,
                            seed: int = 0, lse: Optional[torch.Tensor] = None,
                            out: Optional[torch.Tensor] = None,
                            mode: str = ROUND_PROBS
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The backward kernel's plain version (the formulas of the JAX
    ``_bwd_kernel``, and in ROUND_PROBS mode with bf16 inputs the rounding
    of the XLA path's VJP): recompute P, regenerate the forward's keep mask
    from the same seed, and return (dq, dk, dv) for the cotangent ``g`` of
    the output, in the input dtype. Given the forward's ``lse``, P is
    exp(s - lse), as the kernel takes it. Given its output ``out`` and more
    than ONE_PASS_KEYS keys, delta = sum_j dP * P is taken as sum_d g * out,
    which equals it (out is (P * keep) v) up to rounding, as the kernel
    does there."""
    scores = _scores(q, k, additive_mask)
    if lse is None:
        probs = _softmax(scores)[0]
    else:
        probs = torch.exp(scores - lse.float().unsqueeze(-1))
    gf = g.float()
    dpd = torch.matmul(gf, v.float().transpose(-1, -2))
    kept = (_kept(tuple(probs.shape), seed, dropout_rate, probs.device)
            if dropout_rate > 0.0 else None)
    if _rounds(q.dtype, mode):
        probs_d = _round_dropout(probs, kept, dropout_rate)
        dp = _round_dropout(dpd, kept, dropout_rate)
    elif kept is not None:
        keep = kept.to(torch.float32) * _keep_scale(dropout_rate)
        probs_d, dp = probs * keep, dpd * keep
    else:
        probs_d, dp = probs, dpd
    dv = torch.matmul(probs_d.transpose(-1, -2), gf)
    if out is None or k.shape[2] <= ONE_PASS_KEYS:
        delta = (dp * probs).sum(dim=-1, keepdim=True)
    else:
        delta = (gf * out.float()).sum(dim=-1, keepdim=True)
    ds = probs * (dp - delta)
    scale = _scale(q.shape[-1])
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           additive_mask: Optional[torch.Tensor], dropout_rate: float,
           seed: int) -> torch.Tensor:
    """Validate what the kernel takes; return the mask as a contiguous
    [B,1,Lm,Lk] fp32 tensor on q's device (zeros when None)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, L, D]")
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if tuple(k.shape) != (B, H, Lk, D) or tuple(v.shape) != (B, H, Lk, D):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"[{B}, {H}, Lk, {D}]")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must share a dtype of float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if min(B, H, Lq, Lk, D) < 1 or D > MAX_HEAD_DIM or Lk > MAX_KEYS:
        raise ValueError(f"unsupported shape: D={D} (1..{MAX_HEAD_DIM}), "
                         f"Lk={Lk} (1..{MAX_KEYS})")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate {dropout_rate} not in [0, 1)")
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is not an int32")
    if additive_mask is None:
        return torch.zeros((B, 1, 1, Lk), dtype=torch.float32, device=q.device)
    if additive_mask.dim() != 4 or additive_mask.shape[1] != 1 \
            or additive_mask.shape[2] not in (1, Lq):
        raise ValueError(f"mask {tuple(additive_mask.shape)} must broadcast "
                         f"to [{B}, 1, 1 or {Lq}, {Lk}]")
    Lm = additive_mask.shape[2]
    return (additive_mask.to(device=q.device, dtype=torch.float32)
            .expand(B, 1, Lm, Lk).contiguous())


@functools.lru_cache(maxsize=None)
def _kernel(name: str, n_ptrs: int):
    """The C entry of ``csrc/<name>.cu``: ``n_ptrs`` pointers (null where
    an optional one is None), the dtype and six shape ints, scale, rate,
    keep scale and the keep divisor's reciprocal, seed, head block and
    whether P is rounded, and the stream."""
    from crct_tpu_torch.ops.build import load
    fn = getattr(load(name), name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    return fn


def _scalars(q: torch.Tensor, dropout_rate: float, seed: int, mode: str):
    """scale, rate, keep scale, the keep divisor's fp32 reciprocal (the
    kernels multiply by it: the same bf16 bits as the division, see
    csrc/attention_common.cuh), seed, head block and the rounding flag as
    the kernels take them (fp32 rounding as in the JAX kernels)."""
    return (_scale(q.shape[-1]), float(np.float32(dropout_rate)),
            _keep_scale(dropout_rate),
            float(np.float32(1.0) / np.float32(keep_divisor(dropout_rate))),
            int(np.int32(seed)), _head_block(q.shape[1]),
            int(_rounds(q.dtype, mode)))


# K1's designs, by the code csrc/attention_fwd.cu's attention_fwd_design
# gives them
FWD_DESIGNS = {0: "mma.sync", 1: "mma.sync two-pass", 2: "wgmma",
               3: "wgmma tf32"}


def fwd_design(dtype: torch.dtype, mode: str, Lk: int, D: int) -> str:
    """The design of K1 that a launch at (dtype, mode, Lk, D) takes, as
    the kernel's C entry picks it (it builds the kernel at first use)."""
    from crct_tpu_torch.ops.build import load
    fn = load("attention_fwd").attention_fwd_design
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4
    code = fn(_DTYPES[dtype], int(_rounds(dtype, mode)), Lk, D)
    if code not in FWD_DESIGNS:
        raise ValueError(f"no K1 design for {dtype}, Lk {Lk}, D {D}")
    return FWD_DESIGNS[code]


# K2's designs, by the code csrc/attention_bwd.cu's attention_bwd_design
# gives them
BWD_DESIGNS = {0: "mma.sync", 1: "mma.sync key tiles", 2: "wgmma",
               3: "wgmma tf32", 4: "wgmma tf32 tma"}


def bwd_design(dtype: torch.dtype, mode: str, Lk: int, D: int) -> str:
    """The design of K2 that a launch at (dtype, mode, Lk, D) takes, as
    the kernel's C entry picks it (it builds the kernel at first use)."""
    from crct_tpu_torch.ops.build import load
    fn = load("attention_bwd").attention_bwd_design
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4
    code = fn(_DTYPES[dtype], int(_rounds(dtype, mode)), Lk, D)
    if code not in BWD_DESIGNS:
        raise ValueError(f"no K2 design for {dtype}, Lk {Lk}, D {D}")
    return BWD_DESIGNS[code]


def _launch(q, k, v, mask, dropout_rate: float, seed: int, with_lse: bool,
            mode: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1: (out, lse), lse None unless ``with_lse``."""
    fn = _kernel("attention_fwd", 6)
    B, H, Lq, D = q.shape
    Lk, Lm = k.shape[2], mask.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                 out.data_ptr(), lse.data_ptr() if with_lse else None,
                 _DTYPES[q.dtype], B, H, Lq, Lk, D, Lm,
                 *_scalars(q, dropout_rate, seed, mode), stream)
    if err != 0:
        raise RuntimeError(f"attention_fwd kernel launch failed: CUDA error "
                           f"{err} at q {tuple(q.shape)} {q.dtype}, Lk {Lk}")
    with _COUNT_LOCK:
        LAUNCHES[(str(q.dtype)[6:], mode, H, Lq, Lk, D)] += 1
    return out, lse


@functools.lru_cache(maxsize=None)
def _key_tile(Lq: int, Lk: int, D: int, dtype: torch.dtype) -> int:
    """Keys per key tile of a K2 launch (above it K2 needs a dq scratch)."""
    from crct_tpu_torch.ops.build import load
    fn = load("attention_bwd").attention_bwd_key_tile
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4
    return fn(Lq, Lk, D, _DTYPES[dtype])


def _launch_bwd(q, k, v, mask, g, out, lse, dropout_rate: float, seed: int,
                mode: str) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 from the forward's output ``out`` and log-sum-exp ``lse``."""
    fn = _kernel("attention_bwd", 11)
    B, H, Lq, D = q.shape
    Lk, Lm = k.shape[2], mask.shape[2]
    for name, x in (("cotangent", g), ("output", out)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} {tuple(x.shape)} {x.dtype} must match "
                             f"q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, H, Lq) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype} must be "
                         f"float32 [{B}, {H}, {Lq}]")
    g, out, lse = g.contiguous(), out.contiguous(), lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dq_acc = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
              if Lk > _key_tile(Lq, Lk, D, q.dtype) else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                 g.data_ptr(), out.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(),
                 dq_acc.data_ptr() if dq_acc is not None else None,
                 _DTYPES[q.dtype], B, H, Lq, Lk, D, Lm,
                 *_scalars(q, dropout_rate, seed, mode), stream)
    if err != 0:
        raise RuntimeError(f"attention_bwd kernel launch failed: CUDA error "
                           f"{err} at q {tuple(q.shape)} {q.dtype}, Lk {Lk}")
    with _COUNT_LOCK:
        BWD_LAUNCHES[(str(q.dtype)[6:], mode, H, Lq, Lk, D)] += 1
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """The counterpart of ``_attention``'s ``custom_vjp``: the forward
    saves q, k, v, the mask, the int seed, the rate and the mode, and, where
    a gradient will be taken, its output and the rows' log-sum-exp; the
    backward regenerates the keep mask from that seed. With ``kernels`` the
    two directions launch K1 and K2, else they run the plain versions. The
    mask and the seed get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, dropout_rate: float, seed: int,
                kernels: bool, mode: str):
        ctx.dropout_rate, ctx.seed, ctx.kernels = dropout_rate, seed, kernels
        ctx.mode = mode
        grad = any(ctx.needs_input_grad[:3])
        with torch.autocast(q.device.type, enabled=False):
            if kernels:
                out, lse = _launch(q, k, v, mask, dropout_rate, seed, grad,
                                   mode)
            else:
                out, lse = attention_reference(q, k, v, mask, dropout_rate,
                                               seed, True, mode)
        if grad:
            ctx.save_for_backward(q, k, v, mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, lse = ctx.saved_tensors
        with torch.autocast(q.device.type, enabled=False):
            if ctx.kernels:
                grads = _launch_bwd(q, k, v, mask, g, out, lse,
                                    ctx.dropout_rate, ctx.seed, ctx.mode)
            else:
                grads = attention_bwd_reference(q, k, v, mask, g,
                                                ctx.dropout_rate, ctx.seed,
                                                lse, out, ctx.mode)
        return (*grads, None, None, None, None, None)


def attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      additive_mask: Optional[torch.Tensor],
                      dropout_rate: float = 0.0, seed: int = 0,
                      mode: str = ROUND_PROBS
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of :func:`fused_attention` without a gradient: K1 with
    its log-sum-exp on CUDA tensors, the plain version on CPU tensors."""
    mask = _check(q, k, v, additive_mask, dropout_rate, seed)
    if q.is_cuda:
        return _launch(q, k, v, mask, dropout_rate, seed, True, mode)
    return attention_reference(q, k, v, mask, dropout_rate, seed, True, mode)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    additive_mask: Optional[torch.Tensor],
                    dropout_rate: float = 0.0, seed: int = 0,
                    mode: str = ROUND_PROBS) -> torch.Tensor:
    """Attention core over [B, H, L, D] with an additive mask that broadcasts
    to [B, 1, 1 or Lq, Lk], differentiable in q, k and v. On CUDA tensors:
    the kernels, forward and backward; on CPU tensors: their plain
    versions. ``seed`` (int32) picks the dropout mask, ``mode`` the
    numerics (ROUND_PROBS or PALLAS)."""
    mask = _check(q, k, v, additive_mask, dropout_rate, seed)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no attention kernel for device {q.device}")
    return _Attention.apply(q, k, v, mask, dropout_rate, seed, q.is_cuda,
                            mode)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    additive_mask: Optional[torch.Tensor],
                    dropout_rate: float = 0.0, seed: int = 0,
                    mode: str = ROUND_PROBS) -> torch.Tensor:
    """:func:`fused_attention` through the plain versions on any device,
    forward and backward: what the kernels are held against on the card.
    The port's modules never call it."""
    mask = _check(q, k, v, additive_mask, dropout_rate, seed)
    return _Attention.apply(q, k, v, mask, dropout_rate, seed, False, mode)
