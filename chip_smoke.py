#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (crct_tpu_torch) on one card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py [--tree DIR] [--phases LIST] [--seeds N]

With no arguments it runs every phase below on the port beside it. --tree
drives another checkout's crct_tpu_torch instead, --phases a comma-separated
subset (plus "times": K1 and K2 timed through fused_attention alone, and K3
through mlra_backward_kernel, at the flagship shapes in both dtypes, as the
kernel phase times them), and --seeds
the generator seeds of each cross-check step; such a run prints each phase's
result as a JSON line and not the result line. Comparing two checkouts on
one card: parent, change, change, parent, with --phases times,cross.

Phases, one line each (any failure exits non-zero):
  1. device  - the card's name and power limit, as nvidia-smi gives them;
  2. build   - nvcc builds the kernels from crct_tpu_torch/csrc/
               attention_{fwd,bwd}.cu and roi_align_bwd.cu for sm_90a, all
               at once, and reports their registers and shared memory;
  3. kernel  - the forward kernel (K1) against its plain PyTorch version at
               the four flagship attention shapes (B = 240 rows), output and
               log-sum-exp, and the backward kernel (K2) against its plain
               version at the same shapes at the train batch (B = 80): fp32
               and bf16, key-only and full masks, dropout 0 and 0.1 with one
               seed, and <out, C> = <v, dv> under dropout; K2's shared
               memory, warps and resident blocks; in each dtype, each
               kernel's time, the plain version's, one PyTorch call's (SDPA,
               a yardstick the port never calls) and the least time the card
               could take (for fp32 also at the 3xTF32 rate the kernels
               run); in bf16, how K1's output is rounded against fp64;
  4. serve   - the flagship PlotQA model (config/vilbert.json, random
               weights from a seed, fp32) behind make_server on the card:
               concurrent /v1/answer requests and one /v1/answers batch over
               HTTP, 30 K1 launches per model forward, answers and the
               encoder's hidden states re-computed through the plain
               attention on the card; where one score() spends its time, on
               the host clock and by kernel under torch.profiler;
  5. train   - the same model trained by run_training at batch 80 in bf16
               with dropout 0.1 on a synthetic train split: step time, QA
               pairs/s, losses, exactly 30 K1 and 30 K2 launches a step, peak
               memory, a torch.profiler split of one step, and a checkpoint
               restored with -continue to the same parameters and step;
  6. cross   - one train step from the same weights with dropout on,
               through K1/K2 and through the plain forward and backward
               from the same generator state, in fp32 (loss, every gradient
               and the parameters after the AdamW update) and in bf16 (loss
               and the worst relative L2 gradient difference apart from key
               biases, held at limits set from readings); in bf16 also a
               witness step (plain forward, kernels' backward) and three
               control steps (P and dS rounded to bf16, read; the
               backward's dropout mask from another seed, and another
               dropout draw, both of which the limits must catch);
  7. detector - the PlotQA Mask R-CNN R50-FPN (25 classes, random weights
               from a seed, fp32) trained by DetectorTrainer at batch 2 on
               the 1344 x 1344 canvas, fed by detector_batch_iterator over
               bar charts drawn with numpy, with the RoIAlign backward on
               the kernel K3 (the [kernel] phase holds K3 against its plain
               version in fp32 and bf16, the einsum backward and
               grid_sampler_2d_backward at the box and mask shapes and at
               edge cases, checks two launches bit for bit and one CUDA
               kernel a call, and times it as device time): 2 warm-up and
               10 timed steps with
               exactly 4 K3 launches a step, a torch.profiler split of one
               step, one fp32 step through K3, the einsum backward and K3's
               plain version from the same weights and generator state,
               one --test inference and a checkpoint round trip.
The line before the last holds the kernels' numbers as JSON, a row for each
kernel, shape and dtype; the last line
is {"ok": true, "device": {...}}. With no card, or without the port's
package beside this script, it prints no result and exits non-zero.
"""

import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

HERE = os.path.dirname(os.path.abspath(__file__))
B = 240                       # rows per serve dispatch (resolve_eval_chunk)
B_TRAIN = 80                  # rows per train step (the flagship -batch_size)
SEED = 1234
# attention shapes of the flagship model (config/vilbert.json, 124 text
# tokens, 44 regions): name -> (H, Lq, Lk, D)
SHAPES = {"text": (16, 124, 124, 48), "vision": (16, 44, 44, 64),
          "bi_text_queries": (32, 124, 44, 32),
          "bi_vision_queries": (32, 44, 124, 32)}
# H100 SXM, dense: fp32 on the CUDA cores (the bound of the fp32 rows, as
# in earlier measurements), TF32 and bf16 on the tensor cores
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
# limits of the bf16 cross-check (a whole bf16 train step through K1/K2
# against the plain versions): the loss, and the worst leaf's relative L2
# gradient difference apart from key biases (zero in exact arithmetic, so
# rounding noise). Set between the sound steps' readings (K1/K2, and P and
# dS in bf16: up to 7.9e-5 and 0.069 over three seeds) and the controls'
# that must fail (another dropout draw, 8.9e-4; the backward's mask from
# another seed, 0.20); PERF.md, section 6
BF16_CROSS = {"loss_rel": 2.5e-4, "grad_l2": 0.12}
# the fp32 cross-check's limits: loss, every gradient, parameters after the
# update
FP32_CROSS = {"loss_rel": 1e-5, "grad_all": 1e-4, "param": 1e-6}
LIMIT_NAMES = {"loss_rel": "loss, relative",
               "grad_all": "worst gradient, max |diff| / max |plain|",
               "grad_l2": "worst gradient apart from key biases, relative L2",
               "param": "parameters after AdamW, max |diff|"}
# K1's output and K2's gradients in bf16 may be off an fp64 computation, on
# average, by at most this times the plain versions' error: between the
# kernels' readings (1.0001 of it) and those of a control that rounds P and
# dS to bf16 (1.56-1.59); PERF.md, section 6
ROUNDING = 1.25
# the bf16 cross-check's controls (cross_attentions): name -> (P and dS
# rounded to bf16, the forward's and the backward's dropout seed shift)
CONTROLS = {"control_p": (True, 0, 0), "control_mask": (False, 0, 1),
            "control_draw": (False, 1, 1)}
# the controls that must fail BF16_CROSS: a whole step cannot tell P and dS
# in bf16 from the kernels' own rounding (PERF.md, section 6), so that
# control is held at the kernel level (ROUNDING) and only read here
MUST_FAIL = ("control_mask", "control_draw")
HBM_BYTES_PER_S = 3.35e12
N_CONCURRENT = 24             # concurrent /v1/answer requests
N_BATCH = 8                   # questions in the /v1/answers request
TRAIN_IMAGES = 120            # synthetic figures x 4 questions x 2 (the
                              # negatives) = 960 items: 12 steps of 80
KERNELS = ("attention_fwd", "attention_bwd", "roi_align_bwd")
PHASES = ("kernel", "serve", "train", "cross", "detector")
# the detector: the PlotQA Mask R-CNN R50-FPN of crct_tpu.cli.detector_train
# (1344 canvas, batch 2, 256 sampled rois an image, 64 of them to the mask
# branch); 25 classes as the JAX package's production detector bench
CANVAS = 1344
DET_BATCH = 2
DET_CLASSES = 25
DET_STEPS = 12                # 2 warm-up + 10 timed
DET_IMAGES = 8
C_FPN = 256
ROI_STRIDES = (4, 8, 16, 32)
# RoIAlign backward calls of a train step: name -> (P, rois per image)
ROI_SHAPES = {"box": (7, 256), "mask": (14, 64)}


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def device_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def bound(flops, nbytes, dtype, rate=None):
    """(bound ms, what bounds it): FLOPs at the card's peak for the dtype
    (or at ``rate`` FLOP/s) against bytes at its memory rate."""
    t_ops = flops / (rate or PEAK_FLOPS[dtype]) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def kernel_row(kernel, name, dtype, err, times, flops, nbytes):
    """One row of the kernels' JSON line (launches are filled in later).
    fp32 rows also get the bound at the rate of fp32-accurate products on
    the tensor cores, 3xTF32 (a third of the TF32 rate), as the kernels run
    them."""
    dname = str(dtype)[6:]
    bound_ms, bound_by = bound(flops, nbytes, dname)
    row = {
        "name": f"attention_{kernel}[{name}"
                + ("" if dname == "float32" else f",{dname}") + "]",
        "route": "cuda",
        "source": f"crct_tpu_torch/csrc/attention_{kernel}.cu",
        "replaces": "crct_tpu/ops/attention.py:"
                    + ("82" if kernel == "fwd" else "96"),
        "dtype": dname, "max_abs_err": err, **times,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    if dname == "float32":
        row["bound_3xtf32_ms"], row["bound_3xtf32_by"] = bound(
            flops, nbytes, dname, PEAK_FLOPS["tf32"] / 3)
    return row


def device_ms(fn, name=None, iters=20, warmup=3):
    """Mean device time of one call, ms: the time of its CUDA kernels (those
    whose name holds ``name``, if given) under torch.profiler over ``iters``
    calls after ``warmup``. The host's time to launch them is left out:
    through Python wrappers it exceeds the smaller kernels' own time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and (name is None or name in e.key))
    return us / 1e3 / iters


def fwd_ms(attention, q, k, v, mask):
    """Device ms of a K1 launch: a forward of fused_attention without a
    gradient."""
    return device_ms(lambda: attention.fused_attention(q, k, v, mask),
                     "attention_fwd")


def backward_ms(fn, g, inputs, name=None):
    """Device ms of autograd's backward of fn(*inputs) alone (the forward's
    graph kept), for the cotangent g."""
    import torch
    leaves = [x.detach().requires_grad_() for x in inputs]
    out = fn(*leaves)
    return device_ms(lambda: torch.autograd.grad(out, leaves, g,
                                                 retain_graph=True), name)


def bwd_ms(attention, q, k, v, mask, g):
    """Device ms of a K2 launch: the backward of one fused_attention forward,
    so that any checkout's K2 times the same way."""
    return backward_ms(lambda *x: attention.fused_attention(*x, mask), g,
                       (q, k, v), "attention_bwd")


def attention_math(q, k, v, mask, g=None, keep=None, bwd_keep=None,
                   round_p=None):
    """Attention's output, and with the cotangent g its gradients (out, dq,
    dk, dv), by the plain formulas in q's floating type (fp32 or fp64),
    with P and dS passed through ``round_p`` before the products that take
    them, the forward's dropout multipliers ``keep`` and the backward's
    ``bwd_keep`` (the forward's where None): the reference and the controls
    that the rounding and cross-checks hold the kernels beside."""
    import torch
    r = round_p or (lambda x: x)
    scale = 1.0 / math.sqrt(q.shape[-1])
    if q.dtype == torch.float32:
        scale = float(torch.tensor(scale, dtype=torch.float32))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    p = torch.softmax(s if mask is None else s + mask.to(q.dtype), -1)
    out = torch.matmul(r(p if keep is None else p * keep), v)
    if g is None:
        return out
    keep = keep if bwd_keep is None else bwd_keep
    pd, dp = p, torch.matmul(g, v.transpose(-1, -2))
    if keep is not None:
        pd, dp = p * keep, dp * keep
    dv = torch.matmul(r(pd).transpose(-1, -2), g)
    ds = r(p * (dp - (dp * p).sum(-1, keepdim=True)))
    return (out, torch.matmul(ds, k) * scale,
            torch.matmul(ds.transpose(-1, -2), q) * scale, dv)


def bf16_round(x):
    return x.bfloat16().float()


def hold_rounding(what, rnd, failures):
    """The kernels' bf16 results within ROUNDING of the plain versions'
    error against fp64, and the control (P and dS in bf16) outside it."""
    got, plain, ctrl = rnd
    if not got <= ROUNDING * plain:
        failures.append(f"{what} bf16: mean error against fp64 {got} > "
                        f"{ROUNDING} x the plain version's {plain}")
    if not ctrl > ROUNDING * plain:
        failures.append(f"{what} bf16: the control (P and dS in bf16) is "
                        f"within {ROUNDING} x the plain version's error "
                        f"({ctrl} against {plain}): the check cannot see it")


def rounding_note(rnd):
    return ("" if rnd is None else
            f"; mean error against fp64, relative: kernel {rnd[0]:.5g}, "
            f"plain {rnd[1]:.5g}, control (P, dS in bf16) {rnd[2]:.5g} "
            f"(limit {ROUNDING:g} x plain)")


def rounding(attention, q, k, v, mask, g=None):
    """How bf16 results are rounded: the mean |error| against an fp64
    computation, relative to the fp64 results' mean magnitude (averaged over
    dq, dk and dv with the cotangent g), of the kernels' (K1's output, or
    K2's gradients), of the plain versions', and of a control's: the plain
    formulas with P (and dS) rounded to bf16 before the products that take
    them."""
    import torch
    d = [x.double() for x in (q, k, v)]
    exact = attention_math(*d, mask.double(),
                           None if g is None else g.double())
    ctrl = attention_math(*(x.float() for x in (q, k, v)), mask,
                          None if g is None else g.float(),
                          round_p=bf16_round)
    if g is None:
        got = (attention.fused_attention(q, k, v, mask),)
        plain = (attention.attention_reference(q, k, v, mask),)
        exact, ctrl = (exact,), (ctrl,)
    else:
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        got = torch.autograd.grad(
            attention.fused_attention(*leaves, mask), leaves, g)
        plain = attention.attention_bwd_reference(q, k, v, mask, g)
        exact, ctrl = exact[1:], ctrl[1:]
    ctrl = [x.to(q.dtype) for x in ctrl]

    def err(xs):
        return sum(((x.double() - e).abs().mean() / e.abs().mean()).item()
                   for x, e in zip(xs, exact)) / len(exact)
    return err(got), err(plain), err(ctrl)


def kernel_times(attention):
    """Phase times: device ms of a K1 launch at B rows and K2 at B_TRAIN at
    the four flagship shapes in fp32 and bf16 (key-only mask, no dropout),
    through fused_attention alone, as the kernel phase times them: the
    phase that compares two checkouts (--tree) on one card."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(SEED)
    ms = {}
    for name, (H, Lq, Lk, D) in SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            def inputs(rows):
                q, k, v, gr = (torch.randn(rows, H, L, D, device="cuda",
                                           generator=g).to(dtype)
                               for L in (Lq, Lk, Lk, Lq))
                mask = torch.where(torch.rand(rows, 1, 1, Lk, device="cuda",
                                              generator=g) < 0.2,
                                   -10000.0, 0.0)
                return q, k, v, gr, mask
            q, k, v, _, mask = inputs(B)
            k1 = fwd_ms(attention, q, k, v, mask)
            q, k, v, gr, mask = inputs(B_TRAIN)
            ms[f"{name},{str(dtype)[6:]}"] = {
                "fwd": k1, "bwd": bwd_ms(attention, q, k, v, mask, gr)}
    return ms


def check_kernel(attention, name, shape, failures):
    """K1 against its plain version at one flagship shape, fp32 and bf16,
    key-only and full masks, dropout 0 and 0.1: the output (through
    fused_attention, which skips the log-sum-exp without a gradient) and
    the output and log-sum-exp of attention_forward (tolerance 1e-5 of
    max(1, |lse|)). Its timings and bound in each dtype (key-only mask, no
    dropout: the serve case)."""
    import torch
    import torch.nn.functional as F
    H, Lq, Lk, D = shape
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        worst, worst_lse = 0.0, 0.0
        for full in (False, True):
            for rate in (0.0, 0.1):
                q, k, v = (torch.randn(B, H, L, D, device="cuda",
                                       generator=g).to(dtype)
                           for L in (Lq, Lk, Lk))
                mask = torch.where(torch.rand(B, 1, Lq if full else 1, Lk,
                                              device="cuda", generator=g)
                                   < 0.2, -10000.0, 0.0)
                got = attention.fused_attention(q, k, v, mask, rate, SEED)
                got2, lse = attention.attention_forward(q, k, v, mask, rate,
                                                        SEED)
                want, want_lse = attention.attention_reference(
                    q, k, v, mask, rate, SEED, return_lse=True)
                torch.cuda.synchronize()
                err = max((x.float() - want.float()).abs().max().item()
                          for x in (got, got2))
                err_lse = (lse - want_lse).abs().max().item()
                top = max(1.0, want_lse.abs().max().item())
                case = (f"{name} {str(dtype)[6:]} "
                        f"{'full' if full else 'key-only'} mask rate {rate}")
                if not err <= tol:
                    failures.append(f"{case}: max abs err {err} > {tol}")
                if not err_lse <= 1e-5 * top:
                    failures.append(f"{case}: lse off by {err_lse} > 1e-5 x "
                                    f"{top}")
                worst, worst_lse = max(worst, err), max(worst_lse,
                                                        err_lse / top)

        q, k, v = (torch.randn(B, H, L, D, device="cuda",
                               generator=g).to(dtype)
                   for L in (Lq, Lk, Lk))
        mask = torch.where(torch.rand(B, 1, 1, Lk, device="cuda",
                                      generator=g) < 0.2, -10000.0, 0.0)
        times = {
            "ms": fwd_ms(attention, q, k, v, mask),
            "plain_ms": device_ms(lambda: attention.attention_reference(
                q, k, v, mask)),
            "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask.to(dtype))),
        }
        flops = 4.0 * B * H * Lq * Lk * D
        # q, k, v, out in the dtype; the key-only fp32 mask
        nbytes = (q.element_size() * (2 * B * H * Lq * D + 2 * B * H * Lk * D)
                  + 4.0 * B * Lk)
        rnd = None
        if dtype != torch.float32:
            rnd = rounding(attention, q, k, v, mask)
            hold_rounding(f"K1 {name}", rnd, failures)
        rows.append((kernel_row("fwd", name, dtype, worst, times, flops,
                                nbytes), flops, nbytes, worst_lse, rnd))
    return rows


def check_bwd_kernel(attention, name, shape, failures):
    """K2 against its plain version at one flagship shape at the train
    batch, fp32 and bf16, key-only and full masks, dropout 0 and 0.1: the
    gradients of fused_attention (K1 then K2 on K1's output and
    log-sum-exp) against attention_bwd_reference recomputing everything.
    The fp32 tolerance is 1e-5 of the larger of 1 and the largest gradient
    magnitude, bf16's 2e-2 of it. Its timings and bound in each dtype
    (key-only mask, no dropout): K2 through autograd's backward, the plain
    version as the autograd Function runs it on CPU tensors (from K1's
    output and lse), SDPA's backward alone."""
    import torch
    import torch.nn.functional as F
    H, Lq, Lk, D = shape
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def inputs(dtype, full):
        q, k, v, gr = (torch.randn(B_TRAIN, H, L, D, device="cuda",
                                   generator=g).to(dtype)
                       for L in (Lq, Lk, Lk, Lq))
        mask = torch.where(torch.rand(B_TRAIN, 1, Lq if full else 1, Lk,
                                      device="cuda", generator=g)
                           < 0.2, -10000.0, 0.0)
        return q, k, v, gr, mask

    rows = []
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        worst = 0.0
        for full in (False, True):
            for rate in (0.0, 0.1):
                q, k, v, gr, mask = inputs(dtype, full)
                leaves = [x.requires_grad_() for x in (q, k, v)]
                out = attention.fused_attention(*leaves, mask, rate, SEED)
                got = torch.autograd.grad(out, leaves, gr)
                want = attention.attention_bwd_reference(q, k, v, mask, gr,
                                                         rate, SEED)
                torch.cuda.synchronize()
                err = max((a.float() - w.float()).abs().max().item()
                          for a, w in zip(got, want))
                top = max(w.float().abs().max().item() for w in want)
                case = (f"{name} {str(dtype)[6:]} "
                        f"{'full' if full else 'key-only'} mask rate {rate}")
                if not err <= tol * max(1.0, top):
                    failures.append(f"K2 {case}: max abs err {err} > {tol} "
                                    f"x max(1, {top})")
                worst = max(worst, err)

        q, k, v, gr, mask = inputs(dtype, False)
        out, lse = attention.attention_forward(q, k, v, mask)
        times = {
            "ms": bwd_ms(attention, q, k, v, mask, gr),
            "plain_ms": device_ms(lambda: attention.attention_bwd_reference(
                q, k, v, mask, gr, lse=lse, out=out)),
            # SDPA's backward alone
            "library_ms": backward_ms(
                lambda *x: F.scaled_dot_product_attention(
                    *x, attn_mask=mask.to(dtype)), gr, (q, k, v)),
        }
        flops = 10.0 * B_TRAIN * H * Lq * Lk * D
        # q, g, dq; k, v, dk, dv in the dtype; the key-only fp32 mask
        nbytes = (q.element_size() * (3 * B_TRAIN * H * Lq * D
                                      + 4 * B_TRAIN * H * Lk * D)
                  + 4.0 * B_TRAIN * Lk)
        rnd = None
        if dtype != torch.float32:
            rnd = rounding(attention, q, k, v, mask, gr)
            hold_rounding(f"K2 {name}", rnd, failures)
        rows.append((kernel_row("bwd", name, dtype, worst, times, flops,
                                nbytes), flops, nbytes, rnd))

    # out is linear in v: <out, C> = <v, dv> only with the forward's mask
    q, k, v, gr, mask = inputs(torch.float32, False)
    v.requires_grad_()
    out = attention.fused_attention(q, k, v, mask, 0.1, SEED)
    (dv,) = torch.autograd.grad(out, (v,), gr)
    lhs = (out.double() * gr.double()).sum().item()
    rhs = (v.double() * dv.double()).sum().item()
    if not abs(lhs - rhs) <= 1e-5 * abs(lhs):
        failures.append(f"K2 {name}: <out,C> {lhs} != <v,dv> {rhs}")
    return rows, abs(lhs - rhs) / abs(lhs)


def post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        body = json.loads(resp.read())
        return resp.status, body, (time.perf_counter() - t0) * 1e3


def check_rec(rec, failures, where):
    conf = rec.get("confidence")
    if rec.get("answer") is None:
        failures.append(f"{where}: null answer {rec}")
    elif not (isinstance(conf, float) and math.isfinite(conf)
              and 0.0 <= conf <= 1.0):
        failures.append(f"{where}: confidence {conf!r} not in [0, 1]")


def compare_scoring(kernel_recs, plain_recs, failures):
    """Kernel vs plain attention on the same questions: per-candidate NSP
    probabilities within 1e-4 and the same chosen answers (a different
    choice passes only as a tie within 1e-4 of the plain maximum)."""
    worst, ties = 0.0, 0
    for kr, pr in zip(kernel_recs, plain_recs):
        kp = {t["answer"]: t["confidence"] for t in kr["top"]}
        pp = {t["answer"]: t["confidence"] for t in pr["top"]}
        if set(kp) != set(pp):
            failures.append(f"candidate sets differ for {kr['question']!r}")
            continue
        worst = max(worst, max(abs(kp[a] - pp[a]) for a in kp))
        if kr["cls_output"] != pr["cls_output"]:
            if pp[pr["cls_output"]] - pp[kr["cls_output"]] <= 1e-4:
                ties += 1
            else:
                failures.append(f"answers differ for {kr['question']!r}: "
                                f"{kr['cls_output']!r} vs "
                                f"{pr['cls_output']!r}")
    if worst > 1e-4:
        failures.append(f"NSP probabilities differ by {worst} > 1e-4")
    return worst, ties


def breakdown(scorer, qas, card):
    """Where one score() of a coalesced batch spends its time: the model
    forwards (host clock around each, synchronized) against the rest
    (example building, collate, transfers, argmax), on the host clock."""
    import torch
    forward_ms = []
    step = scorer.eval_step

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        forward_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    scorer.eval_step = timed
    try:
        t0 = time.perf_counter()
        scorer.score(qas)
        total = (time.perf_counter() - t0) * 1e3
    finally:
        scorer.eval_step = step
    fwd = sum(forward_ms)
    return (f"one score() of {len(qas)} questions: {total:.1f} ms, of which "
            f"{len(forward_ms)} model forwards {fwd:.1f} ms "
            f"({', '.join(f'{m:.1f}' for m in forward_ms)}) and "
            f"{total - fwd:.1f} ms on the host ({card})")


def matmul_flops_per_row(cfg, lt=124, lv=44):
    """FLOPs of the matrix products of one candidate row's forward outside
    the attention kernel (embedding and encoder projections, FFNs), counted
    from the model config at lt text tokens and lv regions."""
    t, v, bi = cfg.hidden_size, cfg.v_hidden_size, cfg.bi_hidden_size
    ti, vi = cfg.intermediate_size, cfg.v_intermediate_size
    text = lt * (4 * t * t + 2 * t * ti)
    vision = lv * (4 * v * v + 2 * v * vi)
    co = (lv * (3 * v * bi + bi * v + 2 * v * vi)
          + lt * (3 * t * bi + bi * t + 2 * t * ti))
    emb = lv * (cfg.v_feature_size + 4) * v + lt * 4 * t
    macs = (cfg.num_hidden_layers * text + cfg.v_num_hidden_layers * vision
            + len(cfg.v_biattention_id) * co + emb)
    return 2 * macs


def device_profile(scorer, qas, card):
    """Device time of one score() by kernel, from torch.profiler: the busy
    share of the wall time (under the profiler), the attention kernel's,
    the matrix products' and the other kernels' parts of it, and the rate
    of the matrix products."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    dispatches = scorer.dispatches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scorer.score(qas)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = (scorer.dispatches - dispatches) * scorer.chunk
    mm_flops = rows * matmul_flops_per_row(scorer.model.config)
    groups = {"attention_fwd": 0.0, "matmul": 0.0, "other": 0.0}
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        kernels.append((ms, e.count, e.key))
        low = e.key.lower()
        if "attention_fwd" in low:
            groups["attention_fwd"] += ms
        elif any(s in low for s in ("gemm", "cutlass", "xmma", "matmul")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    busy = sum(groups.values())
    if busy <= 0:
        return "device time: not measured (the profiler recorded none)"
    top = "; ".join(f"{k[:60]} x{n} {ms:.1f} ms"
                    for ms, n, k in sorted(kernels, reverse=True)[:4])
    rate = (f"{mm_flops / groups['matmul'] / 1e9:.1f} TFLOP/s"
            if groups["matmul"] > 0 else "not measured")
    return (f"device time of one score() of {len(qas)} questions: busy "
            f"{busy:.1f} of {wall_ms:.1f} ms wall under the profiler "
            f"({100 * busy / wall_ms:.1f}%): "
            + ", ".join(f"{g} {ms:.1f} ms ({100 * ms / busy:.1f}%)"
                        for g, ms in groups.items())
            + f"; matrix products: {mm_flops / 1e12:.2f} TFLOP over {rows} "
            f"rows at {rate} (fp32 without TF32); top kernels: {top} "
            f"({card})")


def hidden_state_check(scorer, qas, attention, failures):
    """The encoder's final hidden states over the first dispatch of these
    questions, kernel against plain attention on the same inputs: O(1)
    values after LayerNorm, so a wrong attention shows here even where the
    NSP probabilities of a randomly initialised model barely move."""
    import torch
    from crct_tpu_torch.models import layers
    encoder = scorer.model.bert.encoder
    seen = []
    handle = encoder.register_forward_hook(
        lambda mod, args, out: seen.append((args, out)))
    try:
        scorer.score(qas)
    finally:
        handle.remove()
    args, (t_kernel, v_kernel) = seen[0]
    with torch.inference_mode(), mock.patch.object(
            layers, "fused_attention", attention.attention_reference):
        t_plain, v_plain = encoder(*args)
    err = max((t_kernel - t_plain).abs().max().item(),
              (v_kernel - v_plain).abs().max().item())
    if not err <= 1e-4:
        failures.append(f"encoder hidden states differ by {err} > 1e-4")
    return err, tuple(t_kernel.shape), tuple(v_kernel.shape)


def serve(card, attention, failures):
    """Phase 4: the flagship model behind make_server, over HTTP."""
    import numpy as np
    import torch

    from crct_tpu_torch.config import CRCTModelConfig, default_params
    from crct_tpu_torch.data.synthetic import generate_dataset
    from crct_tpu_torch.models import layers
    from crct_tpu_torch.serve import make_server

    model_config = os.path.join(HERE, "config", "vilbert.json")
    cfg = CRCTModelConfig.from_json_file(model_config)
    per_forward = {"text": cfg.num_hidden_layers,
                   "vision": cfg.v_num_hidden_layers,
                   "bi_text_queries": len(cfg.v_biattention_id),
                   "bi_vision_queries": len(cfg.v_biattention_id)}
    with tempfile.TemporaryDirectory(prefix="crct_smoke_") as root:
        data = generate_dataset(os.path.join(root, "data"), n_images=8,
                                division=4, n_questions=4, feat_dim=1024,
                                splits=("test",), seed=SEED)
        params = default_params(
            figure_feat_path=data["figure_feat_path"],
            qa_parent_dir=data["qa_parent_dir"], dataset_config=data,
            eval_set="test", eval_batch_size=None, model_config=model_config,
            seed=SEED, port=0)
        t0 = time.perf_counter()
        server = make_server(params, port=0, device="cuda")
        scorer = server.scorer
        n_params = sum(p.numel() for p in scorer.model.parameters())
        say("serve", f"flagship model ({n_params / 1e6:.1f} M parameters, "
                     f"{scorer.model.compute_dtype}) built, loaded and warmed "
                     f"up in {time.perf_counter() - t0:.1f} s; "
                     f"{scorer.chunk} rows per forward")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        asked = [(img, qi) for img, qas in sorted(server.img_to_qas.items())
                 for qi in range(len(qas))]
        single, batch = asked[:N_CONCURRENT], \
            asked[N_CONCURRENT:N_CONCURRENT + N_BATCH]
        try:
            attention.reset_launch_count()
            scorer.dispatches = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(N_CONCURRENT) as pool:
                replies = list(pool.map(
                    lambda a: post(base + "/v1/answer",
                                   {"image_index": a[0], "question_id": a[1]}),
                    single))
            wall = time.perf_counter() - t0
            status, body, batch_ms = post(base + "/v1/answers", {
                "questions": [{"image_index": i, "question_id": q}
                              for i, q in batch]})
            torch.cuda.synchronize()
            launches = {name: attention.LAUNCHES[("float32", *shape)]
                        for name, shape in SHAPES.items()}
            forwards = scorer.dispatches
            batches = list(server.batcher.batch_sizes)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)

        lat = np.asarray([r[2] for r in replies])
        for st, rec, _ in replies:
            if st != 200:
                failures.append(f"/v1/answer status {st}: {rec}")
            check_rec(rec, failures, "/v1/answer")
        if status != 200 or len(body.get("answers", [])) != len(batch):
            failures.append(f"/v1/answers status {status}: {body}")
        for rec in body.get("answers", []):
            check_rec(rec, failures, "/v1/answers")
        total = attention.launch_count()
        if forwards < 1 or total != sum(per_forward.values()) * forwards:
            failures.append(f"{total} kernel launches for {forwards} model "
                            f"forwards, want {sum(per_forward.values())} "
                            f"per forward")
        for name, n in launches.items():
            if n != per_forward[name] * forwards:
                failures.append(f"{name}: {n} launches for {forwards} "
                                f"forwards, want {per_forward[name]} each")
        say("serve", f"{len(single)} concurrent /v1/answer requests in "
                     f"{wall:.3f} s: {len(single) / wall:.2f} q/s, latency "
                     f"p50 {np.percentile(lat, 50):.1f} ms p95 "
                     f"{np.percentile(lat, 95):.1f} ms; /v1/answers of "
                     f"{len(batch)} in {batch_ms:.1f} ms; coalesced batches "
                     f"{batches}; {forwards} model "
                     f"forwards, {total} attention_fwd launches; peak "
                     f"{peak_gb:.2f} GB allocated ({card})")

        # the same questions, same weights: kernel vs plain attention
        qas = [server.img_to_qas[i][q] for i, q in single + batch]
        kernel_recs = scorer.score(qas, top=1000)
        by_http = {(r["image_index"], r["question"]): r["cls_output"]
                   for r in [rep[1] for rep in replies]
                   + body.get("answers", [])}
        for rec in kernel_recs:
            if by_http[(rec["image_index"], rec["question"])] \
                    != rec["cls_output"]:
                failures.append(f"HTTP and direct answers differ for "
                                f"{rec['question']!r}")
        before = attention.launch_count()
        with mock.patch.object(layers, "fused_attention",
                               attention.attention_reference):
            plain_recs = scorer.score(qas, top=1000)
        if attention.launch_count() != before:
            failures.append("the plain re-score launched the kernel")
        worst, ties = compare_scoring(kernel_recs, plain_recs, failures)
        spread = np.median([max(t["confidence"] for t in r["top"])
                            - min(t["confidence"] for t in r["top"])
                            for r in kernel_recs])
        say("serve", f"re-scored {len(qas)} questions through the plain "
                     f"attention on the card: max NSP probability diff "
                     f"{worst:.3g} (tolerance 1e-4), {ties} near-ties; "
                     f"median spread of a question's candidate "
                     f"probabilities {spread:.3g}")
        err, t_shape, v_shape = hidden_state_check(scorer, qas[:8],
                                                   attention, failures)
        say("serve", f"encoder hidden states {t_shape} and {v_shape} of one "
                     f"dispatch, kernel vs plain attention: max abs diff "
                     f"{err:.3g} (tolerance 1e-4)")
        say("serve", breakdown(scorer, qas[:N_CONCURRENT], card))
        say("serve", device_profile(scorer, qas[:N_CONCURRENT], card))
        return launches


def step_profile(trainer, batch, cfg, card):
    """Device time of one train step by kernel group, from torch.profiler,
    and the busy share of its wall time under the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    trainer.run_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {"gemm": 0.0, "attention_fwd": 0.0, "attention_bwd": 0.0,
              "optimizer": 0.0, "other": 0.0}
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        kernels.append((ms, e.count, e.key))
        low = e.key.lower()
        if "attention_fwd" in low:
            groups["attention_fwd"] += ms
        elif "attention_bwd" in low:
            groups["attention_bwd"] += ms
        elif any(w in low for w in ("gemm", "cutlass", "xmma", "matmul",
                                    "nvjet", "cublas")):
            groups["gemm"] += ms
        elif "multi_tensor" in low or "foreach" in low:
            groups["optimizer"] += ms
        else:
            groups["other"] += ms
    busy = sum(groups.values())
    if busy <= 0:
        return "device time: not measured (the profiler recorded none)", {}
    mm = 3 * B_TRAIN * matmul_flops_per_row(cfg)
    top = "; ".join(f"{k[:60]} x{n} {ms:.2f} ms"
                    for ms, n, k in sorted(kernels, reverse=True)[:5])
    rate = (f"{mm / groups['gemm'] / 1e9:.1f} TFLOP/s"
            if groups["gemm"] > 0 else "not measured")
    line = (f"device time of one train step (batch {B_TRAIN}, bf16): busy "
            f"{busy:.2f} of {wall_ms:.2f} ms wall under the profiler "
            f"({100 * busy / wall_ms:.1f}%): "
            + ", ".join(f"{g} {ms:.2f} ms ({100 * ms / busy:.1f}%)"
                        for g, ms in groups.items())
            + f"; matrix products ~{mm / 1e12:.2f} TFLOP (3 x the forward's) "
            f"at {rate}; top kernels: {top} ({card})")
    return line, dict(groups, busy=busy, wall=wall_ms)


def train_data(root):
    """run_training's params (the flagship model at batch 80, bf16, dropout,
    4 loader workers) and the synthetic train split, made under root."""
    from crct_tpu_torch.config import default_params
    from crct_tpu_torch.data.dataset import ChartQADataset
    from crct_tpu_torch.data.synthetic import generate_dataset
    data = generate_dataset(os.path.join(root, "data"), n_images=TRAIN_IMAGES,
                            division=8, n_questions=4, feat_dim=1024,
                            splits=("train",), seed=SEED)
    params = default_params(
        figure_feat_path=data["figure_feat_path"],
        qa_parent_dir=data["qa_parent_dir"], dataset_config=data,
        model_config=os.path.join(HERE, "config", "vilbert.json"), seed=SEED,
        batch_size=B_TRAIN, num_epochs=1, num_workers=4, no_eval=True,
        bf16=True, save_path=os.path.join(root, "results"), max_seq_len=124,
        max_vis_features=44)
    return params, ChartQADataset(params, ["train"])


def train_batch():
    """The first batch of the train split and its params, for the
    cross-check when the train phase does not run."""
    from crct_tpu_torch.data.dataset import DataLoader
    with tempfile.TemporaryDirectory(prefix="crct_cross_") as root:
        params, dataset = train_data(root)
        loader = DataLoader(dataset, B_TRAIN, shuffle=False, num_workers=1)
        return next(iter(loader)), params


def train(card, attention, failures):
    """Phase 5: the flagship model trained by run_training on the card."""
    import numpy as np
    import torch

    from crct_tpu_torch.config import CRCTModelConfig
    from crct_tpu_torch.data.dataset import DataLoader
    from crct_tpu_torch.train import train_loop
    from crct_tpu_torch.utils.checkpoint import checkpoint_name

    model_config = os.path.join(HERE, "config", "vilbert.json")
    cfg = CRCTModelConfig.from_json_file(model_config)
    per_step = {"text": cfg.num_hidden_layers,
                "vision": cfg.v_num_hidden_layers,
                "bi_text_queries": len(cfg.v_biattention_id),
                "bi_vision_queries": len(cfg.v_biattention_id)}
    with tempfile.TemporaryDirectory(prefix="crct_train_") as root:
        t0 = time.perf_counter()
        params, dataset = train_data(root)
        say("train", f"synthetic train split of {len(dataset)} items "
                     f"({TRAIN_IMAGES} figures, negatives included) in "
                     f"{time.perf_counter() - t0:.1f} s")

        step_ms, launches, metrics = [], [], []
        real_step = train_loop.Trainer.run_step

        def timed_step(self, batch):
            torch.cuda.synchronize()
            k1, k2 = attention.launch_count(), attention.bwd_launch_count()
            t = time.perf_counter()
            m = real_step(self, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            launches.append((attention.launch_count() - k1,
                             attention.bwd_launch_count() - k2))
            metrics.append(m)
            return m

        attention.reset_launch_count()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with mock.patch.object(train_loop.Trainer, "run_step", timed_step):
            trainer = train_loop.run_training(params, dataset, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: (attention.LAUNCHES[("bfloat16", *shape)],
                         attention.BWD_LAUNCHES[("bfloat16", *shape)])
                  for name, shape in SHAPES.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        losses = [float(m[0]) for m in metrics]
        n = len(step_ms)
        want = sum(per_step.values())
        if n < 10:
            failures.append(f"train: {n} steps, want at least 10")
        if not all(math.isfinite(x) for x in losses):
            failures.append(f"train: non-finite losses {losses}")
        if any(k != (want, want) for k in launches):
            failures.append(f"train: (K1, K2) launches per step {launches}, "
                            f"want ({want}, {want})")
        for name, (k1, k2) in counts.items():
            if k1 != per_step[name] * n or k2 != per_step[name] * n:
                failures.append(f"train {name}: {k1} K1 and {k2} K2 "
                                f"launches in {n} steps, want "
                                f"{per_step[name]} each a step")
        median = float(np.median(step_ms[2:])) if n > 2 else float("nan")
        n_params = sum(p.numel() for p in trainer.model.parameters())
        say("train", f"run_training of the flagship model ({n_params / 1e6:.1f}"
                     f" M parameters, fp32 masters, bf16 autocast, dropout "
                     f"{cfg.attention_probs_dropout_prob}) at batch {B_TRAIN}: "
                     f"{n} steps in {wall:.1f} s wall (model build, data "
                     f"workers and the epoch checkpoint included); step ms "
                     f"{', '.join(f'{x:.1f}' for x in step_ms)}; median after "
                     f"2 warm-up steps {median:.2f} ms = "
                     f"{B_TRAIN / median * 1e3:.1f} QA pairs/s; loss first "
                     f"{losses[0]:.5f} last {losses[-1]:.5f}; (K1, K2) "
                     f"launches per step {sorted(set(launches))}; peak "
                     f"{peak_gb:.2f} GB allocated ({card})")

        # the epoch checkpoint, restored with -continue
        path = os.path.join(params["save_path"],
                            checkpoint_name(0, trainer.step))
        t0 = time.perf_counter()
        restored = train_loop.Trainer(
            dict(params, start_checkpoint=path, **{"continue": True}), None,
            trainer.iters_per_epoch, device="cuda")
        load_s = time.perf_counter() - t0
        live = dict(trainer.model.named_parameters())
        same = all(torch.equal(p, live[k])
                   for k, p in restored.model.named_parameters())
        same_opt = all(torch.equal(t, trainer.optimizer.state[k][slot])
                       for k, slots in restored.optimizer.state.items()
                       for slot, t in slots.items() if t is not None)
        if not (same and same_opt and restored.step == trainer.step
                and restored.optimizer.count == trainer.optimizer.count
                and restored.start_epoch == 1):
            failures.append(f"checkpoint {path}: restored parameters "
                            f"{'equal' if same else 'differ'}, optimizer "
                            f"{'equal' if same_opt else 'differs'}, step "
                            f"{restored.step} vs {trainer.step}, start epoch "
                            f"{restored.start_epoch}")
        say("train", f"checkpoint {os.path.basename(path)} "
                     f"({os.path.getsize(path) / 1e9:.2f} GB) restored with "
                     f"-continue in {load_s:.1f} s: parameters "
                     f"{'equal' if same else 'DIFFER'}, optimizer state "
                     f"{'equal' if same_opt else 'DIFFERS'}, step "
                     f"{restored.step}, start epoch {restored.start_epoch}")
        del restored
        torch.cuda.empty_cache()

        loader = DataLoader(dataset, B_TRAIN, shuffle=False, num_workers=1)
        batch = next(iter(loader))
        line, _ = step_profile(trainer, batch, cfg, card)
        say("train", line)
        del trainer
        torch.cuda.empty_cache()
        return counts, batch, params


def cross_attentions(attention):
    """The attention functions that the bf16 cross-check runs beside the
    kernels, each step held against the plain one:
      witness      - the plain forward and the kernels' backward (K1 then K2
                     on the same inputs): a step that differs from the plain
                     one by K2 alone, as steps through the earlier CUDA-core
                     kernels did (their bf16 K1 output equalled the plain
                     version's);
      control_p    - the plain formulas with P and dS rounded to bf16 before
                     the products that take them (P.V, dv, dq, dk);
      control_mask - the plain formulas with the backward's dropout mask
                     drawn from another seed;
      control_draw - the plain formulas with another dropout draw in both
                     directions.
    Each is attention_math in fp32 (see CONTROLS)."""
    import torch

    def keep(q, k, rate, seed):
        shape = (*q.shape[:3], k.shape[2])
        return (attention.keep_mask(shape, seed, rate, q.device)
                if rate > 0.0 else None)

    class Witness(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, mask, rate, seed):
            ctx.save_for_backward(q, k, v, mask)
            ctx.rate, ctx.seed = rate, seed
            with torch.autocast(q.device.type, enabled=False):
                return attention.attention_reference(q, k, v, mask, rate, seed)

        @staticmethod
        def backward(ctx, g):
            q, k, v, mask = ctx.saved_tensors
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            with torch.enable_grad(), torch.autocast(q.device.type,
                                                     enabled=False):
                out = attention.fused_attention(*leaves, mask, ctx.rate,
                                                ctx.seed)
            return (*torch.autograd.grad(out, leaves, g), None, None, None)

    class Formulas(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, mask, rate, seed, round_p, fwd_shift,
                    bwd_shift):
            ctx.save_for_backward(q, k, v, mask)
            ctx.args = rate, seed, round_p, bwd_shift
            with torch.autocast(q.device.type, enabled=False):
                return attention_math(
                    q.float(), k.float(), v.float(), mask,
                    keep=keep(q, k, rate, seed + fwd_shift),
                    round_p=round_p).to(q.dtype)

        @staticmethod
        def backward(ctx, g):
            q, k, v, mask = ctx.saved_tensors
            rate, seed, round_p, bwd_shift = ctx.args
            with torch.autocast(q.device.type, enabled=False):
                _, dq, dk, dv = attention_math(
                    q.float(), k.float(), v.float(), mask, g.float(),
                    bwd_keep=keep(q, k, rate, seed + bwd_shift),
                    round_p=round_p)
            return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                    *[None] * 6)

    def formulas(rounds, fwd_shift, bwd_shift):
        return lambda q, k, v, mask, rate=0.0, seed=0: Formulas.apply(
            q, k, v, mask, rate, seed, bf16_round if rounds else None,
            fwd_shift, bwd_shift)

    return {"witness": lambda q, k, v, mask, rate=0.0, seed=0: Witness.apply(
                q, k, v, mask, rate, seed),
            **{name: formulas(*args) for name, args in CONTROLS.items()}}


def step_diff(got, want, noise):
    """How a train step's (loss, gradients, parameters after the update)
    differ from the plain step's: the loss's relative difference; each
    leaf's max |grad - plain grad| over its plain max |grad| and its
    relative L2 difference, the worst over all leaves and over the leaves
    apart from key biases (``noise``); the largest parameter difference."""
    (loss, grads, new), (want_loss, want_grads, want_new) = got, want
    ratio, l2 = {}, {}
    for name, g in grads.items():
        w = want_grads[name].float()
        d = g.float() - w
        ratio[name] = (d.abs().max() / w.abs().max().clamp(min=1e-6)).item()
        l2[name] = (d.norm() / w.norm().clamp(min=1e-12)).item()
    worst = max(ratio, key=ratio.get)
    real = max((n for n in ratio if not noise.search(n)), key=ratio.get)
    real_l2 = max((n for n in l2 if not noise.search(n)), key=l2.get)
    return {"loss": loss, "plain_loss": want_loss,
            "loss_rel": abs(loss - want_loss) / abs(want_loss),
            "grad_all": ratio[worst], "grad_all_of": worst,
            "grad": ratio[real], "grad_of": real,
            "grad_l2": l2[real_l2], "grad_l2_of": real_l2,
            "param": max((p - want_new[n]).abs().max().item()
                         for n, p in new.items())}


def cross_check(attention, batch, params, failures, seeds=(SEED,)):
    """Phase 6: one train step from the same weights and generator state
    with dropout on, through K1/K2 and through the plain forward and
    backward, in fp32 and in bf16 (autocast over fp32 masters, as the
    train phase runs), for each generator seed. fp32: the limits of
    FP32_CROSS (loss, every gradient's max |diff| over its largest
    magnitude, the parameters after the update). bf16: those of BF16_CROSS
    (loss, the worst leaf's relative L2 gradient difference apart from key
    biases, whose gradient is zero in exact arithmetic, so that what they
    get is rounding noise, printed); the update is printed, not held
    (AdamW's first step moves a parameter by about lr whatever the
    gradient's size).
    The bf16 witness and control steps of cross_attentions are held against
    the plain step too: the controls of MUST_FAIL must fail the limits.
    Returns the readings."""
    import re

    import torch

    from crct_tpu_torch.models import layers
    from crct_tpu_torch.models.crct import build_model
    from crct_tpu_torch.train.optimizer import AdamW
    from crct_tpu_torch.train.train_loop import device_batch, make_train_step

    db = device_batch(batch, "cuda")
    noise = re.compile(r"\.key\d?\.bias$")
    others = cross_attentions(attention)
    readings = []
    for bf16 in (False, True):
        pd = dict(params, bf16=bf16)
        kind = "bf16" if bf16 else "fp32"
        for seed in seeds:
            def one_step(fn=None):
                with mock.patch.object(layers, "fused_attention",
                                       fn or layers.fused_attention):
                    model = build_model(pd, device="cuda", train=True)
                    opt = AdamW(list(model.named_parameters()), pd, 12)
                    metrics = make_train_step(model, opt)(
                        db, torch.Generator().manual_seed(seed))
                grads = {n: p.grad for n, p in model.named_parameters()
                         if p.grad is not None}
                new = {n: p.detach() for n, p in model.named_parameters()}
                return float(metrics[0]), grads, new

            attention.reset_launch_count()
            got = one_step()
            counts = (attention.launch_count(), attention.bwd_launch_count())
            want = one_step(attention.plain_attention)
            after = (attention.launch_count(), attention.bwd_launch_count())
            if after != counts or min(counts) < 1:
                failures.append(f"{kind} cross-check: kernel launches "
                                f"{counts} then {after}")
            if set(got[1]) != set(want[1]):
                failures.append(f"{kind} cross-check: different parameters "
                                f"got gradients")
            runs = {"kernels": step_diff(got, want, noise)}
            del got
            if bf16:
                for label, fn in others.items():
                    runs[label] = step_diff(one_step(fn), want, noise)
            del want
            torch.cuda.empty_cache()

            limits = BF16_CROSS if bf16 else FP32_CROSS
            r = runs["kernels"]
            for key, tol in limits.items():
                if not r[key] <= tol:
                    failures.append(f"{kind} cross-check: {LIMIT_NAMES[key]} "
                                    f"{r[key]} > {tol} (loss {r['loss']} vs "
                                    f"plain {r['plain_loss']}; gradient of "
                                    f"{r[key + '_of'] if key + '_of' in r else '-'})")
            for label in MUST_FAIL if bf16 else ():
                if all(runs[label][key] <= tol for key, tol in limits.items()):
                    failures.append(f"bf16 cross-check: {label} meets the "
                                    f"limits: " + ", ".join(
                                        f"{key} {runs[label][key]}"
                                        for key in limits))
            say("cross", f"one {kind} step at batch {B_TRAIN} with dropout, "
                         f"generator seed {seed}, K1/K2 ({counts[0]} and "
                         f"{counts[1]} launches) against the plain forward "
                         f"and backward (loss {r['plain_loss']:.6f}; limits: "
                         + ", ".join(f"{LIMIT_NAMES[key]} {tol:g}"
                                     for key, tol in limits.items()) + "): "
                         + "; ".join(
                             f"{label}: loss rel {x['loss_rel']:.3g}, worst "
                             f"gradient {x['grad_all']:.3g} "
                             f"({x['grad_all_of']}), apart from key biases "
                             f"{x['grad']:.3g} ({x['grad_of']}), relative L2 "
                             f"{x['grad_l2']:.3g} ({x['grad_l2_of']}), "
                             f"parameters after AdamW within {x['param']:.3g}"
                             for label, x in runs.items()))
            readings.append({"dtype": kind, "seed": seed, **{
                label: {key: x[key] for key in
                        ("loss_rel", "grad_all", "grad_all_of", "grad",
                         "grad_of", "grad_l2", "grad_l2_of", "param")}
                for label, x in runs.items()}})
    return readings


def chart_boxes(n, rng):
    """[n, 4] boxes on the canvas drawn like chart elements: wide titles and
    labels, tall thin bars, tiny tick labels and whole-figure boxes, so that
    every FPN level P2-P5 takes rois."""
    import numpy as np
    kind = np.arange(n) % 4
    w = np.select([kind == 0, kind == 1, kind == 2],
                  [rng.uniform(300, 900, n), rng.uniform(12, 120, n),
                   rng.uniform(6, 60, n)], rng.uniform(500, CANVAS, n))
    h = np.select([kind == 0, kind == 1, kind == 2],
                  [rng.uniform(20, 50, n), rng.uniform(100, 1100, n),
                   rng.uniform(6, 24, n)], rng.uniform(500, CANVAS, n))
    x0 = rng.uniform(0, 1, n) * (CANVAS - w)
    y0 = rng.uniform(0, 1, n) * (CANVAS - h)
    return np.stack([x0, y0, x0 + w, y0 + h], 1).astype(np.float32)


def grid_sampler_call(shapes, geo, g, P, S=2):
    """One aten.grid_sampler_2d_backward per level computing the same
    gradient: the level's sample points (of the forward's geometry ``geo``)
    as an align_corners grid with border padding (which clamps as the
    RoIAlign sampler does), fed g / S^2 spread over the S x S samples.
    Returns a function giving [H, W, C] fp32 gradients per level."""
    import torch
    C = g.shape[-1]
    calls = []
    for lvl, (H, W) in enumerate(shapes):
        on = (geo["lvl"] == lvl).nonzero().squeeze(1)
        n, PS = on.numel(), P * S
        if n == 0:
            continue
        # the clamped sample coordinates are lo + w_hi, exactly
        ys = geo["y0"][on].float() + geo["wy1"][on]
        xs = geo["x0"][on].float() + geo["wx1"][on]
        grid = torch.stack([(xs / (W - 1) * 2 - 1)[:, None, :].expand(n, PS,
                                                                      PS),
                            (ys / (H - 1) * 2 - 1)[:, :, None].expand(n, PS,
                                                                      PS)],
                           -1).reshape(1, n * PS, PS, 2).contiguous()
        go = (g[on].float() / (S * S)).repeat_interleave(S, 1) \
            .repeat_interleave(S, 2)
        go = go.permute(3, 0, 1, 2).reshape(1, C, n * PS, PS).contiguous()
        calls.append((lvl, go, torch.zeros(1, C, H, W, device=g.device),
                      grid))

    def run():
        out = [torch.zeros(H, W, C, device=g.device) for H, W in shapes]
        for lvl, go, inp, grid in calls:
            gi = torch.ops.aten.grid_sampler_2d_backward(
                go, inp, grid, 0, 1, True, [True, False])[0]
            out[lvl] = gi[0].permute(1, 2, 0)
        return out

    def timed():
        for _, go, inp, grid in calls:
            torch.ops.aten.grid_sampler_2d_backward(go, inp, grid, 0, 1,
                                                    True, [True, False])
    return run, timed


def roi_tile_stats(geo, shapes, tile_y, tile_x):
    """Rois a tile of K3's grid lists, by the kernel's own footprint test
    (a roi's first lo and last hi corner on each axis): the tiles, the
    tiles some roi touches, and the largest and the mean list over those."""
    import numpy as np
    lvl = geo["lvl"].cpu().numpy()
    y_lo, y_hi = geo["y0"][:, 0].cpu().numpy(), geo["y1i"][:, -1].cpu().numpy()
    x_lo, x_hi = geo["x0"][:, 0].cpu().numpy(), geo["x1i"][:, -1].cpu().numpy()
    counts = []
    for lv, (H, W) in enumerate(shapes):
        c = np.zeros((-(-H // tile_y), -(-W // tile_x)), np.int64)
        for n in np.flatnonzero(lvl == lv):
            c[y_lo[n] // tile_y:y_hi[n] // tile_y + 1,
              x_lo[n] // tile_x:x_hi[n] // tile_x + 1] += 1
        counts.append(c.ravel())
    c = np.concatenate(counts)
    touched = c[c > 0]
    return {"tiles": int(c.size), "touched": int(touched.size),
            "max": int(c.max()),
            "mean": float(touched.mean()) if touched.size else 0.0}


def roi_inputs(roi_align, name, dtype):
    """K3's inputs at one flagship shape (the 1344 pyramid, C = 256): the
    levels, the forward's geometry of chart-like boxes, the cotangent."""
    import numpy as np
    import torch
    P, N = ROI_SHAPES[name]
    rng = np.random.default_rng(SEED + P)
    shapes = [(CANVAS // s, CANVAS // s) for s in ROI_STRIDES]
    boxes = torch.from_numpy(chart_boxes(N, rng)).cuda()
    geo = roi_align.mlra_geometry(shapes, boxes, ROI_STRIDES, P, 2, 4, 224,
                                  2, 5)
    g = torch.from_numpy(rng.normal(size=(N, P, P, C_FPN))
                         .astype(np.float32)).cuda().to(dtype)
    return shapes, geo, g


def roi_times(roi_align, rk):
    """Phase times: device ms of everything K3's wrapper launches, at the
    box and mask shapes in fp32 and bf16: the phase that compares two
    checkouts (--tree) on one card."""
    import torch
    ms = {}
    for name in ROI_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            shapes, geo, g = roi_inputs(roi_align, name, dtype)
            ms[f"{name},{str(dtype)[6:]}"] = device_ms(
                lambda: rk.mlra_backward_kernel(g, geo, shapes, dtype, 2))
    return ms


def roi_error(got, want, dtype):
    """(error, its limit as text, within it): fp32 max abs error against
    2e-5 of max(1, |grad|) (another fixed order of the sums); bf16 the
    worst element's error over 2^-7 |want| + 1e-3 (both round one fp32 sum
    once: about one bf16 ulp apart at most)."""
    import torch
    err = max((a.float() - w.float()).abs().max().item()
              for a, w in zip(got, want))
    ok = all(a.dtype == dtype and a.shape == w.shape
             for a, w in zip(got, want))
    if dtype == torch.float32:
        top = max(1.0, max(w.abs().max().item() for w in want))
        return (err, f"2e-5 x max(1, |grad| {top:.3g})",
                ok and err <= 2e-5 * top)
    ratio = max(((a.float() - w.float()).abs()
                 / (2 ** -7 * w.float().abs() + 1e-3)).max().item()
                for a, w in zip(got, want))
    return err, f"{ratio:.3g} of 2^-7 |want| + 1e-3", ok and ratio <= 1.0


def same_bits(a, b):
    import torch
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def short_name(kernel):
    """A CUDA kernel's name without its return type and parameters."""
    import re
    m = re.search(r"(\w+)(<[^()]*>)?\(", kernel)
    return m.group(1) + (m.group(2) or "") if m else kernel


def launched(fn):
    """Names of the CUDA kernels, memsets and copies one call launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


# K3's edge cases: name -> (pyramid, boxes), as tests/test_torch_on_card.py
# holds them: an odd canvas (800 x 1216: partial tiles, every level hit),
# 320 rois in one tile of level 0 (more than a block's 256-roi scan), boxes
# on and past the border (lo == hi) and of zero area, one roi
def roi_edge_cases():
    import numpy as np
    rng = np.random.default_rng(SEED + 11)
    odd = [(200, 304), (100, 152), (50, 76), (25, 38)]
    full = [(CANVAS // s, CANVAS // s) for s in ROI_STRIDES]
    xy = rng.uniform(34.5, 53, (320, 2))
    border = [[-10, -10, 60, 30], [1300, 1310, 1350, 1360], [0, 0, 0, 0],
              [1344, 1344, 1344, 1344], [600, 600, 600, 600],
              [500, 700, 500, 900], [100, 800, 300, 800],
              [-40, 400, 1400, 460], [1200, -30, 1400, 1400],
              [0, 0, 1344, 1344], [1343.5, 5, 1344, 1344]]
    return {"odd_canvas": (odd, chart_boxes(64, rng) * np.float32(800 / 1344)),
            "crowded": (full, np.concatenate(
                [xy, xy + rng.uniform(0, 8, (320, 2))], 1)),
            "border": (full, np.asarray(border)),
            "one_roi": (full, chart_boxes(1, rng))}


def check_roi_edge_cases(roi_align, rk, failures):
    """K3 against its plain version at the edge cases, box and mask P,
    fp32 and bf16; returns a line of their errors."""
    import numpy as np
    import torch
    out = []
    for case, (shapes, boxes) in roi_edge_cases().items():
        boxes = torch.from_numpy(boxes.astype(np.float32)).cuda()
        for name, (P, _) in ROI_SHAPES.items():
            geo = roi_align.mlra_geometry(shapes, boxes, ROI_STRIDES, P, 2,
                                          4, 224, 2, 5)
            for dtype in (torch.float32, torch.bfloat16):
                g = torch.randn(len(boxes), P, P, C_FPN, device="cuda",
                                generator=torch.Generator("cuda")
                                .manual_seed(SEED)).to(dtype)
                got = rk.mlra_backward_kernel(g, geo, shapes, dtype, 2)
                want = rk.mlra_backward_reference(g, geo, shapes, dtype, 2)
                err, limit, ok = roi_error(got, want, dtype)
                if not ok:
                    failures.append(f"K3 {case} {name} {str(dtype)[6:]}: "
                                    f"max abs err {err} beyond {limit}")
                out.append(f"{case} {name} {str(dtype)[6:]} {err:.3g}")
    return "; ".join(out)


def check_roi_kernel(roi_align, rk, name, card, failures):
    """K3 against its plain version and the einsum backward at one flagship
    RoIAlign shape (the 1344 pyramid, C = 256), fp32 and bf16, all on the
    geometry the forward hands over; two launches bit for bit; one CUDA
    kernel a call; device times of everything the wrapper launches, of the
    plain version, the einsum backward and the grid sampler (fp32), and the
    bound. Returns a row a dtype."""
    import torch
    P, N = ROI_SHAPES[name]
    S = 2
    f32 = torch.float32
    rows = []
    for dtype in (f32, torch.bfloat16):
        shapes, geo, g = roi_inputs(roi_align, name, dtype)
        hit = sorted(set(geo["lvl"].tolist()))
        if hit != [0, 1, 2, 3]:
            failures.append(f"K3 {name}: boxes hit levels {hit}, want all "
                            f"four")
        dname = str(dtype)[6:]
        before = rk.launch_count()
        got = rk.mlra_backward_kernel(g, geo, shapes, dtype, S)
        again = rk.mlra_backward_kernel(g, geo, shapes, dtype, S)
        want = rk.mlra_backward_reference(g, geo, shapes, dtype, S)
        torch.cuda.synchronize()
        if rk.launch_count() != before + 2:
            failures.append(f"K3 {name}: {rk.launch_count() - before} "
                            f"launches for two calls")
        err, limit, ok = roi_error(got, want, dtype)
        if not ok:
            failures.append(f"K3 {name} {dname}: max abs err {err} beyond "
                            f"{limit}")
        same = all(same_bits(a, b) for a, b in zip(got, again))
        if not same:
            failures.append(f"K3 {name} {dname}: two launches differ")
        names = launched(lambda: rk.mlra_backward_kernel(g, geo, shapes,
                                                         dtype, S))
        if len(names) != 1 or "roi_align_bwd" not in names[0]:
            failures.append(f"K3 {name} {dname}: a call launches {names}, "
                            f"want one roi_align_bwd kernel")
        info = rk.launch_info(P, S, C_FPN, dtype, dtype, shapes)
        tiles = roi_tile_stats(geo, shapes, info["tile_y"], info["tile_x"])
        ms = device_ms(lambda: rk.mlra_backward_kernel(g, geo, shapes, dtype,
                                                       S))
        plain_ms = device_ms(lambda: rk.mlra_backward_reference(
            g, geo, shapes, dtype, S))
        # where the time goes: the floor of writing the output (a memset of
        # its bytes) and K3 on each level's rois alone
        flat = torch.empty(sum(h * w for h, w in shapes), C_FPN, dtype=dtype,
                           device="cuda")
        fill_ms = device_ms(flat.zero_)
        level_ms = {}
        for lv in hit:
            idx = torch.nonzero(geo["lvl"] == lv).flatten()
            sub = {k: v[idx].contiguous() for k, v in geo.items()}
            g_sub = g[idx].contiguous()
            level_ms[lv] = device_ms(lambda: rk.mlra_backward_kernel(
                g_sub, sub, shapes, dtype, S))
        extra, lib = {}, "no library call in bf16"
        library_ms = None
        if dtype == f32:
            einsum = roi_align._mlra_backward(g, geo, shapes, dtype, S)
            err_e = max((a - w).abs().max().item()
                        for a, w in zip(einsum, want))
            top = max(1.0, max(w.abs().max().item() for w in want))
            if not err_e <= 2e-5 * top:
                failures.append(f"K3 {name}: einsum backward off its plain "
                                f"version by {err_e}")
            run_lib, timed_lib = grid_sampler_call(shapes, geo, g, P, S)
            err_l = max((a - w).abs().max().item()
                        for a, w in zip(run_lib(), want))
            # tolerance for the yardstick: the grid's round trip through
            # [-1, 1] moves each sample by ~1e-7 of its coordinate
            if err_l <= 1e-4 * top:
                library_ms = device_ms(timed_lib)
                lib = (f"grid_sampler_2d_backward x{len(hit)} levels "
                       f"{library_ms:.4f} ms (equals the plain version to "
                       f"{err_l:.3g}, tol 1e-4 of max(1, {top:.3g}))")
            else:
                lib = (f"grid_sampler_2d_backward not timed: off the plain "
                       f"version by {err_l:.3g} > 1e-4 of max(1, {top:.3g})")
            extra["einsum_ms"] = device_ms(lambda: roi_align._mlra_backward(
                g, geo, shapes, dtype, S), iters=5)
            lib += (f", einsum backward {extra['einsum_ms']:.4f} ms (within "
                    f"{err_e:.3g})")
        # 2 FLOP (multiply, add) for each of the 4 corners of each sample and
        # channel; bytes: g and the geometry the kernel reads (lvl and the
        # int64 corners, the fp32 weights) read once, the gradient pyramid
        # written once, in the dtype
        esize = g.element_size()
        rows_out = sum(h * w for h, w in shapes)
        flops = 2.0 * N * (P * S) ** 2 * 4 * C_FPN
        nbytes = (esize * N * P * P * C_FPN + N * P * S * (4 * 8 + 4 * 4)
                  + 8.0 * N + esize * rows_out * C_FPN)
        bound_ms, bound_by = bound(flops, nbytes, "float32")
        row = {
            "name": f"roi_align_bwd[{name}"
                    + ("" if dtype == f32 else f",{dname}") + "]",
            "route": "cuda",
            "source": "crct_tpu_torch/csrc/roi_align_bwd.cu",
            "replaces": "crct_tpu/ops/roi_align_pallas.py:61",
            "dtype": dname, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, **extra,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        rows.append(row)
        say("kernel", f"K3 {name} {dname} (N, P, C) = ({N}, {P}, {C_FPN}) "
                      f"on the {CANVAS}^2 pyramid, levels hit {hit}: max abs "
                      f"err {err:.3g} ({limit}), two launches "
                      f"{'bit-equal' if same else 'DIFFER'}, a call launches "
                      f"{[short_name(n) for n in names]}; tile "
                      f"{info['tile_y']} x {info['tile_x']} "
                      f"positions x {info['threads']} channels, "
                      f"{info['tiles'] * info['channel_chunks']} blocks, "
                      f"{info['smem_bytes']} B "
                      f"shared memory, {info['blocks_per_sm']} blocks an SM, "
                      f"{info['group']} rois staged at once; "
                      f"rois a tile: largest {tiles['max']}, mean "
                      f"{tiles['mean']:.2f} over {tiles['touched']} of "
                      f"{tiles['tiles']} tiles touched; device times: "
                      f"kernel {ms:.4f} ms (each level's rois alone: "
                      + ", ".join(f"{lv} {t:.4f}" for lv, t in
                                  level_ms.items())
                      + f"; a memset of the output {fill_ms:.4f}), plain "
                      f"{plain_ms:.4f} ms, {lib}; "
                      f"bound {bound_ms:.4f} ms ({bound_by}: "
                      f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB) "
                      f"({card})")
    return rows


def draw_chart(rng, canvas):
    """One bar chart in CocoDataset.__getitem__'s layout: the normalized
    [canvas, canvas, 3] image, up to 100 boxes (title, axis labels, axes,
    bars, tick labels, legend), their classes among 25, and 28 x 28 mask
    targets of ones (an axis-aligned element fills its box). Sizes are
    those of a 1344 canvas, scaled to ``canvas``."""
    import numpy as np

    from crct_tpu_torch.detector.coco import PIXEL_MEAN, PIXEL_STD
    u = canvas / 1344
    img = np.full((canvas, canvas, 3), 255.0, np.float32)
    boxes, classes = [], []

    def px(lo, hi):
        return rng.uniform(lo, hi) * u

    def add(x0, y0, x1, y1, cls, color):
        img[int(y0):int(y1), int(x0):int(x1)] = color
        boxes.append([x0, y0, x1, y1])
        classes.append(cls)

    ink = (40.0, 40.0, 40.0)
    left, top, right, bottom = (px(160, 240), px(120, 200), px(1180, 1300),
                                px(1080, 1180))
    tw, mid = px(400, 900), canvas / 2
    add(mid - tw / 2, top - 90 * u, mid + tw / 2,
        top - 90 * u + px(30, 50), 0, ink)                          # title
    xw = px(150, 400)
    add((left + right - xw) / 2, bottom + 60 * u, (left + right + xw) / 2,
        bottom + 60 * u + px(25, 40), 1, ink)                       # xlabel
    yh = px(150, 400)
    add(left - 150 * u, (top + bottom - yh) / 2,
        left - 150 * u + px(25, 40), (top + bottom + yh) / 2, 2, ink)  # ylabel
    add(left, bottom, right, bottom + 4 * u, 5, (0.0, 0.0, 0.0))    # x axis
    add(left - 4 * u, top, left, bottom, 6, (0.0, 0.0, 0.0))        # y axis
    n_bars = int(rng.integers(3, 25))
    slot = (right - left) / n_bars
    for i in range(n_bars):
        x0 = left + i * slot + slot / 4
        h = rng.uniform(0.05, 0.95) * (bottom - top)
        add(x0, bottom - h, x0 + slot / 2, bottom, 9 + i % 16,
            tuple(rng.uniform(30, 220, 3)))                         # bar
        add(x0, bottom + 12 * u, x0 + slot / 2, bottom + 12 * u + px(14, 22),
            3, ink)                                                 # xtick
    for j in range(int(rng.integers(4, 10))):
        y = top + j * (bottom - top) / 10
        add(left - px(40, 70), y, left - 10 * u, y + px(14, 20), 4,
            ink)                                                    # ytick
    for j in range(int(rng.integers(1, 4))):
        y = top + (20 + 30 * j) * u
        add(right - 200 * u, y, right - 180 * u, y + 20 * u, 8,
            tuple(rng.uniform(30, 220, 3)))                         # marker
        add(right - 170 * u, y, right - 170 * u + px(50, 110), y + 16 * u,
            7, ink)                                                 # legend
    n = min(len(boxes), 100)
    out_boxes = np.zeros((100, 4), np.float32)
    out_boxes[:n] = np.asarray(boxes[:n], np.float32)
    cls = np.zeros(100, np.int32)
    cls[:n] = classes[:n]
    masks = np.zeros((100, 28, 28), np.float32)
    masks[:n] = 1.0
    return {"image": (img - PIXEL_MEAN) / PIXEL_STD, "gt_boxes": out_boxes,
            "gt_classes": cls, "gt_valid": np.arange(100) < n,
            "gt_masks28": masks, "hw": (canvas, canvas), "scale": 1.0,
            "flipped": False}


class ChartSet:
    """An in-memory detector dataset of DET_IMAGES charts, drawn from a
    seed per index (the machine with the card has no PIL to decode PNGs)."""

    categories = [f"class_{i}" for i in range(DET_CLASSES)]

    def __init__(self, canvas):
        self.canvas = canvas

    def __len__(self):
        return DET_IMAGES

    def __getitem__(self, i):
        import numpy as np
        return dict(draw_chart(np.random.default_rng(SEED + i), self.canvas),
                    image_id=i)


def detector_profile(trainer, batch, card):
    """Device time of one detector train step by group, from
    torch.profiler: convolutions with the GEMMs (cuDNN runs many of its
    convolutions as xmma GEMMs; the model's few Linear layers are a sliver
    of them), K3, the kernels launched inside the NMS loop (under the
    detector::nms ranges) and the rest; the NMS loop's span on the card's
    timeline and its host time; the busy share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    nms = "detector::nms"
    groups = {"conv_gemm": 0.0, "roi_align_bwd": 0.0, "nms": 0.0,
              "other": 0.0}
    kernels, nms_span = [], 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        if e.key == nms:          # the range mirrored on the card's timeline
            nms_span += ms
            continue
        kernels.append((ms, e.count, e.key))
        low = e.key.lower()
        if "roi_align_bwd" in low:
            groups["roi_align_bwd"] += ms
        elif any(w in low for w in ("conv", "cudnn", "implicit", "winograd",
                                    "fprop", "dgrad", "wgrad", "nchw", "nhwc",
                                    "gemm", "cutlass", "xmma", "nvjet",
                                    "cublas", "matmul")):
            groups["conv_gemm"] += ms
        else:
            groups["other"] += ms

    def kernel_ms(e):
        return (sum(k.duration for k in e.kernels if k.name != nms)
                + sum(kernel_ms(c) for c in e.cpu_children))

    ranges = [e for e in prof.events()
              if e.name == nms and e.device_type == DeviceType.CPU]
    nms_kernels = sum(kernel_ms(e) for e in ranges) / 1e3
    nms_host = sum(e.cpu_time_total for e in ranges) / 1e3
    groups["other"] -= nms_kernels
    groups["nms"] = nms_kernels
    busy = sum(groups.values())
    if busy <= 0:
        return "device time: not measured (the profiler recorded none)", {}
    top = "; ".join(f"{k[:50]} x{n} {ms:.2f} ms"
                    for ms, n, k in sorted(kernels, reverse=True)[:5])
    line = (f"device time of one detector step (batch {DET_BATCH}, fp32): "
            f"busy {busy:.2f} of {wall_ms:.2f} ms wall under the profiler "
            f"({100 * busy / wall_ms:.1f}%): "
            + ", ".join(f"{g} {ms:.2f} ms ({100 * ms / busy:.1f}%)"
                        for g, ms in groups.items())
            + f"; the NMS loop ({len(ranges)} calls) spans {nms_span:.1f} ms "
            f"of the card's timeline and {nms_host:.1f} ms of host time; top "
            f"kernels: {top} ({card})")
    return line, dict(groups, busy=busy, wall=wall_ms, nms_host=nms_host,
                      nms_span=nms_span)


def detector(card, attention, roi_align, rk, failures):
    """Phase 7: the PlotQA detector trained by DetectorTrainer on the card
    through K3, the backward of every RoIAlign. The trainer, not this
    script, turns TF32 off: the phase starts from PyTorch's defaults."""
    import numpy as np
    import torch

    from crct_tpu_torch.detector.convert import restore_detector_params
    from crct_tpu_torch.detector.mask_rcnn import MaskRCNN
    from crct_tpu_torch.detector.trainer import (BATCH_KEYS, DetectorSGD,
                                                 DetectorTrainer, device_batch,
                                                 detector_batch_iterator,
                                                 make_detector_train_step)
    from crct_tpu_torch.utils.checkpoint import save_detector_checkpoint

    per_step = {f"{name}": DET_BATCH for name in ROI_SHAPES}
    ds = ChartSet(CANVAS)
    torch.backends.cuda.matmul.allow_tf32 = False     # PyTorch's defaults
    torch.backends.cudnn.allow_tf32 = True
    t0 = time.perf_counter()
    trainer = DetectorTrainer(num_classes=DET_CLASSES, with_mask=True,
                              depth=50, seed=SEED, device="cuda")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        failures.append("detector: DetectorTrainer left TF32 on")
    init_state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    n_params = sum(p.numel() for p in trainer.model.parameters())
    say("detector", f"Mask R-CNN R50-FPN ({n_params / 1e6:.1f} M parameters, "
                    f"{DET_CLASSES} classes, fp32) built in "
                    f"{time.perf_counter() - t0:.1f} s")

    step_ms, launches, metrics = [], [], []
    attention.reset_launch_count()
    rk.reset_launch_count()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = None
    for batch in detector_batch_iterator(ds, DET_BATCH, BATCH_KEYS,
                                         DET_STEPS, seed=SEED):
        first = batch if first is None else first
        torch.cuda.synchronize()
        k3 = rk.launch_count()
        t = time.perf_counter()
        metrics.append(trainer.run_step(batch))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        launches.append(rk.launch_count() - k3)
    wall = time.perf_counter() - t0
    counts = {name: rk.LAUNCHES[(P, C_FPN)]
              for name, (P, _) in ROI_SHAPES.items()}
    other = attention.launch_count() + attention.bwd_launch_count()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n = len(step_ms)
    want = sum(per_step.values())
    if n != DET_STEPS:
        failures.append(f"detector: {n} steps, want {DET_STEPS}")
    bad = [m for m in metrics if not all(math.isfinite(v) for v in m.values())]
    if bad:
        failures.append(f"detector: non-finite losses {bad[0]}")
    if any(k != want for k in launches):
        failures.append(f"detector: K3 launches per step {launches}, want "
                        f"{want}")
    for name, k in counts.items():
        if k != per_step[name] * n:
            failures.append(f"detector {name}: {k} K3 launches in {n} steps, "
                            f"want {per_step[name]} a step")
    if other:
        failures.append(f"detector: {other} attention launches")
    median = float(np.median(step_ms[2:]))
    say("detector", f"{n} steps at batch {DET_BATCH} on the {CANVAS}^2 "
                    f"canvas in {wall:.1f} s wall (the batch producer "
                    f"included); step ms "
                    f"{', '.join(f'{x:.1f}' for x in step_ms)}; median of "
                    f"the {n - 2} after 2 warm-up steps {median:.2f} ms = "
                    f"{DET_BATCH / median * 1e3:.2f} images/s; total loss "
                    f"first {metrics[0]['total']:.5f} last "
                    f"{metrics[-1]['total']:.5f}; K3 launches per step "
                    f"{sorted(set(launches))} (box {counts['box']}, mask "
                    f"{counts['mask']}); peak {peak_gb:.2f} GB allocated "
                    f"({card})")
    say("detector", "losses of the last step: " + ", ".join(
        f"{k} {v:.5f}" for k, v in metrics[-1].items()))
    line, _ = detector_profile(trainer, first, card)
    say("detector", line)

    # --test: inference of the batch, then coco_evaluate over two charts
    from crct_tpu_torch.detector.trainer import coco_evaluate
    trainer.model.eval()
    db = device_batch(first, "cuda")
    with torch.inference_mode():
        t0 = time.perf_counter()
        out = trainer.model(db["image"], train=False, compute_masks=False)
        torch.cuda.synchronize()
        infer_ms = (time.perf_counter() - t0) * 1e3
        metrics_eval = coco_evaluate(trainer.model, ds, max_images=2,
                                     infer_batch=DET_BATCH)
    b = out["boxes"]
    ok = (torch.isfinite(b).all() and torch.isfinite(out["scores"]).all()
          and b.min() >= 0 and b.max() <= CANVAS
          and tuple(b.shape) == (DET_BATCH, 100, 4))
    if not ok:
        failures.append(f"detector inference: boxes {tuple(b.shape)} in "
                        f"[{b.min().item()}, {b.max().item()}]")
    say("detector", f"--test inference of the batch in {infer_ms:.1f} ms: "
                    f"boxes {tuple(b.shape)} finite within "
                    f"[{b.min().item():.1f}, {b.max().item():.1f}], "
                    f"{int(out['valid'].sum())} valid detections; "
                    f"coco_evaluate over 2 charts {metrics_eval}")

    # checkpoint round trip
    with tempfile.TemporaryDirectory(prefix="crct_det_") as root:
        path = os.path.join(root, f"detector_{trainer.step}.ckpt")
        save_detector_checkpoint(path, trainer.model.state_dict(),
                                 trainer.step,
                                 {"stride_in_1x1": False, "depth": 50,
                                  "pixel_mean": [123.675, 116.28, 103.53],
                                  "pixel_std": [58.395, 57.12, 57.375]})
        fresh = MaskRCNN(num_classes=DET_CLASSES).cuda()
        meta = restore_detector_params(fresh, path, verbose=False)
        live = trainer.model.state_dict()
        same = all(torch.equal(v, live[k])
                   for k, v in fresh.state_dict().items())
        step = torch.load(path, weights_only=False)["iter_id"]
        if not (same and step == trainer.step and meta["depth"] == 50):
            failures.append(f"detector checkpoint: state "
                            f"{'equal' if same else 'differs'}, step {step}")
        say("detector", f"checkpoint {os.path.basename(path)} "
                        f"({os.path.getsize(path) / 1e6:.1f} MB) restored: "
                        f"state {'equal' if same else 'DIFFERS'}, step {step}")
    del fresh, trainer, out
    torch.cuda.empty_cache()

    # cross-check: one fp32 step through K3, and through the einsum backward
    # and K3's plain version put in its place, from the same weights, batch
    # and generator state
    model = MaskRCNN(num_classes=DET_CLASSES).cuda()
    real, step_tiles = rk.mlra_backward_kernel, []

    def kernel_route(g, geo, shapes, dtype, S):
        """K3, noting how many rois each tile of its grid lists."""
        info = rk.launch_info(g.shape[1], S, g.shape[3], g.dtype, dtype,
                              shapes)
        step_tiles.append((g.shape[0], g.shape[1], roi_tile_stats(
            geo, shapes, info["tile_y"], info["tile_x"])))
        return real(g, geo, shapes, dtype, S)

    routes = {"kernel": kernel_route,
              "einsum": roi_align._mlra_backward,
              "plain": rk.mlra_backward_reference}

    def one_step(route):
        model.load_state_dict(init_state)
        opt = DetectorSGD(list(model.parameters()))
        step = make_detector_train_step(model, opt)
        gen = torch.Generator("cuda").manual_seed(SEED + 7)
        before = rk.launch_count()
        with mock.patch.object(rk, "mlra_backward_kernel", routes[route]):
            losses = step(db, gen)
        torch.cuda.synchronize()
        return ({k: v.item() for k, v in losses.items()},
                {n: p.grad.clone() for n, p in model.named_parameters()},
                {n: p.detach().clone() for n, p in model.named_parameters()},
                rk.launch_count() - before)

    db = device_batch(first, "cuda")
    runs = {route: one_step(route) for route in routes}
    want_l, want_g, want_p, plain_k3 = runs["plain"]
    report = []
    if runs["kernel"][3] != want or runs["einsum"][3] or plain_k3:
        failures.append(f"detector cross-check: K3 launches "
                        f"{[r[3] for r in runs.values()]}, want "
                        f"[{want}, 0, 0]")
    for route in ("kernel", "einsum"):
        losses, grads, params, _ = runs[route]
        rel = max(abs(losses[k] - want_l[k]) / max(abs(want_l[k]), 1e-12)
                  for k in want_l)
        worst_g, worst_name = 0.0, ""
        for name, g in grads.items():
            w = want_g[name]
            r = ((g - w).abs().max() / w.abs().max().clamp(min=1e-6)).item()
            if r > worst_g:
                worst_g, worst_name = r, name
        worst_p = max((p - want_p[n]).abs().max().item()
                      for n, p in params.items())
        if not (rel <= 1e-5 and worst_g <= 1e-4 and worst_p <= 1e-6):
            failures.append(f"detector cross-check {route}: loss rel {rel}, "
                            f"gradient of {worst_name} off by {worst_g}, "
                            f"parameters by {worst_p}")
        report.append(f"{route}: losses within {rel:.2g} relative (tol "
                      f"1e-5), worst gradient {worst_name} off by "
                      f"{worst_g:.2g} of its largest magnitude (tol 1e-4), "
                      f"parameters after SGD within {worst_p:.2g} (tol 1e-6)")
    say("detector", "rois a K3 tile lists in the cross-check's K3 step "
                    "(N, P: largest, mean over touched tiles): " + "; ".join(
                        f"{n}, {p}: {t['max']}, {t['mean']:.2f} over "
                        f"{t['touched']} of {t['tiles']}"
                        for n, p, t in step_tiles))
    say("cross", f"one fp32 detector step at batch {DET_BATCH} from the same "
                 f"weights and generator state, against K3's plain version "
                 f"(total {want_l['total']:.6f}): " + "; ".join(report))
    del model, runs
    torch.cuda.empty_cache()
    return counts


def kernel_phase(card, attention, build, roi_align, rk, failures):
    """Phase 3: every kernel against its plain version, timed; the rows of
    the kernels' JSON line by (kernel, shape, dtype)."""
    import torch
    fwd_rows = {}
    for kname, shape in SHAPES.items():
        for row, flops, nbytes, lse_err, rnd in check_kernel(
                attention, kname, shape, failures):
            fwd_rows[(kname, row["dtype"])] = row
            say("kernel", f"K1 {kname} {row['dtype']} (B, H, Lq, Lk, D) = "
                          f"{(B, *shape)}: max abs err "
                          f"{row['max_abs_err']:.3g} (tol "
                          f"{1e-5 if row['dtype'] == 'float32' else 2e-2}), "
                          f"lse within {lse_err:.3g} of max(1, |lse|) (tol "
                          f"1e-5); device times: kernel {row['ms']:.4f} ms, plain "
                          f"{row['plain_ms']:.4f} ms, sdpa "
                          f"{row['library_ms']:.4f} ms, bound "
                          f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
                          f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)"
                          + rounding_note(rnd) + f" ({card})")

    # K2's layout: shared memory, warps (key slabs) and resident blocks per
    # SM, and the waves of a B_TRAIN * H launch, in fp32 / bf16
    lib = build.load("attention_bwd")
    for fn in (lib.attention_bwd_smem, lib.attention_bwd_blocks_per_sm,
               lib.attention_bwd_key_tile):
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    occ = []
    for kname, (H, Lq, Lk, D) in SHAPES.items():
        per_sm = [lib.attention_bwd_blocks_per_sm(Lq, Lk, D, dt)
                  for dt in (0, 1)]
        if min(per_sm) < 1:
            failures.append(f"attention_bwd occupancy of {kname}: {per_sm}")
            continue
        occ.append(f"{kname} "
                   f"{lib.attention_bwd_smem(Lq, Lk, D, 0) / 1024:.1f}/"
                   f"{lib.attention_bwd_smem(Lq, Lk, D, 1) / 1024:.1f} KB, "
                   f"{lib.attention_bwd_key_tile(Lq, Lk, D, 0) // 16}/"
                   f"{lib.attention_bwd_key_tile(Lq, Lk, D, 1) // 16} warps, "
                   f"{per_sm[0]}/{per_sm[1]} blocks, "
                   + "/".join(f"{B_TRAIN * H / (n * sms):.2f}"
                              for n in per_sm) + " waves")
    say("build", f"attention_bwd per block (fp32/bf16) on {sms} SMs at B = "
                 f"{B_TRAIN}: " + "; ".join(occ))
    bwd_rows = {}
    for kname, shape in SHAPES.items():
        rows, ident = check_bwd_kernel(attention, kname, shape, failures)
        for row, flops, nbytes, rnd in rows:
            bwd_rows[(kname, row["dtype"])] = row
            say("kernel", f"K2 {kname} {row['dtype']} (B, H, Lq, Lk, D) = "
                          f"{(B_TRAIN, *shape)}: max abs err "
                          f"{row['max_abs_err']:.3g} (tol "
                          f"{1e-5 if row['dtype'] == 'float32' else 2e-2} of "
                          f"max(1, |grad|)); <out,C> = <v,dv> under dropout "
                          f"to {ident:.2g} relative; kernel {row['ms']:.4f} "
                          f"ms, plain {row['plain_ms']:.4f} ms, sdpa backward"
                          f" {row['library_ms']:.4f} ms (device times),"
                          f" bound {row['bound_ms']:.4f} ms "
                          f"({row['bound_by']}: {flops / 1e9:.2f} GFLOP, "
                          f"{nbytes / 1e6:.1f} MB)" + rounding_note(rnd)
                          + f" ({card})")

    roi_rows = [row for name in ROI_SHAPES
                for row in check_roi_kernel(roi_align, rk, name, card,
                                            failures)]
    say("kernel", "K3 against its plain version at the edge cases (max abs "
                  "err; limits as at the flagship shapes): "
                  + check_roi_edge_cases(roi_align, rk, failures))
    return fwd_rows, bwd_rows, roi_rows


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE,
                    help="the checkout whose crct_tpu_torch is driven (default:"
                         " this script's)")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated, of {', '.join(PHASES)} and times; "
                         f"the result line is printed only when all run")
    ap.add_argument("--seeds", type=int, default=1,
                    help="generator seeds of each cross-check step")
    args = ap.parse_args()
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES) - {"times"}
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    whole = set(phases) >= set(PHASES)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible", file=sys.stderr)
        return 2
    try:
        from crct_tpu_torch.ops import attention, build, roi_align
        from crct_tpu_torch.ops import roi_align_kernel as rk
    except ImportError as exc:
        print(f"chip_smoke: the port's package is not in {tree} ({exc})",
              file=sys.stderr)
        return 2
    if not os.path.abspath(attention.__file__).startswith(tree + os.sep):
        print(f"chip_smoke: imported {attention.__file__}, not the tree "
              f"{tree}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures = []

    card = device_line()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    say("device", f"{name}, {torch.cuda.device_count()} card(s), torch "
                  f"{torch.__version__}, CUDA {torch.version.cuda}; fp32 "
                  f"matmuls without TF32 (matmul.allow_tf32="
                  f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
                  f"{torch.backends.cudnn.allow_tf32}); the port of {tree}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:   # one nvcc per source
        list(pool.map(build.build, KERNELS))
    for kname in KERNELS:
        build.load(kname)
        seconds, log = build.BUILD_LOG.get(kname, (0.0, "cached"))
        use = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
               if "registers" in ln or "smem" in ln]
        say("build", f"{kname} for sm_90a in {seconds:.1f} s (nvcc); "
                     f"{use}")
    say("build", f"{len(KERNELS)} kernels built and loaded in "
                 f"{time.perf_counter() - t0:.1f} s")

    if "times" in phases:
        ms = kernel_times(attention)
        for key, t in ms.items():
            say("times", f"{key}: K1 {t['fwd']:.4f} ms, K2 {t['bwd']:.4f} ms "
                         f"({card})")
        k3 = roi_times(roi_align, rk)
        for key, t in k3.items():
            say("times", f"K3 {key}: {t:.4f} ms, everything the wrapper "
                         f"launches ({card})")
        print(json.dumps({"phase": "times", "tree": tree, "card": card,
                          "ms": ms, "k3_ms": k3}), flush=True)
    if "kernel" in phases:
        fwd_rows, bwd_rows, roi_rows = kernel_phase(card, attention, build,
                                                    roi_align, rk, failures)
    if "serve" in phases:
        launches = serve(card, attention, failures)
    batch = None
    if "train" in phases:
        train_counts, batch, params = train(card, attention, failures)
    if "cross" in phases:
        if batch is None:
            batch, params = train_batch()
        readings = cross_check(attention, batch, params, failures,
                               [SEED + i for i in range(args.seeds)])
        if not whole:
            print(json.dumps({"phase": "cross", "tree": tree, "card": card,
                              "readings": readings}), flush=True)
    if "detector" in phases:
        roi_counts = detector(card, attention, roi_align, rk, failures)
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    if not whole:
        return 0
    # launches in the main paths: fp32 K1 rows count serving's, bf16 rows
    # the (bf16) training run's; no main path runs K2 in fp32 (the kernel
    # phase and the fp32 cross-check step do)
    for (kname, dname), row in fwd_rows.items():
        row["path"] = "serve" if dname == "float32" else "train"
        row["launches"] = (launches[kname] if dname == "float32"
                           else train_counts[kname][0])
    for (kname, dname), row in bwd_rows.items():
        row["path"] = "none" if dname == "float32" else "train"
        row["launches"] = 0 if dname == "float32" else train_counts[kname][1]
    kernels = list(fwd_rows.values()) + list(bwd_rows.values())
    # the detector trains in fp32: no main path runs K3 in bf16
    for row in roi_rows:
        shape = row["name"][len("roi_align_bwd["):].split(",")[0].rstrip("]")
        fp32 = row["dtype"] == "float32"
        row["path"] = "detector train" if fp32 else "none"
        row["launches"] = roi_counts[shape] if fp32 else 0
    kernels += roi_rows
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
