#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (crct_tpu_torch) on one card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):
  1. device  - the card's name and power limit, as nvidia-smi gives them;
  2. build   - nvcc builds the kernels from crct_tpu_torch/csrc/
               attention_{fwd,bwd}.cu and roi_align_bwd.cu for sm_90a, all
               at once, and reports their registers and shared memory;
  3. kernel  - the forward kernel (K1) against its plain PyTorch version at
               the four flagship attention shapes (B = 240 rows), and the
               backward kernel (K2) against its plain version at the same
               shapes at the train batch (B = 80): fp32 and bf16, key-only
               and full masks, dropout 0 and 0.1 with one seed, and
               <out, C> = <v, dv> under dropout; each kernel's time, the
               plain version's, one PyTorch call's (a yardstick the port
               never calls) and the least time the card could take;
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
  6. cross   - one fp32 train step from the same weights with dropout on,
               through K1/K2 and through the plain forward and backward
               from the same generator state: loss, every gradient and the
               parameters after the AdamW update;
  7. detector - the PlotQA Mask R-CNN R50-FPN (25 classes, random weights
               from a seed, fp32) trained by DetectorTrainer at batch 2 on
               the 1344 x 1344 canvas, fed by detector_batch_iterator over
               bar charts drawn with numpy, with the RoIAlign backward on
               the kernel K3 (the [kernel] phase holds K3 against its plain
               version, the einsum backward and grid_sampler_2d_backward at
               the box and mask shapes): 2 warm-up and 10 timed steps with
               exactly 4 K3 launches a step, a torch.profiler split of one
               step, one fp32 step through K3, the einsum backward and K3's
               plain version from the same weights and generator state,
               one --test inference and a checkpoint round trip.
The line before the last holds the kernels' numbers as JSON; the last line
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
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # H100 SXM, dense
HBM_BYTES_PER_S = 3.35e12
N_CONCURRENT = 24             # concurrent /v1/answer requests
N_BATCH = 8                   # questions in the /v1/answers request
TRAIN_IMAGES = 120            # synthetic figures x 4 questions x 2 (the
                              # negatives) = 960 items: 12 steps of 80
KERNELS = ("attention_fwd", "attention_bwd", "roi_align_bwd")
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


def time_ms(fn, iters=20, warmup=3):
    """Mean ms of one call: CUDA events around ``iters`` calls, warmed up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def check_kernel(attention, name, shape, failures):
    """The kernel against its plain version at one flagship shape; its
    timings and bound (fp32, key-only mask, no dropout: the serve case)."""
    import torch
    import torch.nn.functional as F
    H, Lq, Lk, D = shape
    g = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for full in (False, True):
            for rate in (0.0, 0.1):
                q, k, v = (torch.randn(B, H, L, D, device="cuda",
                                       generator=g).to(dtype)
                           for L in (Lq, Lk, Lk))
                mask = torch.where(torch.rand(B, 1, Lq if full else 1, Lk,
                                              device="cuda", generator=g)
                                   < 0.2, -10000.0, 0.0)
                got = attention.fused_attention(q, k, v, mask, rate, SEED)
                want = attention.attention_reference(q, k, v, mask, rate,
                                                     SEED)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                case = (f"{name} {str(dtype)[6:]} "
                        f"{'full' if full else 'key-only'} mask rate {rate}")
                if not err <= tol:
                    failures.append(f"{case}: max abs err {err} > {tol}")
                errs[(dtype, full, rate)] = err

    q, k, v = (torch.randn(B, H, L, D, device="cuda", generator=g)
               for L in (Lq, Lk, Lk))
    mask = torch.where(torch.rand(B, 1, 1, Lk, device="cuda", generator=g)
                       < 0.2, -10000.0, 0.0)
    ms = time_ms(lambda: attention.fused_attention(q, k, v, mask))
    plain_ms = time_ms(lambda: attention.attention_reference(q, k, v, mask))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask))
    flops = 4.0 * B * H * Lq * Lk * D
    nbytes = 4.0 * (2 * B * H * Lq * D + 2 * B * H * Lk * D + B * Lk)
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    row = {
        "name": f"attention_fwd[{name}]",
        "route": "cuda",
        "source": "crct_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "crct_tpu/ops/attention.py:82",
        "max_abs_err": max(e for (d, _, _), e in errs.items()
                           if d == torch.float32),
        "max_abs_err_bf16": max(e for (d, _, _), e in errs.items()
                                if d == torch.bfloat16),
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    return row, flops, nbytes


def check_bwd_kernel(attention, name, shape, failures):
    """K2 against its plain version at one flagship shape at the train
    batch; its timings and bound (fp32, key-only mask, no dropout). The
    fp32 tolerance is 1e-5 of the larger of 1 and the largest gradient
    magnitude, bf16's 2e-2 of it."""
    import torch
    import torch.nn.functional as F
    H, Lq, Lk, D = shape
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    errs = {}

    def inputs(dtype, full):
        q, k, v, gr = (torch.randn(B_TRAIN, H, L, D, device="cuda",
                                   generator=g).to(dtype)
                       for L in (Lq, Lk, Lk, Lq))
        mask = torch.where(torch.rand(B_TRAIN, 1, Lq if full else 1, Lk,
                                      device="cuda", generator=g)
                           < 0.2, -10000.0, 0.0)
        return q, k, v, gr, mask

    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
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
                errs[(dtype, full, rate)] = err

    # out is linear in v: <out, C> = <v, dv> only with the forward's mask
    q, k, v, gr, mask = inputs(torch.float32, False)
    v.requires_grad_()
    out = attention.fused_attention(q, k, v, mask, 0.1, SEED)
    (dv,) = torch.autograd.grad(out, (v,), gr)
    lhs = (out.double() * gr.double()).sum().item()
    rhs = (v.double() * dv.double()).sum().item()
    if not abs(lhs - rhs) <= 1e-5 * abs(lhs):
        failures.append(f"K2 {name}: <out,C> {lhs} != <v,dv> {rhs}")

    q, k, v, gr, mask = inputs(torch.float32, False)
    ms = time_ms(lambda: attention._launch_bwd(q, k, v, mask, gr, 0.0, 0))
    plain_ms = time_ms(lambda: attention.attention_bwd_reference(
        q, k, v, mask, gr))
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)

    # SDPA's backward alone: forward + backward minus forward
    library_ms = (time_ms(lambda: torch.autograd.grad(sdpa(), (qs, ks, vs),
                                                      gr))
                  - time_ms(sdpa))
    flops = 10.0 * B_TRAIN * H * Lq * Lk * D
    # q, g, dq; k, v, dk, dv; the key-only mask
    nbytes = 4.0 * (3 * B_TRAIN * H * Lq * D + 4 * B_TRAIN * H * Lk * D
                    + B_TRAIN * Lk)
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    row = {
        "name": f"attention_bwd[{name}]",
        "route": "cuda",
        "source": "crct_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "crct_tpu/ops/attention.py:96",
        "max_abs_err": max(e for (d, _, _), e in errs.items()
                           if d == torch.float32),
        "max_abs_err_bf16": max(e for (d, _, _), e in errs.items()
                                if d == torch.bfloat16),
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    return row, flops, nbytes, abs(lhs - rhs) / abs(lhs)


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
            launches = {name: attention.LAUNCHES[shape]
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


def train(card, attention, failures):
    """Phase 5: the flagship model trained by run_training on the card."""
    import numpy as np
    import torch

    from crct_tpu_torch.config import CRCTModelConfig, default_params
    from crct_tpu_torch.data.dataset import ChartQADataset, DataLoader
    from crct_tpu_torch.data.synthetic import generate_dataset
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
        data = generate_dataset(os.path.join(root, "data"),
                                n_images=TRAIN_IMAGES, division=8,
                                n_questions=4, feat_dim=1024,
                                splits=("train",), seed=SEED)
        params = default_params(
            figure_feat_path=data["figure_feat_path"],
            qa_parent_dir=data["qa_parent_dir"], dataset_config=data,
            model_config=model_config, seed=SEED, batch_size=B_TRAIN,
            num_epochs=1, num_workers=4, no_eval=True, bf16=True,
            save_path=os.path.join(root, "results"), max_seq_len=124,
            max_vis_features=44)
        dataset = ChartQADataset(params, ["train"])
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
        counts = {name: (attention.LAUNCHES[shape],
                         attention.BWD_LAUNCHES[shape])
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


def cross_check(attention, batch, params, failures):
    """Phase 6: one fp32 step from the same weights with dropout on, through
    K1/K2 and through the plain forward and backward: loss within 1e-5
    relative, every gradient within 1e-4 of its largest magnitude, the
    parameters after the update within 1e-6."""
    import torch

    from crct_tpu_torch.models import layers
    from crct_tpu_torch.models.crct import build_model
    from crct_tpu_torch.train.optimizer import AdamW
    from crct_tpu_torch.train.train_loop import device_batch, make_train_step

    db = device_batch(batch, "cuda")
    pd = dict(params, bf16=False)

    def one_step():
        model = build_model(pd, device="cuda", train=True)
        opt = AdamW(list(model.named_parameters()), pd, 12)
        metrics = make_train_step(model, opt)(
            db, torch.Generator().manual_seed(SEED))
        grads = {n: p.grad for n, p in model.named_parameters()
                 if p.grad is not None}
        new = {n: p.detach() for n, p in model.named_parameters()}
        return float(metrics[0]), grads, new

    attention.reset_launch_count()
    loss, grads, new = one_step()
    counts = (attention.launch_count(), attention.bwd_launch_count())
    with mock.patch.object(layers, "fused_attention",
                           attention.plain_attention):
        want_loss, want_grads, want_new = one_step()
    if (attention.launch_count(), attention.bwd_launch_count()) != counts \
            or min(counts) < 1:
        failures.append(f"cross-check: kernel launches {counts} then "
                        f"{(attention.launch_count(), attention.bwd_launch_count())}")
    rel = abs(loss - want_loss) / abs(want_loss)
    if not rel <= 1e-5:
        failures.append(f"cross-check: loss {loss} vs plain {want_loss}")
    if set(grads) != set(want_grads):
        failures.append("cross-check: different parameters got gradients")
    worst_g, worst_name = 0.0, ""
    for name, g in grads.items():
        w = want_grads[name]
        r = ((g - w).abs().max() / w.abs().max().clamp(min=1e-6)).item()
        if r > worst_g:
            worst_g, worst_name = r, name
    if not worst_g <= 1e-4:
        failures.append(f"cross-check: gradient of {worst_name} off by "
                        f"{worst_g} of its largest magnitude")
    worst_p = max((p - want_new[n]).abs().max().item()
                  for n, p in new.items())
    if not worst_p <= 1e-6:
        failures.append(f"cross-check: parameters after the update differ "
                        f"by {worst_p}")
    say("cross", f"one fp32 step at batch {B_TRAIN} with dropout, K1/K2 "
                 f"({counts[0]} and {counts[1]} launches) against the plain "
                 f"forward and backward: loss {loss:.6f} vs {want_loss:.6f} "
                 f"(rel {rel:.2g}, tol 1e-5); worst gradient {worst_name} "
                 f"off by {worst_g:.2g} of its largest magnitude (tol 1e-4); "
                 f"parameters after AdamW within {worst_p:.2g} (tol 1e-6)")


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


def check_roi_kernel(roi_align, rk, name, card, failures):
    """K3 against its plain version and the einsum backward at one flagship
    RoIAlign shape (the 1344 pyramid, C = 256), fp32 and bf16, all three on
    the geometry the forward hands over; its timings, the grid sampler's
    and the bound. fp32 tolerance 2e-5 of max(1, |grad|) (fp32 atomics
    reorder the sums); bf16 element by element, 2^-7 of |want| + 1e-3
    (both sum in fp32 from the same bf16 g and round once: about one bf16
    ulp apart at most)."""
    import numpy as np
    import torch
    P, N = ROI_SHAPES[name]
    S = 2
    rng = np.random.default_rng(SEED + P)
    shapes = [(CANVAS // s, CANVAS // s) for s in ROI_STRIDES]
    boxes = torch.from_numpy(chart_boxes(N, rng)).cuda()
    cfg = (ROI_STRIDES, P, S, 4, 224, 2, 5)
    geo = roi_align.mlra_geometry(shapes, boxes, *cfg)
    hit = sorted(set(geo["lvl"].tolist()))
    if hit != [0, 1, 2, 3]:
        failures.append(f"K3 {name}: boxes hit levels {hit}, want all four")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.from_numpy(rng.normal(size=(N, P, P, C_FPN))
                             .astype(np.float32)).cuda().to(dtype)
        before = rk.launch_count()
        got = rk.mlra_backward_kernel(g, geo, shapes, dtype, S)
        want = rk.mlra_backward_reference(g, geo, shapes, dtype, S)
        torch.cuda.synchronize()
        if rk.launch_count() != before + 1:
            failures.append(f"K3 {name}: {rk.launch_count() - before} "
                            f"launches for one call")
        err = max((a.float() - w.float()).abs().max().item()
                  for a, w in zip(got, want))
        if dtype == torch.float32:
            top = max(w.abs().max().item() for w in want)
            ok, limit = err <= 2e-5 * max(1.0, top), f"2e-5 x max(1, {top})"
        else:
            # the worst element's error over its own limit
            ratio = max(((a.float() - w.float()).abs()
                         / (2 ** -7 * w.float().abs() + 1e-3)).max().item()
                        for a, w in zip(got, want))
            ok, limit = ratio <= 1.0, f"2^-7 |want| + 1e-3 ({ratio:.3g} of it)"
        if not (ok and all(a.dtype == dtype for a in got)):
            failures.append(f"K3 {name} {str(dtype)[6:]}: max abs err {err} "
                            f"beyond {limit}")
        errs[dtype] = err
        if dtype == torch.float32:
            einsum = roi_align._mlra_backward(g, geo, shapes, dtype, S)
            err_e = max((a - w).abs().max().item()
                        for a, w in zip(einsum, want))
            if not err_e <= 2e-5 * max(1.0, top):
                failures.append(f"K3 {name}: einsum backward off its plain "
                                f"version by {err_e}")
            run_lib, timed_lib = grid_sampler_call(shapes, geo, g, P, S)
            err_l = max((a - w).abs().max().item()
                        for a, w in zip(run_lib(), want))
            g32 = g
    g = g32
    f32 = torch.float32
    ms = time_ms(lambda: rk.mlra_backward_kernel(g, geo, shapes, f32, S))
    plain_ms = time_ms(lambda: rk.mlra_backward_reference(g, geo, shapes,
                                                          f32, S))
    einsum_ms = time_ms(lambda: roi_align._mlra_backward(g, geo, shapes, f32,
                                                         S), iters=5)
    # the launch alone on prepared inputs, the pyramid's zeroing included:
    # the kernel's time ("ms"); the wrapper adds the packing of the
    # geometry (a few small torch ops) and the split into levels
    idx = torch.stack([geo["y0"], geo["y1i"], geo["x0"], geo["x1i"]],
                      1).to(torch.int32).contiguous()
    wts = torch.stack([geo["wy0"], geo["wy1"], geo["wx0"], geo["wx1"]],
                      1).contiguous()
    roi = torch.stack([geo["box_off"], geo["box_W"].long()],
                      1).to(torch.int32).contiguous()
    rows = sum(h * w for h, w in shapes)
    flat = torch.empty(rows, C_FPN, device="cuda")
    fn = rk._kernel()
    stream = torch.cuda.current_stream().cuda_stream

    def bare():
        flat.zero_()
        fn(g.data_ptr(), idx.data_ptr(), wts.data_ptr(), roi.data_ptr(),
           flat.data_ptr(), 0, N, P, S, C_FPN, stream)
    kernel_ms = time_ms(bare)
    # tolerance for the yardstick: the grid's round trip through [-1, 1]
    # moves each sample by ~1e-7 of its coordinate
    lib_ok = err_l <= 1e-4 * max(1.0, top)
    library_ms = time_ms(timed_lib) if lib_ok else None
    # 2 FLOP (multiply, add) for each of the 4 corners of each sample and
    # channel; bytes: g and the geometry read once, the fp32 pyramid
    # gradient written once
    flops = 2.0 * N * (P * S) ** 2 * 4 * C_FPN
    nbytes = (4.0 * N * P * P * C_FPN + 4.0 * (2 * 4 * N * P * S + 2 * N)
              + 4.0 * rows * C_FPN)
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    row = {
        "name": f"roi_align_bwd[{name}]",
        "route": "cuda",
        "source": "crct_tpu_torch/csrc/roi_align_bwd.cu",
        "replaces": "crct_tpu/ops/roi_align_pallas.py:61",
        "max_abs_err": errs[torch.float32],
        "max_abs_err_bf16": errs[torch.bfloat16],
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "einsum_ms": einsum_ms, "wrapper_ms": ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    lib = (f"grid_sampler_2d_backward x{len(hit)} levels {library_ms:.4f} ms"
           f" (equals the plain version to {err_l:.3g}, tol 1e-4 of "
           f"max(1, {top:.3g}))" if lib_ok else
           f"grid_sampler_2d_backward not timed: off the plain version by "
           f"{err_l:.3g} > 1e-4 of max(1, {top:.3g})")
    say("kernel", f"K3 {name} (N, P, C) = ({N}, {P}, {C_FPN}) on the "
                  f"{CANVAS}^2 pyramid, levels hit {hit}: max abs err fp32 "
                  f"{errs[torch.float32]:.3g} (tol 2e-5 of max(1, |grad| = "
                  f"{top:.3g})), bf16 {errs[torch.bfloat16]:.3g} (element "
                  f"by element {ratio:.3g} of 2^-7 |want| + 1e-3), einsum "
                  f"backward within {err_e:.3g}; launch "
                  f"alone (zeroing included) {kernel_ms:.4f} ms, wrapper "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms, einsum "
                  f"{einsum_ms:.4f} ms, {lib}; bound {row['bound_ms']:.4f} ms"
                  f" ({row['bound_by']}: {flops / 1e9:.3f} GFLOP, "
                  f"{nbytes / 1e6:.1f} MB) ({card})")
    return row


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
    routes = {"kernel": rk.mlra_backward_kernel,
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
    say("cross", f"one fp32 detector step at batch {DET_BATCH} from the same "
                 f"weights and generator state, against K3's plain version "
                 f"(total {want_l['total']:.6f}): " + "; ".join(report))
    del model, runs
    torch.cuda.empty_cache()
    return counts


def main():
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
        print(f"chip_smoke: the port's package is not beside this script "
              f"({exc})", file=sys.stderr)
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
                  f"{torch.backends.cudnn.allow_tf32})")

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

    kernels = []
    for kname, shape in SHAPES.items():
        row, flops, nbytes = check_kernel(attention, kname, shape, failures)
        kernels.append(row)
        say("kernel", f"{kname} (B, H, Lq, Lk, D) = {(B, *shape)}: max abs "
                      f"err fp32 {row['max_abs_err']:.3g} (tol 1e-5), bf16 "
                      f"{row['max_abs_err_bf16']:.3g} (tol 2e-2); kernel "
                      f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                      f"sdpa {row['library_ms']:.4f} ms, bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
                      f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) "
                      f"({card})")

    smem_of = build.load("attention_bwd").attention_bwd_smem
    smem_of.argtypes = [ctypes.c_int] * 3
    smem_of.restype = ctypes.c_int
    say("build", "attention_bwd dynamic shared memory per block: "
                 + ", ".join(f"{kname} {smem_of(*shape[1:]) / 1024:.1f} KB"
                             for kname, shape in SHAPES.items()))
    # resident blocks per SM (fp32, bf16) and the waves of B_TRAIN * H blocks
    occupancy = build.load("attention_bwd").attention_bwd_blocks_per_sm
    occupancy.argtypes = [ctypes.c_int] * 4
    occupancy.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    occ = []
    for kname, shape in SHAPES.items():
        per_sm = [occupancy(*shape[1:], dtype) for dtype in (0, 1)]
        if min(per_sm) < 1:
            failures.append(f"attention_bwd occupancy of {kname}: {per_sm}")
            continue
        waves = [B_TRAIN * shape[0] / (n * sms) for n in per_sm]
        occ.append(f"{kname} {per_sm[0]}/{per_sm[1]} blocks, "
                   f"{waves[0]:.2f}/{waves[1]:.2f} waves")
    say("build", f"attention_bwd blocks of 8 warps resident per SM "
                 f"(fp32/bf16) on {sms} SMs at B = {B_TRAIN}: "
                 + "; ".join(occ))
    bwd_rows = []
    for kname, shape in SHAPES.items():
        row, flops, nbytes, ident = check_bwd_kernel(attention, kname, shape,
                                                     failures)
        bwd_rows.append(row)
        say("kernel", f"K2 {kname} (B, H, Lq, Lk, D) = {(B_TRAIN, *shape)}: "
                      f"max abs err fp32 {row['max_abs_err']:.3g} (tol 1e-5 "
                      f"of max(1, |grad|)), bf16 "
                      f"{row['max_abs_err_bf16']:.3g} (tol 2e-2 of it); "
                      f"<out,C> = <v,dv> under dropout to {ident:.2g} "
                      f"relative; kernel {row['ms']:.4f} ms, plain "
                      f"{row['plain_ms']:.4f} ms, sdpa backward "
                      f"{row['library_ms']:.4f} ms (fwd+bwd minus fwd), bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
                      f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) "
                      f"({card})")

    roi_rows = [check_roi_kernel(roi_align, rk, name, card, failures)
                for name in ROI_SHAPES]

    launches = serve(card, attention, failures)
    train_counts, batch, params = train(card, attention, failures)
    cross_check(attention, batch, params, failures)
    roi_counts = detector(card, attention, roi_align, rk, failures)
    for row, kname in zip(kernels, SHAPES):
        row["launches"] = launches[kname]
        row["train_launches"] = train_counts[kname][0]
    for row, kname in zip(bwd_rows, SHAPES):
        row["launches"] = train_counts[kname][1]
    kernels += bwd_rows
    for row, shape in zip(roi_rows, ROI_SHAPES):
        row["launches"] = roi_counts[shape]
    kernels += roi_rows
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
