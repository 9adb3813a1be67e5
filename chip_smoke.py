#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (crct_tpu_torch) on one card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py [--tree DIR] [--phases LIST] [--seeds N]

With no arguments it runs every phase below on the port beside it. --tree
drives another checkout's crct_tpu_torch instead, --phases a comma-separated
subset (plus "times": K1 and K2 timed through fused_attention alone, and K3
through mlra_backward_kernel, at the flagship shapes in both dtypes, as the
kernel phase times them; and "cards", on a machine with 2 or more cards:
cli.train -ddp under torchrun over every card, the parallel phase's rank
group over nccl with one rank a card, a QAScorer with a replica on each
card against one card, and the bench's QA sections under torchrun over
every card), and --seeds
the generator seeds of each cross-check step; such a run prints each phase's
result as a JSON line and not the result line. Comparing two checkouts on
one card: parent, change, change, parent, with --phases times,cross.

Phases, one line each (any failure exits non-zero):
  1. device  - the card's name and power limit, as nvidia-smi gives them;
  2. build   - nvcc builds the kernels from crct_tpu_torch/csrc/
               attention_{fwd,bwd}.cu and roi_align_bwd.cu for sm_90a, all
               at once, and reports their registers and shared memory; for
               the wgmma designs of K1 (bf16 in both modes, TF32 in fp32,
               Lk <= 128) and K2 each instance's registers and spill bytes
               (ptxas; a spill fails) and its HGMMA instructions in the
               SASS (none fails);
  3. kernel  - the forward kernel (K1) against its plain PyTorch version at
               the four flagship attention shapes (B = 240 rows), output and
               log-sum-exp, and the backward kernel (K2) against its plain
               version at the same shapes at the train batch (B = 80): fp32,
               and bf16 in both attention modes (the JAX default path's
               rounded P, the -pallas path's fp32 P), key-only and full
               masks, dropout 0 and 0.1 with one seed, and <out, C> =
               <v, dv> under dropout; K2's shared memory, warps and resident
               blocks; for each dtype and mode, each kernel's time, the
               plain version's, one PyTorch call's (SDPA, a yardstick the
               port never calls) and the least time the card could take
               (for fp32 also at the 3xTF32 rate the kernels run); in bf16
               -pallas mode, how the results are rounded against fp64
               (ROUNDING), in bf16 default mode, the share of elements that
               differ from the plain version's (SHARE), which the -pallas
               mode's results must miss; each K1 row names the design that
               served it (fwd_design), the wgmma rows with their shared
               memory, warps and blocks per SM;
  4. serve   - the flagship PlotQA model (config/vilbert.json, random
               weights from a seed, fp32) behind make_server on the card:
               concurrent /v1/answer requests and one /v1/answers batch over
               HTTP, 30 K1 launches per model forward, answers and the
               encoder's hidden states re-computed through the plain
               attention on the card; where one score() spends its time, on
               the host clock and by kernel under torch.profiler;
  5. eval    - the same model (random weights saved as a torch
               checkpoint) evaluated by cli.evaluate.main on a synthetic
               test split of 16 figures x 4 questions: the full protocol in
               fp32 (candidate rows/s, questions/s, the tables) beside the
               same run through the plain attention (per-row NSP
               probabilities within 1e-4, the same answers apart from
               counted near-ties), the card's busy share over one loader
               batch, the full protocol with -bf16; the fast-scorer head
               trained 40 steps by cli.train_fast_scorer (its CE falls);
               fast, top-k 8 and top-k 120 eval (top-k 120 rescores every
               candidate: the full protocol's probabilities and answers);
               make_server -fast_scorer and -fast_scorer_topk 8 over HTTP
               answering as those eval runs did; K1's launches on each path;
  6. train   - the same model trained by run_training at batch 80 in bf16
               with dropout 0.1 on a synthetic train split: step time, QA
               pairs/s, losses, exactly 30 K1 and 30 K2 launches a step, peak
               memory, a torch.profiler split of one step, the in-train eval
               on a 16-figure val split after the epoch (timed apart from
               the steps, its tables), and a checkpoint restored with
               -continue to the same parameters and step;
  7. cross   - one train step from the same weights with dropout on,
               through K1/K2 and through the plain forward and backward
               from the same generator state, in fp32 (loss, every gradient
               and the parameters after the AdamW update) and in bf16, in
               the default attention mode and with -pallas (loss and the
               worst relative L2 gradient difference apart from key
               biases, held at limits set from readings); with -pallas also
               a witness step (plain forward, kernels' backward) and three
               control steps (P and dS rounded to bf16, read; the
               backward's dropout mask from another seed, and another
               dropout draw, both of which the limits must catch);
  8. detector - the PlotQA Mask R-CNN R50-FPN (25 classes, random weights
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
  9. ingest - the chart-to-answer path: the PlotQA Mask R-CNN R50-FPN
               (228 classes, random weights from a seed, fp32, TF32 off) in
               a FigureIngestor on the 832 x 1344 canvas turns 8 numpy-drawn
               charts into feature records in 'gt' mode (timed: p50 ms a
               figure, figures/s, the detector's device time against the
               host's NMS loop, record building and Hungarian matching), and
               again in 'oracle' mode at a 0.05 score cut with the text
               classes favoured, so that detections reach the Hungarian
               oracle; the extraction loop (batched_detect at infer_batch 8,
               then the records) writes a shard that ChartQADataset reads
               back equal to the ingested records; a -serve_no_dataset
               server tokenizing through the native C++ tokenizer takes the
               records through add_figure and answers free-form questions
               over HTTP through K1, held against the plain attention
               (near-ties counted); one chart ingested on the card and on
               the CPU (the same weights): text_feat equal, the <IMG>
               feature and the oracle detections within stated tolerances,
               differences only at ties of the score cut or NMS.
 10. parallel - data parallelism and remat: the flagship model at batch 80
               in bf16, PAR_STEPS train steps with remat and without from
               the same weights and generator (the first steps' loss and
               fp32 gradients held at REMAT_LIMITS, 60 K1 and 30 K2
               launches a remat step, the peak memory and the median step
               time of each); cli.train -ddp under torchrun --standalone
               --nproc_per_node 1 (4 bf16 steps and the in-train eval; the
               rank-0 checkpoint loaded into an unwrapped model with
               strict=True); two gloo ranks on the one card (nccl refuses
               two ranks a device) that load the kernels already built:
               an fp32 QA step at local batch 40 against the one-rank step
               at batch 80 (dropout 0, TF32 off), cli.evaluate over the
               eval phase's questions with tables equal to a one-rank run,
               and an fp32 detector step at one image a rank against the
               one-rank batch-2 step (the same sampling noise; each rank
               replays its image's ReLU signs and proposals of that step,
               whose gradients jump where a ReLU input within fp32
               reordering of zero changes sign; the detector cross-check's
               limits), with K3's launches counted per rank and shape.
 11. weights  - the weight tools on the flagship model: its random weights
               (seed) as a reference-layout crct.ckpt (bert_pretrained.
               prefix, legacy LM-head, q_dense and type-embedding keys,
               gamma/beta names) through cli.convert_checkpoint (its printed
               counts), cli.evaluate on the output beside the same weights
               loaded directly (tables and per-row NSP bit-equal, K1),
               /v1/answer requests served from it through K1; a seeded
               BERT-base (12 layers, hidden 768, intermediate 3072) through
               cli.import_bert into cli.train -start_checkpoint, 3 bf16
               steps at batch 80 through K1 and K2 (the 196 text-stream
               tensors transferred, bit-equal at step 0). The Orbax path
               (JAX package checkpoints) needs tensorstore, which the card's
               machine lacks: it is tested on the CPU, and the phase says so.
 12. proof   - crct_tpu_torch.tools.full_pipeline_proof --fast on the card
               (its PNG charts): detector training through K3, extraction,
               QA training through K1 and K2, evaluation through K1; each
               stage's seconds and launches, the held-out accuracy beside
               chance (not gated at --fast sizes); then K1 and K2 against
               their plain versions at each (dtype, B, H, Lq, Lk, D) the
               proof launched them at, and K3 on the proof's geometry at
               each of its shapes (its 320 x 320 pyramid) with the proof's
               cotangent and a unit-normal one, with the kernel phase's
               limits.
 13. bench   - python -m crct_tpu_torch.bench --roofline --all in a child
               process (the port of bench.py: the flagship's bf16 train
               step at batch 80, eval, fast scorer, top-k 8 and the full
               protocol through evaluate(), the input pipeline, the
               roofline, charts to answers, the detector steps at 800 x 1088
               in fp32, bf16 and with the fast NMS, and at 512 px): its one
               JSON line has every key of bench.py's run under the port's
               names, every number finite and above 0, every MFU at most
               100 %, K1, K2 and K3 launched in each section that runs them,
               the card's name and power limit (saved to
               chiprun_out/chip_smoke_bench.json); with --phases cards also
               its QA sections under torchrun over every card.
 14. tools   - the eight measurement tools of crct_tpu_torch/tools/ (serve
               bench, eval overhead profile, eval chunk sweep, attention
               shape bench, detector step knockouts, RoIAlign backward
               compare, optimizer variants, shortlist miss rate) at small
               sizes, each through its main() in this process: its JSON
               line checked as the bench's and by what it measures (no
               client error and coalescing; the plain and SDPA paths launch
               no kernel; K3 within 2e-5 of max(1, |grad|) of the
               scatter-add gradient; the knockouts leave mask_rcnn's and
               box_ops' namespaces as they were).
The line before the last holds the kernels' numbers as JSON, a row for each
kernel, shape, dtype and, in bf16, attention mode (fp32 has one kernel
instance for both modes) (with "proof_launches": the kernel's launches in
the proof, for K1 and K2 those of the tiny model's attention of the same
kind, Lq and Lk, at its own heads and head width, for K3 those of the
same P on its 320 x 320 pyramid, apart from "launches"; "launches" and
"path" include the bench's sections and the tools' runs at the row's
shape); the last line
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
SMALL_ROWS = 8                # rows of a small serving batch (the times phase)
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
# K1's output and K2's gradients in bf16 -pallas mode may be off an fp64
# computation, on average, by at most this times the plain versions' error:
# between the kernels' readings (1.0001 of it) and those of a control that
# rounds P and dS to bf16 (1.56-1.59); PERF.md, section 6
ROUNDING = 1.25
# the attention modes (crct_tpu_torch/ops/attention.py): the JAX default
# path's, P rounded to bf16 (every path's unless -pallas), and the -pallas
# path's; fp32 runs one kernel instance for both
DEFAULT, PALLAS = "round_probs", "pallas"
# the (dtype, mode) rows of the kernel phase
VARIANTS = (("float32", DEFAULT), ("bfloat16", DEFAULT), ("bfloat16", PALLAS))
# in bf16 default mode, the largest share of K1's output elements and of
# K2's gradient elements that may differ from the plain version's at all:
# between the kernels' readings at the flagship shapes (K1 1.4e-4 to
# 3.4e-4, K2 1.2e-3 to 1.8e-3) and those of the -pallas mode's results held
# to the same plain version, a control that must miss it (K1 0.407-0.415,
# K2 0.342-0.376); PERF.md, section 6
SHARE = {"K1": 0.01, "K2": 0.02}
# outputs of fewer elements than this are not held to SHARE elementwise
# (a few ties would decide it) where a path's own shape is checked
SHARE_MIN = 10000
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
PHASES = ("kernel", "serve", "eval", "train", "cross", "detector", "ingest",
          "parallel", "weights", "proof", "bench", "tools")
# the bench phase's flags: bench.py's default run, the roofline, and --all's
# detector variants (the bf16 one launches K3 in bf16), each section timed
# in 2 windows (or passes) rather than 5 (3): the script's time limit
BENCH_ARGV = ("--roofline", "--all", "--repeats", "2")
# bench.py's keys of its default run with --roofline, under the port's names
# (the peak-bound ones name the card), by the section that writes them
BENCH_KEYS = {
    "train": ("attention_path", "train_step_tflop", "train_step_ms",
              "mfu_pct_h100_bf16", "train_step_tflop_analytic",
              "mfu_pct_h100_bf16_analytic"),
    "eval": ("eval_candidate_rows_per_sec_per_chip",
             "eval_questions_per_sec_per_chip_at_120_fanout"),
    "fast_scorer": ("fast_scorer_questions_per_sec_per_chip",
                    "fast_topk8_questions_per_sec_per_chip_derived"),
    "fast_topk8": ("fast_topk8_questions_per_sec_per_chip",
                   "eval_protocol_questions_per_sec_per_chip_measured",
                   "eval_measured_mean_candidates"),
    "input_pipeline": ("input_pipeline_samples_per_sec_per_host",),
    "roofline": ("roofline_fwd_ms", "roofline_fwd_mfu_pct",
                 "roofline_grad_ms", "roofline_grad_mfu_pct",
                 "roofline_grad_no_dropout_ms", "roofline_step_ms",
                 "roofline_optimizer_ms", "roofline_dropout_ms"),
    "e2e": ("e2e_charts_per_sec_per_chip", "e2e_extract_s", "e2e_qa_s",
            "qa_build_s", "qa_eval_s", "qa_questions"),
    "detector_800px": ("detector_train_imgs_per_sec_per_chip_800px",
                       "detector_train_step_tflop_800px",
                       "detector_mfu_pct_800px"),
    "detector": ("detector_train_imgs_per_sec_per_chip",),
    "detector_800px_bf16": (
        "detector_train_imgs_per_sec_per_chip_800px_bf16",),
    "detector_800px_fastnms": (
        "detector_train_imgs_per_sec_per_chip_800px_fastnms",),
}
# the kernels each bench section launches (the input pipeline runs none)
BENCH_KERNELS = {"train": ("k1", "k2"), "eval": ("k1",),
                 "fast_scorer": ("k1",), "fast_topk8": ("k1",),
                 "input_pipeline": (), "roofline": ("k1", "k2"),
                 "e2e": ("k1",), "detector_800px": ("k3",),
                 "detector": ("k3",), "detector_800px_bf16": ("k3",),
                 "detector_800px_fastnms": ("k3",)}
EVAL_IMAGES = 16              # synthetic test (and train) figures x 4
                              # questions of the eval phase
FS_STEPS = 40                 # fast-scorer head steps
N_SERVE_FAST = 8              # questions served by the fast scorer
VAL_IMAGES = 16               # figures of the in-train eval's val split
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
# the ingest phase: charts drawn at (h, w) sizes that the 832 x 1344 canvas
# takes at short edge 800 unresized (the card's machine has no PIL to
# resize with); the PlotQA detector's 228 classes; the oracle pass's score
# cut and the bias it adds to the classifier's 8 text and axis classes (a
# random classifier puts every box in a few visual classes, and the
# Hungarian oracle then never runs)
INGEST_CANVAS = (832, 1344)
INGEST_SIZES = ((800, 1067), (800, 1200), (800, 1344), (800, 1000),
                (800, 1100), (800, 1280), (800, 960), (800, 1150))
INGEST_CLASSES = 228
ORACLE_CUT = 0.05
ORACLE_BIAS = 4.0
INFER_BATCH = 8
INGEST_SHORT_EDGE = 800
FEAT_TOL = 1e-4               # region features: card vs CPU, batch 8 vs 1
BOX_TOL = 0.05                # px: a detection on two devices is the same
TIE_TOL = 1e-4                # scores / IoUs this close to a cut are ties
# the parallel phase: train steps of each remat setting (the first two
# compared, the last 3 timed); the remat step against the plain one (loss,
# relative; every gradient's max |diff| over max(1, |g|)); figures of the
# -ddp run's train split (x 4 questions x 2 = 4 steps of 80); the 2-rank
# fp32 QA step's gradient limit, max |diff| over max(1, |g|)
PAR_STEPS = 5
REMAT_LIMITS = {"loss_rel": 1e-6, "grad": 1e-5}
PAR_DDP_IMAGES = 40
PAR_QA_GRAD = 1e-4
# score() calls timed for each QAScorer of the cards phase, after a warm-up
SERVE_CALLS = 5
# the 2-rank detector step replays the one-rank step's ReLU signs: a ReLU
# input of a rank's own that takes the other side must lie within this of
# zero (a kink that the order of fp32 sums decides, not a different value)
PAR_KINK = 1e-3
# legacy keys of a published crct.ckpt that the converter drops: the LM
# head, its transform (old gamma/beta LayerNorm names), BertBiOutput's
# unused q_dense pair and the 13-way type embedding
LEGACY_KEYS = {"cls.predictions.bias": (30522,),
               "cls.predictions.transform.dense.weight": (768, 768),
               "cls.predictions.transform.dense.bias": (768,),
               "cls.predictions.transform.LayerNorm.gamma": (768,),
               "cls.predictions.transform.LayerNorm.beta": (768,),
               "bert.encoder.c_layer.0.biOutput.q_dense1.weight": (1024, 1024),
               "bert.encoder.c_layer.0.biOutput.q_dense1.bias": (1024,),
               "bert.encoder.c_layer.0.biOutput.q_dense2.weight": (1024, 1024),
               "bert.encoder.c_layer.0.biOutput.q_dense2.bias": (1024,),
               "bert.v_embeddings.type_embeddings.weight": (13, 1024)}
# BERT-base at the text stream's widths, for cli.import_bert
BERT_BASE = dict(layers=12, hidden=768, intermediate=3072, vocab=30522,
                 positions=512)
WEIGHT_TRAIN_IMAGES = 30      # x 4 questions x 2 = 240 items: 3 steps of 80
N_SERVE_WEIGHTS = 6           # /v1/answer requests on the converted weights


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


def kernel_row(kernel, name, dtype, mode, err, times, flops, nbytes):
    """One row of the kernels' JSON line (launches are filled in later).
    fp32 rows, one kernel instance for both attention modes, also get the
    bound at the rate of fp32-accurate products on the tensor cores, 3xTF32
    (a third of the TF32 rate), as the kernels run them."""
    dname = str(dtype)[6:]
    bound_ms, bound_by = bound(flops, nbytes, dname)
    row = {
        "name": f"attention_{kernel}[{name}"
                + ("" if dname == "float32" else f",{dname},{mode}") + "]",
        "route": "cuda",
        "source": f"crct_tpu_torch/csrc/attention_{kernel}.cu",
        "replaces": "crct_tpu/ops/attention.py:"
                    + ("82" if kernel == "fwd" else "96"),
        "dtype": dname, "mode": mode if dname != "float32" else "both",
        "max_abs_err": err, **times,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    if dname == "float32":
        row["bound_3xtf32_ms"], row["bound_3xtf32_by"] = bound(
            flops, nbytes, dname, PEAK_FLOPS["tf32"] / 3)
    return row


def ptxas_report(log, part):
    """Registers, stack and spill bytes of each kernel of an nvcc
    ``-Xptxas -v`` report whose mangled name holds ``part``: {name:
    {"registers", "stack_bytes", "spill_bytes" (stores and loads)}}."""
    import re
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )"
                      r"([^' ]+)", line)
        if m:
            fn = m.group(1) if part in m.group(1) else None
            if fn:
                out.setdefault(fn, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if fn and m:
            out[fn]["stack_bytes"] = int(m.group(1))
            out[fn]["spill_bytes"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if fn and m:
            out[fn]["registers"] = int(m.group(1))
    return out


def sass_count(build, name, part, opcode):
    """``opcode`` instructions in the SASS (cuobjdump -sass) of each kernel
    of csrc/<name>.cu's library whose mangled name holds ``part``."""
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(build.build(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            fn = fn if part in fn else None
            if fn:
                counts[fn] = 0
        elif fn and opcode in line:
            counts[fn] += 1
    return counts


# the wgmma designs' kernels: K1's attention_fwd_wgmma_kernel<NK, DT, ROUND>
# and K2's attention_bwd_wgmma_kernel<NK, DT, ROUND> (bf16),
# attention_bwd_wgmma_tf32_kernel<NK, DT> and
# attention_bwd_wgmma_tf32_tma_kernel<NK, DT> (fp32)
WGMMA_KERNELS = {"attention_fwd": "K1", "attention_bwd": "K2"}


def wgmma_instance(fn):
    """(NK, 8 DT, mode) of a mangled wgmma kernel: 'NK n, Dp d' and its
    attention mode ("" where the instance has none), "fp32" for a TF32
    instance, "fp32 tma" for the TF32 TMA design's."""
    import re
    tf, tma, nk, dt, rnd = re.search(
        r"wgmma(_tf32)?(_tma)?_kernelILi(\d+)ELi(\d+)E(?:Lb(\d)E)?",
        fn).groups()
    mode = ("fp32 tma" if tma else "fp32" if tf else "" if rnd is None
            else DEFAULT if rnd == "1" else PALLAS)
    return int(nk), 8 * int(dt), mode


def wgmma_build_report(build, attention, failures):
    """The wgmma instances of K1 and K2 as built: each one's registers,
    stack and spill bytes from ptxas (a spill fails) and its HGMMA
    instructions in the library's SASS (none fails). A checkout without a
    kernel's design says so."""
    for name, tag in WGMMA_KERNELS.items():
        if not hasattr(attention, "fwd_design" if tag == "K1"
                       else "bwd_design"):
            say("build", f"{name}: this checkout's {tag} has no wgmma design")
            continue
        report = ptxas_report(build.compiler_report(name), "wgmma")
        hgmma = sass_count(build, name, "wgmma", "HGMMA")
        if not report:
            failures.append(f"build: ptxas reported no wgmma instance of "
                            f"{tag}")
        parts = []
        for fn, r in sorted(report.items(),
                            key=lambda kv: wgmma_instance(kv[0])):
            nk, dp, mode = wgmma_instance(fn)
            what = f"NK {nk}, Dp {dp}" + (f", {mode}" if mode else "")
            spills, n = r.get("spill_bytes"), hgmma.get(fn, 0)
            if spills != 0:
                failures.append(f"build: {tag} wgmma {what} spills {spills} "
                                f"bytes")
            if n < 1:
                failures.append(f"build: {tag} wgmma {what} has no HGMMA in "
                                f"its SASS")
            parts.append(f"{what}: {r.get('registers')} registers, {spills} "
                         f"spill bytes, {r.get('stack_bytes')} stack bytes, "
                         f"{n} HGMMA")
        say("build", f"{name} wgmma instances (NK keys, Dp head columns; "
                     f"ptxas, cuobjdump -sass): " + "; ".join(parts)
            + "; ptxas notes on wgmma: "
            + (wgmma_notes(build.compiler_report(name)) or "none"))


def wgmma_notes(log):
    """ptxas' performance notes on wgmma (C75xx: wgmma serialized, or
    warpgroup.arrive injected) in an nvcc report: each note's code and
    text, and how many of its wgmma instances it names, how often."""
    import re
    seen = {}
    for line in log.splitlines():
        m = re.search(r"\((C75\d\d)\) (.*?) in (?:around line \d+ by compiler "
                      r"to allow use of registers in GMMA in )?(?:the )?"
                      r"function '([^']*wgmma[^']*)'", line)
        if m:
            code, text, fn = m.groups()
            text = re.sub(r" in around line \d+.*", "", text)
            count, fns = seen.setdefault((code, text), [0, set()])
            seen[(code, text)][0] = count + 1
            fns.add(fn)
    return "; ".join(f"{code} {text} ({n} notes, {len(fns)} instances)"
                     for (code, text), (n, fns) in sorted(seen.items()))


def wgmma_occupancy(build, attention, failures):
    """The wgmma designs at the flagship shapes: {(kernel, shape name,
    mode): (shared memory bytes, warps, blocks per SM)} (the TF32 rows
    under the mode "both", as the fp32 rows of the kernels' line), and
    their lines: blocks per SM and waves over the card's SMs, K1 at B rows
    (64-row warpgroup tiles, two a block above 64 query rows in bf16, one
    a block in fp32), K2 at B_TRAIN (one block a (batch, head), a
    warpgroup a 64-key slab)."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    occ = {}
    lib = build.load("attention_fwd")
    lib.attention_fwd_wgmma_smem.argtypes = [ctypes.c_int] * 3
    lib.attention_fwd_wgmma_blocks_per_sm.argtypes = [ctypes.c_int] * 4
    for fn in (lib.attention_fwd_wgmma_smem,
               lib.attention_fwd_wgmma_blocks_per_sm):
        fn.restype = ctypes.c_int
    parts = []
    for kname, (H, Lq, Lk, D) in SHAPES.items():
        for dtype, mode in ((torch.bfloat16, DEFAULT),
                            (torch.bfloat16, PALLAS),
                            (torch.float32, DEFAULT)):
            design = attention.fwd_design(dtype, mode, Lk, D)
            if design == "wgmma":
                smem = lib.attention_fwd_wgmma_smem(Lq, Lk, D)
                per_sm = lib.attention_fwd_wgmma_blocks_per_sm(
                    Lq, Lk, D, int(mode == DEFAULT))
                nwg = 2 if Lq > 64 else 1
            elif design == "wgmma tf32":
                # one warpgroup a block
                mode, nwg = "both", 1
                for fn in (lib.attention_fwd_tf32_smem,
                           lib.attention_fwd_tf32_blocks_per_sm):
                    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
                smem = lib.attention_fwd_tf32_smem(Lq, Lk, D)
                per_sm = lib.attention_fwd_tf32_blocks_per_sm(Lq, Lk, D)
            else:
                continue
            what = f"{kname} {str(dtype)[6:]} {mode}"
            if smem < 1 or per_sm < 1:
                failures.append(f"attention_fwd {design} occupancy of "
                                f"{what}: {smem} bytes, {per_sm} blocks")
                continue
            occ[("fwd", kname, mode)] = (smem, 4 * nwg, per_sm)
            blocks = B * H * -(-Lq // (64 * nwg))
            parts.append(f"{what} ({design}) {smem / 1024:.1f} KB, "
                         f"{4 * nwg} warps, {per_sm} blocks, "
                         f"{blocks / (per_sm * sms):.2f} waves")
    say("build", f"attention_fwd wgmma per block on {sms} SMs at B = "
                 f"{B}: " + "; ".join(parts))
    lib = build.load("attention_bwd")
    names = ("wgmma", "tf32") + (
        ("tf32_tma",) if hasattr(lib, "attention_bwd_tf32_tma_smem") else ())
    for name in names:
        smem_fn = getattr(lib, f"attention_bwd_{name}_smem")
        per_sm_fn = getattr(lib, f"attention_bwd_{name}_blocks_per_sm")
        for fn in (smem_fn, per_sm_fn):
            fn.argtypes = [ctypes.c_int] * (4 if name == "wgmma" else 3)
            fn.restype = ctypes.c_int
    parts = []
    for kname, (H, Lq, Lk, D) in SHAPES.items():
        for dtype, mode in ((torch.bfloat16, DEFAULT),
                            (torch.bfloat16, PALLAS),
                            (torch.float32, DEFAULT)):
            design = attention.bwd_design(dtype, mode, Lk, D)
            if design == "wgmma":
                args = (Lq, Lk, D, int(mode == DEFAULT))
                smem = lib.attention_bwd_wgmma_smem(*args)
                per_sm = lib.attention_bwd_wgmma_blocks_per_sm(*args)
            elif design == "wgmma tf32":
                mode = "both"
                smem = lib.attention_bwd_tf32_smem(Lq, Lk, D)
                per_sm = lib.attention_bwd_tf32_blocks_per_sm(Lq, Lk, D)
            elif design == "wgmma tf32 tma":
                mode = "both"
                smem = lib.attention_bwd_tf32_tma_smem(Lq, Lk, D)
                per_sm = lib.attention_bwd_tf32_tma_blocks_per_sm(Lq, Lk, D)
            else:
                continue
            nwg = 2 if Lk > 64 else 1
            what = f"{kname} {str(dtype)[6:]} {mode}"
            if smem < 1 or per_sm < 1:
                failures.append(f"attention_bwd {design} occupancy of "
                                f"{what}: {smem} bytes, {per_sm} blocks")
                continue
            occ[("bwd", kname, mode)] = (smem, 4 * nwg, per_sm)
            occ[("bwd design", kname, mode)] = design
            parts.append(f"{what} ({design}) {smem / 1024:.1f} KB, "
                         f"{4 * nwg} warps, {per_sm} blocks, "
                         f"{B_TRAIN * H / (per_sm * sms):.2f} waves")
    say("build", f"attention_bwd wgmma per block on {sms} SMs at B = "
                 f"{B_TRAIN}: " + "; ".join(parts))
    return occ


def design_note(row):
    """A kernel row's design, with its block's shared memory, warps and
    blocks per SM where the build report gave them."""
    note = row.get("design", "mma.sync") + " design"
    if "smem_bytes" in row:
        note += (f": {row['smem_bytes'] / 1024:.1f} KB, {row['warps']} "
                 f"warps, {row['blocks_per_sm']} blocks an SM")
    return note


def device_ms(fn, name=None, iters=20, warmup=3, tries=3):
    """Mean device time of one call on the current card, ms:
    ``crct_tpu_torch/utils/profiling.py``'s ``device_ms`` of this script's
    checkout, loaded from its file (``--tree`` may name an older checkout,
    which lacks it)."""
    import importlib.util

    import torch
    global _DEVICE_MS
    if _DEVICE_MS is None:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke_device_ms", os.path.join(
                HERE, "crct_tpu_torch", "utils", "profiling.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _DEVICE_MS = module.device_ms
    return _DEVICE_MS(fn, torch.device("cuda", torch.cuda.current_device()),
                      iters, warmup, tries, name)


_DEVICE_MS = None


def modes_of(attention):
    """The attention modes the checkout's kernels take, as keyword
    arguments (a checkout from before the modes takes none)."""
    return ([{"mode": m} for m in attention.MODES]
            if hasattr(attention, "MODES") else [{}])


def fwd_ms(attention, q, k, v, mask, **mode):
    """Device ms of a K1 launch: a forward of fused_attention without a
    gradient."""
    return device_ms(lambda: attention.fused_attention(q, k, v, mask, **mode),
                     "attention_fwd")


def backward_ms(fn, g, inputs, name=None):
    """Device ms of autograd's backward of fn(*inputs) alone (the forward's
    graph kept), for the cotangent g."""
    import torch
    leaves = [x.detach().requires_grad_() for x in inputs]
    out = fn(*leaves)
    return device_ms(lambda: torch.autograd.grad(out, leaves, g,
                                                 retain_graph=True), name)


def bwd_ms(attention, q, k, v, mask, g, **mode):
    """Device ms of a K2 launch: the backward of one fused_attention forward,
    so that any checkout's K2 times the same way."""
    return backward_ms(lambda *x: attention.fused_attention(*x, mask, **mode),
                       g, (q, k, v), "attention_bwd")


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
    """How bf16 results of the -pallas mode are rounded: the mean |error|
    against an fp64 computation, relative to the fp64 results' mean
    magnitude (averaged over dq, dk and dv with the cotangent g), of the
    kernels' (K1's output, or K2's gradients), of the plain versions', and
    of a control's: the plain formulas with P (and dS) rounded to bf16
    before the products that take them."""
    import torch
    d = [x.double() for x in (q, k, v)]
    exact = attention_math(*d, mask.double(),
                           None if g is None else g.double())
    ctrl = attention_math(*(x.float() for x in (q, k, v)), mask,
                          None if g is None else g.float(),
                          round_p=bf16_round)
    if g is None:
        got = (attention.fused_attention(q, k, v, mask, mode=PALLAS),)
        plain = (attention.attention_reference(q, k, v, mask, mode=PALLAS),)
        exact, ctrl = (exact,), (ctrl,)
    else:
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        got = torch.autograd.grad(
            attention.fused_attention(*leaves, mask, mode=PALLAS), leaves, g)
        plain = attention.attention_bwd_reference(q, k, v, mask, g,
                                                  mode=PALLAS)
        exact, ctrl = exact[1:], ctrl[1:]
    ctrl = [x.to(q.dtype) for x in ctrl]

    def err(xs):
        return sum(((x.double() - e).abs().mean() / e.abs().mean()).item()
                   for x, e in zip(xs, exact)) / len(exact)
    return err(got), err(plain), err(ctrl)


def wall_us(fn, calls=300, warmup=20):
    """Mean wall microseconds of one fn() over ``calls`` back-to-back calls,
    synchronized once at the end: the host's time per call where it
    issues slower than the card runs."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def kernel_times(attention):
    """Phase times: device ms of a K1 launch at B rows and K2 at B_TRAIN at
    the four flagship shapes in fp32 and bf16 (key-only mask, no dropout),
    in bf16 in each attention mode the checkout has, through
    fused_attention alone, as the kernel phase times them: the phase that
    compares two checkouts (--tree) on one card. Also K1 at SMALL_ROWS
    (small serving batches): its device ms and the wall microseconds of a
    fused_attention call, host included."""
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
            fwd = inputs(B)
            bwd = inputs(B_TRAIN)
            small = inputs(SMALL_ROWS)
            for mode in (modes_of(attention) if dtype == torch.bfloat16
                         else [{}]):
                q, k, v, _, mask = small
                k1_small = fwd_ms(attention, q, k, v, mask, **mode)
                k1_small_us = wall_us(lambda: attention.fused_attention(
                    q, k, v, mask, **mode))
                q, k, v, _, mask = fwd
                k1 = fwd_ms(attention, q, k, v, mask, **mode)
                q, k, v, gr, mask = bwd
                ms[",".join([name, str(dtype)[6:], *mode.values()])] = {
                    "fwd": k1, "bwd": bwd_ms(attention, q, k, v, mask, gr,
                                             **mode),
                    "fwd_small": k1_small, "fwd_small_wall_us": k1_small_us,
                    "fwd_design": attention.fwd_design(
                        dtype, mode.get("mode", DEFAULT), Lk, D)
                    if hasattr(attention, "fwd_design") else "mma.sync",
                    "bwd_design": attention.bwd_design(
                        dtype, mode.get("mode", DEFAULT), Lk, D)
                    if hasattr(attention, "bwd_design") else "mma.sync"}
    return ms


K_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # K1 abs; K2 of max(1, |grad|)


def k1_errors(attention, name, rows, shape, dtype, g, failures,
              mode=DEFAULT):
    """K1 against its plain version at [rows, H, L, D] in dtype and the
    attention mode, key-only and full masks, dropout 0 and 0.1: the output
    (through fused_attention, which skips the log-sum-exp without a
    gradient, and attention_forward) within K_TOL, the log-sum-exp within
    1e-5 of max(1, |lse|); in bf16 default mode also at most SHARE of the
    output elements different from the plain version's at all, where the
    output has SHARE_MIN elements or more. Returns the worst output error
    and the worst relative lse error."""
    import torch
    H, Lq, Lk, D = shape
    tol = K_TOL[str(dtype)[6:]]
    worst, worst_lse = 0.0, 0.0
    for full in (False, True):
        for rate in (0.0, 0.1):
            q, k, v = (torch.randn(rows, H, L, D, device="cuda",
                                   generator=g).to(dtype)
                       for L in (Lq, Lk, Lk))
            mask = torch.where(torch.rand(rows, 1, Lq if full else 1, Lk,
                                          device="cuda", generator=g)
                               < 0.2, -10000.0, 0.0)
            got = attention.fused_attention(q, k, v, mask, rate, SEED,
                                            mode=mode)
            got2, lse = attention.attention_forward(q, k, v, mask, rate,
                                                    SEED, mode=mode)
            want, want_lse = attention.attention_reference(
                q, k, v, mask, rate, SEED, return_lse=True, mode=mode)
            torch.cuda.synchronize()
            err = max((x.float() - want.float()).abs().max().item()
                      for x in (got, got2))
            err_lse = (lse - want_lse).abs().max().item()
            top = max(1.0, want_lse.abs().max().item())
            case = (f"{name} {str(dtype)[6:]} {mode} "
                    f"{'full' if full else 'key-only'} mask rate {rate}")
            if not err <= tol:
                failures.append(f"{case}: max abs err {err} > {tol}")
            if not err_lse <= 1e-5 * top:
                failures.append(f"{case}: lse off by {err_lse} > 1e-5 x "
                                f"{top}")
            if (str(dtype)[6:] == "bfloat16" and mode == DEFAULT
                    and want.numel() >= SHARE_MIN):
                share = max(differing((x,), (want,)) for x in (got, got2))
                if not share <= SHARE["K1"]:
                    failures.append(f"{case}: {share:.4g} of the output "
                                    f"elements differ from the plain "
                                    f"version's > {SHARE['K1']}")
            worst, worst_lse = max(worst, err), max(worst_lse, err_lse / top)
    return worst, worst_lse


def bwd_inputs(g, rows, shape, dtype, full):
    """K2's q, k, v, cotangent and a key-only or full 0/-10000 mask."""
    import torch
    H, Lq, Lk, D = shape
    q, k, v, gr = (torch.randn(rows, H, L, D, device="cuda",
                               generator=g).to(dtype)
                   for L in (Lq, Lk, Lk, Lq))
    mask = torch.where(torch.rand(rows, 1, Lq if full else 1, Lk,
                                  device="cuda", generator=g)
                       < 0.2, -10000.0, 0.0)
    return q, k, v, gr, mask


def k2_errors(attention, name, rows, shape, dtype, g, failures,
              mode=DEFAULT):
    """K2 against its plain version at [rows, H, L, D] in dtype and the
    attention mode, key-only and full masks, dropout 0 and 0.1: the
    gradients of fused_attention (K1 then K2 on K1's output and
    log-sum-exp) against attention_bwd_reference recomputing everything,
    within K_TOL of the larger of 1 and the largest gradient magnitude.
    Returns the worst max abs error."""
    import torch
    tol = K_TOL[str(dtype)[6:]]
    worst = 0.0
    for full in (False, True):
        for rate in (0.0, 0.1):
            q, k, v, gr, mask = bwd_inputs(g, rows, shape, dtype, full)
            leaves = [x.requires_grad_() for x in (q, k, v)]
            out = attention.fused_attention(*leaves, mask, rate, SEED,
                                            mode=mode)
            got = torch.autograd.grad(out, leaves, gr)
            want = attention.attention_bwd_reference(q, k, v, mask, gr,
                                                     rate, SEED, mode=mode)
            torch.cuda.synchronize()
            err = max((a.float() - w.float()).abs().max().item()
                      for a, w in zip(got, want))
            top = max(w.float().abs().max().item() for w in want)
            case = (f"{name} {str(dtype)[6:]} {mode} "
                    f"{'full' if full else 'key-only'} mask rate {rate}")
            if not err <= tol * max(1.0, top):
                failures.append(f"K2 {case}: max abs err {err} > {tol} "
                                f"x max(1, {top})")
            worst = max(worst, err)
    return worst


def differing(got, want):
    """The share of the elements of the tensors ``got`` that differ from
    ``want``'s at all."""
    n = sum(w.numel() for w in want)
    return sum((a != w).sum().item() for a, w in zip(got, want)) / n


def hold_share(what, kernel, share, control, failures):
    """The bf16 default mode's results within SHARE of the plain version's
    elements, and the control (the -pallas mode's results held to the same
    plain version) outside it."""
    if not share <= SHARE[kernel]:
        failures.append(f"{what} bf16 {DEFAULT}: {share:.4g} of the elements "
                        f"differ from the plain version's > {SHARE[kernel]}")
    if not control > SHARE[kernel]:
        failures.append(f"{what} bf16: the control (the {PALLAS} mode) "
                        f"differs from the {DEFAULT} plain version in only "
                        f"{control:.4g} of the elements, within "
                        f"{SHARE[kernel]}: the check cannot see it")


def share_note(kernel, sh):
    return ("" if sh is None else
            f"; elements that differ from the plain version: {sh[0]:.4g}, "
            f"the {PALLAS} mode's (a control) {sh[1]:.4g} (limit "
            f"{SHARE[kernel]})")


def check_kernel(attention, name, shape, failures):
    """K1 against its plain version at one flagship shape, fp32 and bf16 in
    both attention modes (VARIANTS), key-only and full masks, dropout 0
    and 0.1: the output (through fused_attention, which skips the
    log-sum-exp without a gradient) and the output and log-sum-exp of
    attention_forward (tolerance 1e-5 of max(1, |lse|)). Its timings and
    bound for each (key-only mask, no dropout: the serve case); in bf16,
    -pallas mode's rounding against fp64 (ROUNDING), the default mode's
    share of differing elements (SHARE)."""
    import torch
    import torch.nn.functional as F
    H, Lq, Lk, D = shape
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for dname, mode in VARIANTS:
        dtype = getattr(torch, dname)
        worst, worst_lse = k1_errors(attention, name, B, shape, dtype, g,
                                     failures, mode)
        q, k, v = (torch.randn(B, H, L, D, device="cuda",
                               generator=g).to(dtype)
                   for L in (Lq, Lk, Lk))
        mask = torch.where(torch.rand(B, 1, 1, Lk, device="cuda",
                                      generator=g) < 0.2, -10000.0, 0.0)
        times = {
            "ms": fwd_ms(attention, q, k, v, mask, mode=mode),
            "plain_ms": device_ms(lambda: attention.attention_reference(
                q, k, v, mask, mode=mode)),
            "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask.to(dtype))),
        }
        flops = 4.0 * B * H * Lq * Lk * D
        # q, k, v, out in the dtype; the key-only fp32 mask
        nbytes = (q.element_size() * (2 * B * H * Lq * D + 2 * B * H * Lk * D)
                  + 4.0 * B * Lk)
        rnd = sh = None
        if dname == "bfloat16" and mode == PALLAS:
            rnd = rounding(attention, q, k, v, mask)
            hold_rounding(f"K1 {name}", rnd, failures)
        elif dname == "bfloat16":
            want = (attention.attention_reference(q, k, v, mask, mode=mode),)
            sh = tuple(differing(
                (attention.fused_attention(q, k, v, mask, mode=m),), want)
                for m in (DEFAULT, PALLAS))
            hold_share(f"K1 {name}", "K1", *sh, failures)
        row = kernel_row("fwd", name, dtype, mode, worst, times, flops,
                         nbytes)
        if hasattr(attention, "fwd_design"):
            row["design"] = attention.fwd_design(dtype, mode, Lk, D)
        rows.append((row, flops, nbytes, worst_lse, rnd, sh))
    return rows


def check_bwd_kernel(attention, name, shape, failures):
    """K2 against its plain version at one flagship shape at the train
    batch, fp32 and bf16 in both attention modes (VARIANTS), key-only and
    full masks, dropout 0 and 0.1: the gradients of fused_attention (K1
    then K2 on K1's output and log-sum-exp) against
    attention_bwd_reference recomputing everything. The fp32 tolerance is
    1e-5 of the larger of 1 and the largest gradient magnitude, bf16's
    2e-2 of it. Its timings and bound for each (key-only mask, no
    dropout): K2 through autograd's backward, the plain version as the
    autograd Function runs it on CPU tensors (from K1's output and lse),
    SDPA's backward alone; in bf16 the checks of check_kernel on the
    gradients."""
    import torch
    import torch.nn.functional as F
    H, Lq, Lk, D = shape
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def inputs(dtype, full):
        return bwd_inputs(g, B_TRAIN, shape, dtype, full)

    rows = []
    for dname, mode in VARIANTS:
        dtype = getattr(torch, dname)
        worst = k2_errors(attention, name, B_TRAIN, shape, dtype, g,
                          failures, mode)
        q, k, v, gr, mask = inputs(dtype, False)
        out, lse = attention.attention_forward(q, k, v, mask, mode=mode)
        times = {
            "ms": bwd_ms(attention, q, k, v, mask, gr, mode=mode),
            "plain_ms": device_ms(lambda: attention.attention_bwd_reference(
                q, k, v, mask, gr, lse=lse, out=out, mode=mode)),
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
        rnd = sh = None
        if dname == "bfloat16" and mode == PALLAS:
            rnd = rounding(attention, q, k, v, mask, gr)
            hold_rounding(f"K2 {name}", rnd, failures)
        elif dname == "bfloat16":
            want = attention.attention_bwd_reference(q, k, v, mask, gr,
                                                     mode=mode)
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            sh = tuple(differing(torch.autograd.grad(
                attention.fused_attention(*leaves, mask, mode=m), leaves, gr),
                want) for m in (DEFAULT, PALLAS))
            hold_share(f"K2 {name}", "K2", *sh, failures)
        row = kernel_row("bwd", name, dtype, mode, worst, times, flops,
                         nbytes)
        if hasattr(attention, "bwd_design"):
            row["design"] = attention.bwd_design(dtype, mode, Lk, D)
            # two launches on the same inputs with dropout, bit for bit
            # (one block owns a (batch, head): no atomics, fixed sums)
            o2, l2 = attention.attention_forward(q, k, v, mask, 0.1, SEED,
                                                 mode=mode)
            first, second = (attention._launch_bwd(
                q, k, v, mask, gr, o2, l2, 0.1, SEED, mode) for _ in range(2))
            bits = torch.int32 if dtype == torch.float32 else torch.int16
            row["bit_equal"] = all(torch.equal(a.view(bits), b.view(bits))
                                   for a, b in zip(first, second))
            if not row["bit_equal"]:
                failures.append(f"K2 {name} {dname} {mode}: two launches "
                                f"differ")
        rows.append((row, flops, nbytes, rnd, sh))

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


def compare_scoring(kernel_recs, plain_recs, failures, tol=1e-4):
    """Kernel vs plain attention on the same questions: per-candidate NSP
    probabilities within ``tol`` and the same chosen answers (a different
    choice passes only as a tie within ``tol`` of the plain maximum)."""
    worst, ties = 0.0, 0
    for kr, pr in zip(kernel_recs, plain_recs):
        kp = {t["answer"]: t["confidence"] for t in kr["top"]}
        pp = {t["answer"]: t["confidence"] for t in pr["top"]}
        if set(kp) != set(pp):
            failures.append(f"candidate sets differ for {kr['question']!r}")
            continue
        worst = max(worst, max(abs(kp[a] - pp[a]) for a in kp))
        if kr["cls_output"] != pr["cls_output"]:
            if pp[pr["cls_output"]] - pp[kr["cls_output"]] <= tol:
                ties += 1
            else:
                failures.append(f"answers differ for {kr['question']!r}: "
                                f"{kr['cls_output']!r} vs "
                                f"{pr['cls_output']!r}")
    if worst > tol:
        failures.append(f"NSP probabilities differ by {worst} > {tol}")
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
            launches = {name: attention.LAUNCHES[("float32", DEFAULT, *shape)]
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


class EvalRecorder:
    """What one evaluate() call scored, read off the eval loop as it runs
    (the wrappers call the real functions and change nothing): the full
    protocol's per-row NSP probabilities and question offsets of each loader
    batch (segmented_argmax), the fast head's logits (the fast step's
    outputs), and top-k's shortlists with their rescored NSP probabilities
    (shortlist_rescore_rows and the rank step's outputs). Chunk outputs stay
    on the card until they are read."""

    def __init__(self, eval_loop):
        self.el = eval_loop
        self.rank = []          # (values, offsets) per loader batch
        self.short = []         # top_idx [B, K] per loader batch
        self.fast_chunks, self.rank_chunks = [], []

    def __enter__(self):
        el = self.el
        real_argmax, real_short = el.segmented_argmax, el.shortlist_rescore_rows
        real_rank, real_fast = el.make_eval_step_dedup, el.make_fast_eval_step_dedup

        def argmax(values, offsets):
            self.rank.append((values.copy(), offsets.copy()))
            return real_argmax(values, offsets)

        def short(batch, top_idx, keys=el.ROW_KEYS):
            self.short.append(top_idx.copy())
            return real_short(batch, top_idx, keys)

        def wrap(make, sink):
            def made(model):
                step = make(model)

                def recorded(*args):
                    out = step(*args)
                    sink.append(out[0])
                    return out
                return recorded
            return made

        self._patches = [
            mock.patch.object(el, "segmented_argmax", argmax),
            mock.patch.object(el, "shortlist_rescore_rows", short),
            mock.patch.object(el, "make_eval_step_dedup",
                              wrap(real_rank, self.rank_chunks)),
            mock.patch.object(el, "make_fast_eval_step_dedup",
                              wrap(real_fast, self.fast_chunks))]
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()

    def full_probs(self):
        """Per question (in loader order), the NSP probability of each valid
        candidate: the full protocol's."""
        return [v[s:e] for v, off in self.rank
                for s, e in zip(off[:-1], off[1:])]

    def fast_logits(self):
        """Per question (in loader order), the fast head's logit of each
        candidate: one chunk of question rows per loader batch, only the
        last one padded."""
        out = []
        for c in self.fast_chunks:
            out.extend(c.float().cpu().numpy())
        return out

    def topk_probs(self, chunk):
        """Per question, {candidate: rescored NSP probability} over its
        shortlist (B * K rows a loader batch, in chunks of ``chunk``)."""
        import numpy as np
        rows = [c.float().cpu().numpy() for c in self.rank_chunks]
        out, at = [], 0
        for top in self.short:
            B, K = top.shape
            n = -(-B * K // chunk)
            p = np.concatenate(rows[at:at + n])[:B * K].reshape(B, K)
            at += n
            out.extend(dict(zip(t.tolist(), q.tolist()))
                       for t, q in zip(top, p))
        return out


def compare_answers(got, want, gaps, failures, what, tol=1e-4):
    """Answers (candidate index per question) of two runs: equal wherever
    the reference run's two best candidates lie more than ``tol`` apart
    (``gaps``); returns how many differ at a near-tie."""
    ties = 0
    for q, (a, b) in enumerate(zip(got, want)):
        if a != b:
            if gaps[q] <= tol:
                ties += 1
            else:
                failures.append(f"{what}: question {q} answered {a} "
                                f"instead of {b} (gap {gaps[q]:.3g})")
    return ties


def top_gap(values):
    import numpy as np
    top = np.sort(np.asarray(values))[::-1]
    return top[0] - top[1] if len(top) > 1 else np.inf


def eval_phase(card, attention, failures):
    """Phase 5: evaluation through cli.evaluate on the flagship model, K1's
    launches per path, the plain attention's run beside it, the fast scorer
    trained by cli.train_fast_scorer, fast and top-k eval and serving."""
    import io
    from contextlib import redirect_stdout

    import numpy as np
    import torch

    from crct_tpu_torch.cli import evaluate as cli_eval
    from crct_tpu_torch.cli import train_fast_scorer as cli_fs
    from crct_tpu_torch.config import CRCTModelConfig, default_params
    from crct_tpu_torch.data.synthetic import generate_dataset
    from crct_tpu_torch.models import layers
    from crct_tpu_torch.models.crct import build_model
    from crct_tpu_torch.serve import make_server
    from crct_tpu_torch.train import eval_loop
    from crct_tpu_torch.utils.checkpoint import save_checkpoint

    model_config = os.path.join(HERE, "config", "vilbert.json")
    cfg = CRCTModelConfig.from_json_file(model_config)
    per_forward = {"text": cfg.num_hidden_layers,
                   "vision": cfg.v_num_hidden_layers,
                   "bi_text_queries": len(cfg.v_biattention_id),
                   "bi_vision_queries": len(cfg.v_biattention_id)}
    counts = {}           # path -> {(dtype, shape name): K1 launches}

    def k1_counts():
        return {(d, n): attention.LAUNCHES[(d, DEFAULT, *s)]
                for n, s in SHAPES.items()
                for d in ("float32", "bfloat16")}

    def counted(path, fn):
        before = k1_counts()
        out = fn()
        torch.cuda.synchronize()
        after = k1_counts()
        counts[path] = {k: after[k] - before[k] for k in after
                        if after[k] > before[k]}
        forwards = {n: c // per_forward[n] for (_, n), c in
                    counts[path].items() if c % per_forward[n] == 0}
        if (not counts[path] or len(forwards) != len(per_forward)
                or len(set(forwards.values())) != 1):
            failures.append(f"eval: K1 launches on the {path} path "
                            f"{counts[path]} are not {per_forward} a "
                            f"forward")
        return out

    with tempfile.TemporaryDirectory(prefix="crct_eval_") as root:
        data = generate_dataset(os.path.join(root, "data"),
                                n_images=EVAL_IMAGES, division=4,
                                n_questions=4, feat_dim=1024,
                                splits=("train", "test"), seed=SEED)
        ds_json = os.path.join(root, "ds.json")
        with open(ds_json, "w") as f:
            # directories by the logical order train, val, test
            json.dump(dict(data, main_folder="",
                           splits=["train", "val", "test"],
                           save_path=os.path.join(root, "results"),
                           max_seq_len=124, max_vis_features=44,
                           categories=228), f)
        ckpt = os.path.join(root, "random.ckpt")
        model = build_model(default_params(model_config=model_config,
                                           seed=SEED), device="cuda")
        save_checkpoint(ckpt, model.state_dict())
        del model
        base = ["-qa_file", "qa_pairs.npy", "-dataset_config", ds_json,
                "-model_config", model_config, "-seed", str(SEED),
                "-num_workers", "1", "-eval_set", "test"]

        def evaluate(name, *flags, plain=False):
            """cli.evaluate.main with the recorder on; the wall time of its
            evaluate() call (synchronized), its records and its tables."""
            rec, wall = EvalRecorder(eval_loop), []
            real = cli_eval.evaluate

            def timed(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real(*a, **k)
                torch.cuda.synchronize()
                wall.append(time.perf_counter() - t0)
                return out
            preds = os.path.join(root, f"{name}.jsonl")
            argv = base + ["-save_name", name, "-predictions_out", preds,
                           *flags]
            out = io.StringIO()
            with rec, mock.patch.object(cli_eval, "evaluate", timed), \
                    mock.patch.object(
                        layers, "fused_attention",
                        attention.attention_reference if plain
                        else layers.fused_attention), redirect_stdout(out):
                total, breakdown = cli_eval.main(argv)
            text = out.getvalue()
            tables = text[text.rindex("Avg inference time"):]
            with open(preds) as f:
                recs = [json.loads(ln) for ln in f]
            return dict(total=total, seconds=wall[0], rec=rec, recs=recs,
                        tables=tables.splitlines()[1:])

        # 1. the full protocol in fp32, and the same through the plain
        # attention
        full = counted("eval", lambda: evaluate("full"))
        n_q = int(full["total"][0, 1])
        rows = sum(int(off[-1]) for _, off in full["rec"].rank)
        before = attention.launch_count()
        plain = evaluate("plain", plain=True)
        if attention.launch_count() != before:
            failures.append("eval: the plain run launched the kernel")
        worst = 0.0
        for (v, off), (w, woff) in zip(full["rec"].rank, plain["rec"].rank):
            if not np.array_equal(off, woff):
                failures.append("eval: the plain run batched differently")
                continue
            worst = max(worst, float(np.abs(v - w).max()))
        if not worst <= 1e-4:
            failures.append(f"eval: per-row NSP probabilities differ by "
                            f"{worst} > 1e-4 from the plain attention's")
        fp, pp = full["rec"].full_probs(), plain["rec"].full_probs()
        ties = compare_answers([int(np.argmax(p)) for p in fp],
                               [int(np.argmax(p)) for p in pp],
                               [top_gap(p) for p in pp], failures,
                               "eval vs plain attention")
        launches = sum(counts["eval"].values())
        say("eval", f"cli.evaluate, full protocol, fp32, flagship model "
                    f"(random weights, seed {SEED}) on {n_q} questions of "
                    f"{EVAL_IMAGES} synthetic figures: {rows} candidate rows "
                    f"in {full['seconds']:.3f} s = "
                    f"{rows / full['seconds']:.1f} rows/s, "
                    f"{n_q / full['seconds']:.2f} questions/s; {launches} K1 "
                    f"launches ({launches // sum(per_forward.values())} "
                    f"forwards of {B} rows); against the "
                    f"plain attention (its run {plain['seconds']:.3f} s): "
                    f"per-row NSP probabilities within {worst:.3g} "
                    f"(tolerance 1e-4), {ties} answers differ at a near-tie "
                    f"(two best within 1e-4; median gap of the two best "
                    f"{np.median([top_gap(p) for p in pp]):.3g}) ({card})")
        for line in full["tables"]:
            say("eval", line)

        # where one loader batch's time goes
        params = cli_eval.read_command_line(base + ["-save_name", "prof"])
        say("eval", eval_profile(cli_eval, eval_loop, params, card))

        # 2. the full protocol with -bf16
        half = counted("eval -bf16", lambda: evaluate("bf16", "-bf16"))
        probs = np.concatenate([v for v, _ in half["rec"].rank])
        if not (np.isfinite(probs).all() and half["total"][0, 1] == n_q):
            failures.append("eval -bf16: non-finite probabilities or "
                            "questions missing")
        same = sum(a["cls_output"] == b["cls_output"]
                   for a, b in zip(half["recs"], full["recs"]))
        say("eval", f"cli.evaluate -bf16: {rows} rows in "
                    f"{half['seconds']:.3f} s = "
                    f"{rows / half['seconds']:.1f} rows/s, "
                    f"{n_q / half['seconds']:.2f} questions/s; "
                    f"{sum(counts['eval -bf16'].values())} bf16 K1 launches; "
                    f"NSP probabilities finite, in "
                    f"[{probs.min():.4f}, {probs.max():.4f}]; answers equal "
                    f"to fp32's for {same}/{n_q} ({card})")
        for line in half["tables"]:
            say("eval", line)

        # 3. the fast scorer's head, trained on the frozen backbone
        out = io.StringIO()
        t0 = time.perf_counter()
        with redirect_stdout(out):
            fs_ckpt = counted("fast-scorer training", lambda: cli_fs.main(
                base + ["-save_name", "fs", "-start_checkpoint", ckpt,
                        "-fs_steps", str(FS_STEPS)]))
        fs_s = time.perf_counter() - t0
        ces = [float(ln.rsplit(":", 1)[1]) for ln in
               out.getvalue().splitlines() if "] CE:" in ln]
        if not (len(ces) >= 2 and ces[-1] < ces[0]):
            failures.append(f"train_fast_scorer: CE {ces} did not fall")
        say("eval", f"cli.train_fast_scorer: {FS_STEPS} head steps on the "
                    f"frozen backbone in {fs_s:.1f} s (model build and "
                    f"checkpoint included); CE at the logged steps {ces}; "
                    f"{sum(counts['fast-scorer training'].values())} K1 "
                    f"launches ({card})")

        # 4. fast and top-k eval
        runs = {}
        for name, flags in (("fast", []), ("top-k 8", ["-fast_scorer_topk",
                                                        "8"]),
                            ("top-k 120", ["-fast_scorer_topk", "120"])):
            runs[name] = counted(name, lambda: evaluate(
                name.replace(" ", ""), "-fast_scorer", "-start_checkpoint",
                fs_ckpt, *flags))
            r = runs[name]
            say("eval", f"cli.evaluate -fast_scorer"
                        + (f" -fast_scorer_topk {flags[1]}" if flags else "")
                        + f": {n_q} questions in {r['seconds']:.3f} s = "
                        f"{n_q / r['seconds']:.2f} questions/s "
                        f"({r['seconds'] / full['seconds']:.3f} of the full "
                        f"protocol's time); {sum(counts[name].values())} K1 "
                        f"launches; accuracy "
                        f"{r['total'][4, 0]:.0f}/{r['total'][4, 1]:.0f} "
                        f"(full protocol {full['total'][4, 0]:.0f}) ({card})")
        # top-k covering every candidate is the full protocol
        tk = runs["top-k 120"]["rec"].topk_probs(B)
        worst = max(abs(t[c] - p[c]) for t, p in zip(tk, fp)
                    for c in range(len(p)))
        if not worst <= 1e-4:
            failures.append(f"top-k 120: NSP probabilities differ by {worst} "
                            f"> 1e-4 from the full protocol's")
        ties = compare_answers(
            [int(np.argmax([t[c] for c in range(len(p))]))
             for t, p in zip(tk, fp)],
            [int(np.argmax(p)) for p in fp], [top_gap(p) for p in fp],
            failures, "top-k 120 vs the full protocol")
        same = sum(a["cls_output"] == b["cls_output"] for a, b in
                   zip(runs["top-k 120"]["recs"], full["recs"]))
        say("eval", f"top-k 120 against the full protocol: rescored NSP "
                    f"probabilities within {worst:.3g} (tolerance 1e-4), "
                    f"answers equal for {same}/{n_q}, {ties} differ at a "
                    f"near-tie")

        # 5. fast and top-k serving over HTTP
        for name, topk in (("fast", 0), ("top-k 8", 8)):
            params = default_params(
                figure_feat_path=data["figure_feat_path"],
                qa_parent_dir=data["qa_parent_dir"], dataset_config=data,
                eval_set="test", eval_batch_size=None,
                model_config=model_config, seed=SEED, port=0,
                fast_scorer=True, fast_scorer_topk=topk,
                start_checkpoint=fs_ckpt)
            serve_fast(card, name, params, runs[name],
                       [len(p) for p in fp], counted, failures, make_server)
        torch.cuda.empty_cache()
        for path, c in counts.items():
            say("eval", f"K1 launches on the {path} path: " + ", ".join(
                f"{n} {d} {k}" for (d, n), k in sorted(c.items())))
    return counts


def serve_fast(card, name, params, run, n_cands, counted, failures,
               make_server):
    """make_server with -fast_scorer (top-k where params say so) on the
    head's checkpoint: N_SERVE_FAST known questions in one /v1/answers
    request. Each answer must be the one evaluate() chose for that question
    in ``run``, apart from near-ties in that run: its two best fast logits
    (fast), or its two best rescored NSP probabilities or the shortlist's
    last logit and the next (top-k), within 1e-4."""
    import numpy as np
    server = make_server(params, port=0, device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    asked, seen = [], {}
    for gid, qa in enumerate(server.scorer.dataset.qa["test"][:N_SERVE_FAST]):
        img = int(qa["image_index"])
        asked.append((gid, img, seen.get(img, 0)))
        seen[img] = seen.get(img, 0) + 1
    try:
        status, body, ms = counted(f"{name} serving", lambda: post(
            f"http://127.0.0.1:{server.server_address[1]}/v1/answers",
            {"questions": [{"image_index": img, "question_id": qi}
                           for _, img, qi in asked]}))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    if status != 200 or len(body.get("answers", [])) != len(asked):
        failures.append(f"{name} serving: status {status}: {body}")
        return
    k = int(params["fast_scorer_topk"])
    logits = run["rec"].fast_logits()
    probs = run["rec"].topk_probs(B) if k else None
    same = ties = 0
    for (gid, _, _), rec in zip(asked, body["answers"]):
        want = run["recs"][gid]
        if want["question_id"] != gid:
            failures.append(f"{name} serving: records out of order")
            return
        if rec["cls_output"] == want["cls_output"]:
            same += 1
            continue
        n = n_cands[gid]
        fl = np.sort(logits[gid][:n])[::-1]
        gaps = ([top_gap([p for c, p in probs[gid].items() if c < n]),
                 fl[k - 1] - fl[k] if n > k else np.inf] if k
                else [top_gap(fl)])
        if min(gaps) <= 1e-4:
            ties += 1
        else:
            failures.append(f"{name} serving: {rec['question']!r} answered "
                            f"{rec['cls_output']!r}, evaluate() chose "
                            f"{want['cls_output']!r}")
    say("eval", f"make_server -fast_scorer"
                + (f" -fast_scorer_topk {k}" if k else "")
                + f" over HTTP: /v1/answers of {len(asked)} questions in "
                f"{ms:.1f} ms; answers equal to evaluate()'s for {same}, "
                f"{ties} differ at a near-tie ({card})")


def eval_profile(cli_eval, eval_loop, params, card):
    """Device time of evaluate() over one loader batch (its questions built
    in the call, as in a run), from torch.profiler: the card's busy share
    of the wall time under the profiler, and K1's, the matrix products' and
    the other kernels' parts of it."""
    import io
    from contextlib import redirect_stdout

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from crct_tpu_torch.data.dataset import ChartQADataset, DataLoader
    ds = ChartQADataset(params, "test", init_split="test")
    ds.get_all_answers = True
    qb = min(eval_loop.resolve_eval_question_batch(params), len(ds))
    with redirect_stdout(io.StringIO()):
        model = cli_eval.load_eval_model(params, "cuda")

    def run():
        loader = DataLoader(ds, qb, shuffle=False, drop_last=False,
                            num_workers=1, indices=np.arange(qb))
        eval_loop.evaluate(loader, ds, params, model, csv=False,
                           log_print=lambda m: None)
        torch.cuda.synchronize()

    run()                                     # allocator and caches warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {"attention_fwd": 0.0, "matmul": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        low = e.key.lower()
        if "attention_fwd" in low:
            groups["attention_fwd"] += ms
        elif any(w in low for w in ("gemm", "cutlass", "xmma", "matmul",
                                    "nvjet", "cublas")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    busy = sum(groups.values())
    del model
    torch.cuda.empty_cache()
    if busy <= 0:
        return "device time: not measured (the profiler recorded none)"
    return (f"device time of evaluate() over one loader batch of {qb} "
            f"questions (fp32, examples built in the call): busy "
            f"{busy:.1f} of {wall_ms:.1f} ms wall under the profiler "
            f"({100 * busy / wall_ms:.1f}%; the host alone "
            f"{wall_ms - busy:.1f} ms): "
            + ", ".join(f"{g} {ms:.1f} ms ({100 * ms / busy:.1f}%)"
                        for g, ms in groups.items()) + f" ({card})")


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
    4 loader workers, in-train eval on the val split) and the synthetic
    train and val splits, made under root."""
    from crct_tpu_torch.config import default_params
    from crct_tpu_torch.data.dataset import ChartQADataset
    from crct_tpu_torch.data.synthetic import generate_dataset
    data = generate_dataset(os.path.join(root, "data"), n_images=TRAIN_IMAGES,
                            division=8, n_questions=4, feat_dim=1024,
                            splits=("train",), seed=SEED)
    val = generate_dataset(os.path.join(root, "data"), n_images=VAL_IMAGES,
                           division=8, n_questions=4, feat_dim=1024,
                           splits=("val",), seed=SEED + 1)
    data["dataset_files_divisions"].update(val["dataset_files_divisions"])
    data["splits"] = ["train", "val"]
    params = default_params(
        figure_feat_path=data["figure_feat_path"],
        qa_parent_dir=data["qa_parent_dir"], dataset_config=data,
        model_config=os.path.join(HERE, "config", "vilbert.json"), seed=SEED,
        batch_size=B_TRAIN, num_epochs=1, num_workers=4, no_eval=False,
        eval_set="val", eval_batch_size=None, bf16=True,
        save_path=os.path.join(root, "results"), max_seq_len=124,
        max_vis_features=44)
    return params, ChartQADataset(params, ["train", "val"])


def train_batch():
    """The first batch of the train split and its params, for the
    cross-check when the train phase does not run."""
    from crct_tpu_torch.data.dataset import DataLoader
    with tempfile.TemporaryDirectory(prefix="crct_cross_") as root:
        params, dataset = train_data(root)
        loader = DataLoader(dataset, B_TRAIN, shuffle=False, num_workers=1)
        return next(iter(loader)), params


def train(card, attention, failures):
    """Phase 6: the flagship model trained by run_training on the card,
    with its in-train eval."""
    import numpy as np
    import torch

    from crct_tpu_torch.cli.train import in_train_eval
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

        # in-train eval after the epoch, timed apart from the steps, its
        # K1 launches counted apart from theirs
        eval_s, eval_k1, eval_tables = [], {}, []

        def timed_eval(trainer, dataset, epoch_id):
            torch.cuda.synchronize()
            before = dict(attention.LAUNCHES)
            t = time.perf_counter()
            with mock.patch("crct_tpu_torch.cli.train.log_line",
                            lambda p, m: eval_tables.append(m)):
                total = in_train_eval(trainer, dataset, epoch_id)
            torch.cuda.synchronize()
            eval_s.append(time.perf_counter() - t)
            for name, shape in SHAPES.items():
                key = ("bfloat16", DEFAULT, *shape)
                eval_k1[name] = (attention.LAUNCHES[key]
                                 - before.get(key, 0))
            return total

        attention.reset_launch_count()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with mock.patch.object(train_loop.Trainer, "run_step", timed_step):
            trainer = train_loop.run_training(params, dataset,
                                              eval_fn=timed_eval,
                                              device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: (attention.LAUNCHES[("bfloat16", DEFAULT, *shape)]
                         - eval_k1.get(name, 0),
                         attention.BWD_LAUNCHES[("bfloat16", DEFAULT, *shape)])
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
        n_eval = sum(eval_k1.values())
        if len(eval_s) != 1 or n_eval < 1 or not trainer.model.training:
            failures.append(f"in-train eval: {len(eval_s)} runs, {n_eval} "
                            f"K1 launches, model training "
                            f"{trainer.model.training}")
        else:
            say("train", f"in-train eval after the epoch (cli.train."
                         f"in_train_eval, bf16 autocast over the fp32 "
                         f"masters, {VAL_IMAGES * 4} val questions, "
                         f"{params['num_workers']} loader processes): "
                         f"{eval_s[0]:.2f} s, timed apart from the steps; "
                         f"{n_eval} bf16 K1 launches; the model back in "
                         f"training mode ({card})")
            for line in "\n".join(eval_tables).splitlines():
                say("train", line)

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
        return counts, eval_k1, batch, params


def cross_attentions(attention):
    """The attention functions that the bf16 -pallas cross-check runs beside
    the kernels, each step held against the plain one:
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

    # a checkout from before the modes has the -pallas numerics alone
    pallas = {"mode": PALLAS} if hasattr(attention, "MODES") else {}

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
                return attention.attention_reference(q, k, v, mask, rate, seed,
                                                     **pallas)

        @staticmethod
        def backward(ctx, g):
            q, k, v, mask = ctx.saved_tensors
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            with torch.enable_grad(), torch.autocast(q.device.type,
                                                     enabled=False):
                out = attention.fused_attention(*leaves, mask, ctx.rate,
                                                ctx.seed, **pallas)
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

    # each stands for the -pallas numerics, whatever mode the model asks
    def formulas(rounds, fwd_shift, bwd_shift):
        return lambda q, k, v, mask, rate=0.0, seed=0, mode=None: \
            Formulas.apply(q, k, v, mask, rate, seed,
                           bf16_round if rounds else None, fwd_shift,
                           bwd_shift)

    return {"witness": lambda q, k, v, mask, rate=0.0, seed=0, mode=None:
            Witness.apply(q, k, v, mask, rate, seed),
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
    """Phase 7: one train step from the same weights and generator state
    with dropout on, through K1/K2 and through the plain forward and
    backward, in fp32 and in bf16 (autocast over fp32 masters, as the
    train phase runs) in the default attention mode and with -pallas, for
    each generator seed. fp32: the limits of FP32_CROSS (loss, every
    gradient's max |diff| over its largest magnitude, the parameters after
    the update). bf16: those of BF16_CROSS (loss, the worst leaf's
    relative L2 gradient difference apart from key biases, whose gradient
    is zero in exact arithmetic, so that what they get is rounding noise,
    printed); the update is printed, not held (AdamW's first step moves a
    parameter by about lr whatever the gradient's size).
    The bf16 -pallas witness and control steps of cross_attentions are held
    against the plain step too: the controls of MUST_FAIL must fail the
    limits. Returns the readings and the kernels' launches by mode (the
    -pallas step's are that mode's path)."""
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
    launched = {"k1": {}, "k2": {}}
    for bf16, mode in ((False, DEFAULT), (True, DEFAULT), (True, PALLAS)):
        pd = dict(params, bf16=bf16, pallas=mode == PALLAS)
        kind = "bf16" + (" -pallas" if mode == PALLAS else "") if bf16 \
            else "fp32"
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
            for k, c in (("k1", attention.LAUNCHES),
                         ("k2", attention.BWD_LAUNCHES)):
                for key, n in c.items():
                    launched[k][key] = launched[k].get(key, 0) + n
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
            if mode == PALLAS:
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
            for label in MUST_FAIL if mode == PALLAS else ():
                if all(runs[label][key] <= tol for key, tol in limits.items()):
                    failures.append(f"{kind} cross-check: {label} meets the "
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
    return readings, launched


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


def grid_sampler_call(shapes, geo, g, P, S=2, dtype=None):
    """One aten.grid_sampler_2d_backward per level computing the same
    gradient: the level's sample points (of the forward's geometry ``geo``)
    as an align_corners grid with border padding (which clamps as the
    RoIAlign sampler does), fed g / S^2 spread over the S x S samples, all
    in ``dtype`` (fp32 unless given; the grid too, as the op asks).
    Returns a function giving [H, W, C] gradients per level."""
    import torch
    dtype = dtype or torch.float32
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
        calls.append((lvl, go.to(dtype),
                      torch.zeros(1, C, H, W, device=g.device, dtype=dtype),
                      grid.to(dtype)))

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


def launched(fn, tries=3):
    """Names of the CUDA kernels, memsets and copies one call launches. A
    trace with no device event at all is taken again (up to ``tries``
    traces): the profiler has been seen to return an empty trace of a
    call that did launch, and a call that launches nothing stays empty."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    return names


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
        extra, lib = {}, ""
        library_ms = None
        if dtype != f32:
            # the op's bf16 grid moves the samples (8 bits of [-1, 1]), so
            # it times the work, not the same function: its error printed
            try:
                run_lib, timed_lib = grid_sampler_call(shapes, geo, g, P, S,
                                                       dtype)
                err_l = max((a.float() - w.float()).abs().max().item()
                            for a, w in zip(run_lib(), want))
                library_ms = device_ms(timed_lib)
                lib = (f"grid_sampler_2d_backward in bf16 x{len(hit)} "
                       f"levels {library_ms:.4f} ms (off the plain version "
                       f"by {err_l:.3g}: its bf16 grid moves the samples)")
                extra["library_err"] = err_l
            except RuntimeError as exc:
                msg = str(exc).strip().splitlines()[0]
                lib = f"grid_sampler_2d_backward in bf16 not dispatched: {msg}"
                extra["library_note"] = msg
        else:
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
    """Phase 8: the PlotQA detector trained by DetectorTrainer on the card
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
    counts = {name: rk.LAUNCHES[("float32", P, C_FPN)]
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


def ingest_chart(rng, h, w):
    """One bar chart drawn with numpy at h x w: (the uint8 RGB image, its
    annotation in the reference schema that get_gt_texts reads, free-form
    questions about it). Text is drawn as ink boxes of its extent."""
    import numpy as np

    from crct_tpu_torch.detector.synthetic_charts import WORDS
    img = np.full((h, w, 3), 255, np.uint8)

    def box(x0, y0, x1, y1, color=(40, 40, 40)):
        img[int(y0):int(y1), int(x0):int(x1)] = color
        return {"x": float(x0), "y": float(y0), "w": float(x1 - x0),
                "h": float(y1 - y0)}

    def text(x, y, s):
        return box(x, y, x + 9 * len(s), y + 14)

    left, top, right, bottom = 0.15 * w, 0.12 * h, 0.92 * w, 0.82 * h
    x_rule = box(left, bottom, right, bottom + 3, (0, 0, 0))
    y_rule = box(left - 3, top, left, bottom, (0, 0, 0))
    n = int(rng.integers(3, 8))
    cats = [str(c) for c in rng.choice(WORDS, size=n, replace=False)]
    y_max = float(rng.choice([10, 100, 1000]))
    values = np.round(rng.random(n) * y_max, 1)
    slot = (right - left) / n
    xticks = []
    for i, v in enumerate(values):
        x0 = left + i * slot + slot / 4
        box(x0, bottom - v / y_max * (bottom - top), x0 + slot / 2, bottom,
            tuple(int(c) for c in rng.integers(30, 220, 3)))
        xticks.append(text(x0, bottom + 8, cats[i]))
    yvals = [f"{y_max * j / 4:g}" for j in range(5)]
    yticks = [text(left - 12 - 9 * len(t), bottom - j / 4 * (bottom - top) - 7,
                   t) for j, t in enumerate(yvals)]
    title = " ".join(str(x) for x in rng.choice(WORDS, size=2))
    xlabel, ylabel = (str(x) for x in rng.choice(WORDS, size=2))
    gfi = {
        "title": {"text": title, "bbox": text(w / 2 - 4.5 * len(title),
                                              0.04 * h, title)},
        "x_axis": {"label": {"text": xlabel,
                             "bbox": text((left + right) / 2, 0.9 * h,
                                          xlabel)},
                   "major_labels": {"values": cats * 2,
                                    "bboxes": xticks * 2},
                   "rule": {"bbox": x_rule}},
        "y_axis": {"label": {"text": ylabel,
                             "bbox": text(0.01 * w, (top + bottom) / 2,
                                          ylabel)},
                   "major_labels": {"values": yvals * 2,
                                    "bboxes": yticks * 2},
                   "rule": {"bbox": y_rule}}}
    if rng.random() < 0.5:
        gfi["legend"] = {"items": [
            {"label": {"text": c, "bbox": text(right - 120, top + 20 * j, c)}}
            for j, c in enumerate(cats[:2])]}
    questions = ["how many bars are there ?",
                 f"what is the value of {cats[0]} ?",
                 f"does {cats[-1]} have the highest value ?"]
    return img, {"type": "vbar", "general_figure_info": gfi,
                 "models": [{"name": c, "ys": [float(v)]}
                            for c, v in zip(cats, values)]}, questions


def diff_detections(a, b, cut, nms_iou, cap, boundaries=()):
    """The valid detections of one image on two devices, matched by class
    and box (within BOX_TOL px). Returns (matched, [(side, score, why)] of
    the unmatched, max box diff, max score diff of the matched). An
    unmatched detection is at a tie when its score lies within TIE_TOL of
    the score cut, or of the lowest kept score when the cap is full, or of
    a ``boundaries`` score (the proposals' per-level top-k), or when a
    same-class detection on either side overlaps it at an IoU within
    TIE_TOL of the NMS threshold, or has its score within TIE_TOL and
    overlaps it above the threshold (which of the two is kept depends on
    the last bits). Greedy NMS visits the boxes by falling score, so a box
    kept or dropped at a tie changes what the boxes after it face: a
    difference scored below one at a tie counts as after that tie."""
    import numpy as np
    import torch

    from crct_tpu_torch.ops.nms import iou_matrix

    def valid(o):
        v = np.asarray(o["valid"], bool)
        return (np.asarray(o["boxes"])[v], np.asarray(o["scores"])[v],
                np.asarray(o["classes"])[v])

    (ba, sa, ca), (bb, sb, cb) = valid(a), valid(b)
    used, pairs = set(), []
    for i in range(len(ba)):
        d = np.abs(bb - ba[i]).max(axis=1) if len(bb) else np.zeros(0)
        for j in np.argsort(d):
            if d[j] > BOX_TOL:
                break
            if j not in used and cb[j] == ca[i]:
                used.add(j)
                pairs.append((i, j))
                break
    box_diff = max([float(np.abs(ba[i] - bb[j]).max()) for i, j in pairs],
                   default=0.0)
    score_diff = max([abs(float(sa[i] - sb[j])) for i, j in pairs],
                     default=0.0)
    all_b = np.concatenate([ba, bb])
    all_s = np.concatenate([sa, sb])
    all_c = np.concatenate([ca, cb])
    ious = iou_matrix(torch.from_numpy(all_b), torch.from_numpy(all_b)).numpy()
    odd = []
    matched_a = {i for i, _ in pairs}
    for side, idx in (("a", [i for i in range(len(ba))
                             if i not in matched_a]),
                      ("b", [j for j in range(len(bb)) if j not in used])):
        off = 0 if side == "a" else len(ba)
        for i in idx:
            k = off + i
            s = float(all_s[k])
            same = [m for m in range(len(all_b))
                    if m != k and all_c[m] == all_c[k]]
            why = None
            if abs(s - cut) <= TIE_TOL:
                why = "score cut"
            elif (len(sa) == cap or len(sb) == cap) and \
                    s <= min(sa.min(initial=1.0), sb.min(initial=1.0)) \
                    + TIE_TOL:
                why = "cap"
            elif any(abs(s - t) <= TIE_TOL for t in boundaries):
                why = "pre-NMS top-k"
            elif any(abs(ious[k, m] - nms_iou) <= TIE_TOL for m in same):
                why = "NMS IoU"
            elif any(abs(all_s[m] - s) <= TIE_TOL
                     and ious[k, m] > nms_iou - TIE_TOL for m in same):
                why = "NMS order"
            # its nearest box on the other side: IoU and score gap
            other = range(len(ba), len(all_b)) if side == "a" \
                else range(len(ba))
            near = max(other, key=lambda m: ious[k, m], default=None)
            odd.append((side, s, why, None if near is None else
                        (float(ious[k, near]), float(all_s[near] - s))))
    top_tie = max((s for _, s, why, _ in odd if why), default=-np.inf)
    odd = [(side, s, why or ("after a tie" if s <= top_tie + TIE_TOL
                             else None), near)
           for side, s, why, near in odd]
    return len(pairs), odd, box_diff, score_diff


def proposals_of(model, padded):
    """One padded image's RPN proposals on the model's device, with their
    scores (detect() keeps none) and each level's pre-NMS top-k boundary
    score: propose() as MaskRCNN.forward calls it."""
    import numpy as np
    import torch

    from crct_tpu_torch.detector.rpn import propose
    dev = next(model.parameters()).device
    with torch.inference_mode():
        p_feats = model.features(torch.from_numpy(padded[None]).to(dev))
        logits, deltas = model.proposal_generator.rpn_head(p_feats)
        boxes, scores, valid = propose(
            [x[0] for x in logits], [x[0] for x in deltas],
            model.anchors(p_feats), padded.shape[:2],
            post_nms_topk=model.post_nms_topk_test)
        edges = [torch.sigmoid(torch.sort(x[0].float(), descending=True)
                               .values[min(999, x[0].numel() - 1)]).item()
                 for x in logits]
    return ({"boxes": boxes.cpu().numpy(), "scores": scores.cpu().numpy(),
             "valid": valid.cpu().numpy(),
             "classes": np.zeros(len(boxes), np.int64)}, edges)


def card_vs_cpu(model, extract, padded, hw, cut):
    """One image on the card and on the CPU (a copy of the model): the
    proposals compared (NMS at 0.7, 512 kept, 1000 a level before it),
    then the detections of detect() (class-aware NMS at 0.5, 100 kept,
    the score cut)."""
    import copy
    cpu = copy.deepcopy(model).cpu()
    (pa, ea), (pb, eb) = proposals_of(model, padded), proposals_of(cpu, padded)
    props = diff_detections(pa, pb, cut=-1.0, nms_iou=0.7,
                            cap=model.post_nms_topk_test,
                            boundaries=ea + eb)
    [(ga, _)] = extract.detect(model, padded[None], [hw])
    [(gb, _)] = extract.detect(cpu, padded[None], [hw])
    return cpu, props, diff_detections(ga, gb, cut, 0.5, 100)


def same_text(a, b, path="text_feat"):
    """Exact equality of two text_feat trees; returns the first path that
    differs, else None."""
    import numpy as np
    if isinstance(a, dict):
        if a.keys() != b.keys():
            return path
        return next((p for k in a
                     if (p := same_text(a[k], b[k], f"{path}.{k}"))), None)
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return path
        return next((p for i, (x, y) in enumerate(zip(a, b))
                     if (p := same_text(x, y, f"{path}[{i}]"))), None)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return None if np.array_equal(np.asarray(a), np.asarray(b)) else path
    return None if a == b else path


def record_diff(got, want):
    """(what differs exactly, the largest vis_feat difference relative to
    its largest magnitude) of two feature records."""
    import numpy as np
    bad = [k for k in ("image_id", "width", "height")
           if got[k] != want[k]]
    for k in ("class", "vis_bbox"):
        if not np.array_equal(got[k], want[k]):
            bad.append(k)
    p = same_text(got["text_feat"], want["text_feat"])
    if p:
        bad.append(p)
    gf, wf = np.asarray(got["vis_feat"]), np.asarray(want["vis_feat"])
    if gf.shape != wf.shape:
        return bad + ["vis_feat shape"], np.inf
    return bad, float(np.abs(gf - wf).max()
                      / max(float(np.abs(wf).max()), 1e-6))


def ingest_profile(ingestor, img, ann, mode, card):
    """Device time of one ingest from torch.profiler against the host's:
    the wall time, the card's busy time (its kernels), the NMS loops' host
    time (the detector::nms ranges)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ingestor.ingest(img, 0, annotation=ann, ocr_mode=mode)
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.key != "detector::nms") / 1e3
    nms = [e for e in prof.events()
           if e.name == "detector::nms" and e.device_type == DeviceType.CPU]
    return {"wall": wall, "busy": busy,
            "nms_host": sum(e.cpu_time_total for e in nms) / 1e3,
            "nms_calls": len(nms)}


def ingest_phase(card, attention, failures):
    """Phase 9: chart images to answers on the card: FigureIngestor in gt
    and oracle mode, the extraction loop and its shard, a -serve_no_dataset
    server answering over HTTP through K1 beside the plain attention, one
    chart on the card against the CPU, the native tokenizer."""
    import numpy as np
    import torch

    from crct_tpu_torch.config import CRCTModelConfig, default_params
    from crct_tpu_torch.data.dataset import ChartQADataset
    from crct_tpu_torch.data.native import (NativeWordPieceTokenizer,
                                            write_vocab_file)
    from crct_tpu_torch.data.tokenizer import (WordPieceTokenizer,
                                               load_tokenizer)
    from crct_tpu_torch.detector import extract
    from crct_tpu_torch.ingest import FigureIngestor, IngestError
    from crct_tpu_torch.models import layers
    from crct_tpu_torch.serve import make_server

    t_phase = time.perf_counter()
    model_config = os.path.join(HERE, "config", "vilbert.json")
    cfg = CRCTModelConfig.from_json_file(model_config)
    per_forward = {"text": cfg.num_hidden_layers,
                   "vision": cfg.v_num_hidden_layers,
                   "bi_text_queries": len(cfg.v_biattention_id),
                   "bi_vision_queries": len(cfg.v_biattention_id)}
    rng = np.random.default_rng(SEED)
    charts = [ingest_chart(rng, h, w) for h, w in INGEST_SIZES]
    for img, _, _ in charts:
        h, w = img.shape[:2]
        if extract.resize_shortest_edge(h, w, INGEST_SHORT_EDGE,
                                        INGEST_CANVAS) != (h, w):
            failures.append(f"ingest: a {h} x {w} chart would be resized")
            return {}
    _, cls_dict = extract.get_nonvis_ids("plotqa")

    with tempfile.TemporaryDirectory(prefix="crct_ingest_") as root:
        # the native tokenizer, as load_tokenizer returns it for a vocab
        # file, against the Python tokenizer on the charts' text
        py_tok = WordPieceTokenizer.synthetic()
        vocab = write_vocab_file(py_tok.vocab, os.path.join(root, "vocab.txt"))
        t0 = time.perf_counter()
        tok = load_tokenizer(vocab)
        tok_s = time.perf_counter() - t0
        texts = [q for _, _, qs in charts for q in qs]
        for _, ann, _ in charts:
            gt = extract.get_gt_texts(ann, cls_dict, "plotqa")
            texts.extend(str(t) for t in gt["text"])
        chars = list("abcdefghijklmnopqrstuvwxyz0123456789 .,!?-_%()é")
        texts += ["".join(rng.choice(chars, size=int(rng.integers(0, 60))))
                  for _ in range(200)]
        if not isinstance(tok, NativeWordPieceTokenizer):
            failures.append(f"ingest: load_tokenizer returned "
                            f"{type(tok).__name__}, not the native one")
        bad = [t for t in texts if tok.encode(t) != py_tok.encode(t)]
        if bad:
            failures.append(f"ingest: native ids differ for {bad[:3]}")
        say("ingest", f"load_tokenizer({os.path.basename(vocab)}) -> "
                      f"{type(tok).__name__} (g++ build and load "
                      f"{tok_s:.2f} s); ids equal to the Python tokenizer's "
                      f"on {len(texts) - len(bad)}/{len(texts)} texts")

        # the detector, random weights from the seed, in an ingestor
        torch.backends.cudnn.allow_tf32 = True      # PyTorch's default
        t0 = time.perf_counter()
        model, mean, std = extract.detector_from_weights(
            "none", dataset="plotqa", num_classes=INGEST_CLASSES,
            canvas=INGEST_CANVAS, seed=SEED, device="cuda")
        ingestor = FigureIngestor(model, dataset="plotqa",
                                  canvas=INGEST_CANVAS,
                                  short_edge=INGEST_SHORT_EDGE,
                                  pixel_mean=mean, pixel_std=std)
        if (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32):
            failures.append("ingest: FigureIngestor left TF32 on")
        ingestor.warmup()
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        say("ingest", f"Mask R-CNN R50-FPN ({n_params / 1e6:.1f} M "
                      f"parameters, {INGEST_CLASSES} classes, fp32, TF32 "
                      f"off) built and warmed up (one detect) in "
                      f"{time.perf_counter() - t0:.1f} s on the "
                      f"{INGEST_CANVAS[0]} x {INGEST_CANVAS[1]} canvas")

        # host time of the record building and of the Hungarian matching,
        # read off the extraction module as it runs
        host = {"record": 0.0, "hungarian": 0.0, "oracle_in": [],
                "oracle_out": []}

        def timed(fn, key):
            def run(*a, **k):
                t = time.perf_counter()
                out = fn(*a, **k)
                host[key] += time.perf_counter() - t
                if key == "hungarian":
                    host["oracle_in"].append(len(a[0]["bboxes"]))
                    host["oracle_out"].append(len(out["text"]))
                return out
            return run

        # 1. the main path: gt-mode ingestion, then the answers over HTTP
        attention.reset_launch_count()
        gt_recs, gt_ms = [], []
        with mock.patch.object(extract, "build_feature_record",
                               timed(extract.build_feature_record, "record")):
            for i, (img, ann, _) in enumerate(charts):
                t0 = time.perf_counter()
                gt_recs.append(ingestor.ingest(img, i, annotation=ann,
                                               ocr_mode="gt"))
                gt_ms.append((time.perf_counter() - t0) * 1e3)
        gt_record_ms = host["record"] * 1e3 / len(charts)
        for i, rec in enumerate(gt_recs):
            f = rec["vis_feat"]
            if not (rec["class"][0] == 1000 and f.shape[1] == 1024
                    and np.isfinite(f).all()
                    and (rec["height"], rec["width"])
                    == charts[i][0].shape[:2]):
                failures.append(f"ingest: gt record {i}: classes "
                                f"{rec['class']}, vis_feat {f.shape}")
        n_gt_vis = sum(len(r["class"]) - 1 for r in gt_recs)
        say("ingest", f"FigureIngestor.ingest, 'gt' mode, {len(charts)} "
                      f"charts of {INGEST_SIZES[0][0]} x "
                      f"{min(w for _, w in INGEST_SIZES)}.."
                      f"{max(w for _, w in INGEST_SIZES)} (no resize): per "
                      f"figure ms "
                      f"{', '.join(f'{x:.1f}' for x in gt_ms)}; p50 "
                      f"{np.median(gt_ms):.2f} ms, "
                      f"{len(charts) / sum(gt_ms) * 1e3:.2f} figures/s "
                      f"(one at a time); record building "
                      f"{gt_record_ms:.2f} ms a figure on the host; "
                      f"{n_gt_vis} detections above the 0.5 cut, the "
                      f"records' visual rows are the <IMG> token "
                      f"otherwise ({card})")

        params = default_params(
            serve_no_dataset=True, eval_set="test", eval_batch_size=None,
            model_config=model_config, seed=SEED, port=0, vocab_file=vocab)
        t0 = time.perf_counter()
        server = make_server(params, port=0, device="cuda")
        scorer = server.scorer
        if not isinstance(scorer.dataset.tokenizer, NativeWordPieceTokenizer):
            failures.append("ingest: the server does not tokenize through "
                            "the native tokenizer")
        for rec in gt_recs:
            scorer.add_figure(rec)
        say("ingest", f"make_server -serve_no_dataset (flagship model, "
                      f"fp32, vocab file -> native tokenizer) built in "
                      f"{time.perf_counter() - t0:.1f} s; "
                      f"{len(scorer.figs)} records added")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        asked = [{"image_index": i, "question": q, "top": 1000}
                 for i, (_, _, qs) in enumerate(charts) for q in qs]
        try:
            t0 = time.perf_counter()
            with ThreadPoolExecutor(N_CONCURRENT) as pool:
                replies = list(pool.map(
                    lambda q: post(base + "/v1/answer", q), asked))
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = {name: attention.LAUNCHES[("float32", DEFAULT, *shape)]
                        for name, shape in SHAPES.items()}
            total = attention.launch_count()
            forwards = scorer.dispatches
            with urllib.request.urlopen(base + "/v1/figures",
                                        timeout=60) as resp:
                listing = json.loads(resp.read())
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        if listing != {"ingested": list(range(len(charts))),
                       "ingest_enabled": False}:
            failures.append(f"ingest: GET /v1/figures gave {listing}")
        for st, rec, _ in replies:
            if st != 200:
                failures.append(f"ingest /v1/answer status {st}: {rec}")
            check_rec(rec, failures, "ingest /v1/answer")
        if forwards < 1 or total != sum(per_forward.values()) * forwards:
            failures.append(f"ingest: {total} K1 launches for {forwards} "
                            f"model forwards, want "
                            f"{sum(per_forward.values())} per forward")
        for name, n in launches.items():
            if n != per_forward[name] * forwards:
                failures.append(f"ingest {name}: {n} launches for "
                                f"{forwards} forwards")
        lat = np.asarray([r[2] for r in replies])
        say("ingest", f"{len(asked)} free-form questions about the "
                      f"{len(charts)} ingested figures over POST /v1/answer "
                      f"({N_CONCURRENT} concurrent) in {wall:.3f} s: "
                      f"{len(asked) / wall:.2f} q/s, latency p50 "
                      f"{np.percentile(lat, 50):.1f} ms p95 "
                      f"{np.percentile(lat, 95):.1f} ms; {forwards} model "
                      f"forwards, {total} K1 launches ({card})")
        # the same questions, the same server, through the plain attention
        qas = [{"question_string": q["question"],
                "image_index": q["image_index"], "answer": None,
                "qid": None, "type": "dot"} for q in asked]
        before = attention.launch_count()
        with mock.patch.object(layers, "fused_attention",
                               attention.attention_reference):
            plain_recs = scorer.score(qas, top=1000)
        if attention.launch_count() != before:
            failures.append("ingest: the plain re-score launched K1")
        worst, ties = compare_scoring([r[1] for r in replies], plain_recs,
                                      failures)
        say("ingest", f"the answers over HTTP against the same server's "
                      f"through the plain attention: max NSP probability "
                      f"diff {worst:.3g} (tolerance 1e-4), {ties} answers "
                      f"differ at a near-tie (two best within 1e-4)")

        # 2. 'oracle' mode: the text classes favoured, a low score cut;
        # scipy's import (the Hungarian solver) is paid once, not timed
        import scipy.optimize  # noqa: F401
        cls = model.roi_heads.box_predictor.cls_score
        bias = cls.bias.detach().clone()
        with torch.no_grad():
            cls.bias[:8] += ORACLE_BIAS
        model.score_thresh_test = ORACLE_CUT
        oracle_recs, empty, or_ms = [], 0, []
        host.update(record=0.0, hungarian=0.0)
        with mock.patch.object(extract, "build_feature_record",
                               timed(extract.build_feature_record, "record")), \
                mock.patch.object(extract, "ocr_oracle",
                                  timed(extract.ocr_oracle, "hungarian")):
            for i, (img, ann, _) in enumerate(charts):
                t0 = time.perf_counter()
                try:
                    oracle_recs.append(ingestor.ingest(
                        img, 100 + i, annotation=ann, ocr_mode="oracle"))
                except IngestError:
                    empty += 1
                or_ms.append((time.perf_counter() - t0) * 1e3)
        if not sum(host["oracle_in"]):
            failures.append("ingest: no detection reached the Hungarian "
                            "oracle")
        n_vis = sum(len(r["class"]) - 1 for r in oracle_recs)
        say("ingest", f"'oracle' mode (score cut {ORACLE_CUT}, the 8 text "
                      f"and axis classes' bias +{ORACLE_BIAS}): "
                      f"{len(oracle_recs)} records, {empty} charts with no "
                      f"text detection (IngestError); text detections into "
                      f"the Hungarian oracle per chart {host['oracle_in']}, "
                      f"GT texts attached {host['oracle_out']}; "
                      f"{n_vis} visual detections; p50 "
                      f"{np.median(or_ms):.2f} ms a figure; record building "
                      f"{host['record'] * 1e3 / len(charts):.2f} ms a figure "
                      f"on the host, of which Hungarian matching "
                      f"{host['hungarian'] * 1e3 / len(charts):.3f} ms "
                      f"({card})")
        for mode, prof in (("oracle", ingest_profile(
                ingestor, charts[0][0], charts[0][1], "oracle", card)),):
            say("ingest", f"one '{mode}' ingest under torch.profiler: wall "
                          f"{prof['wall']:.2f} ms, the card busy "
                          f"{prof['busy']:.2f} ms "
                          f"({100 * prof['busy'] / prof['wall']:.1f}%); "
                          f"the {prof['nms_calls']} NMS loops (proposals "
                          f"and detections) {prof['nms_host']:.2f} ms of "
                          f"host time ({card})")

        # 3. one chart on the card against the CPU, same weights
        img0, ann0, _ = charts[0]
        padded, hw = extract.pad_image(img0.astype(np.float32),
                                       INGEST_CANVAS, INGEST_SHORT_EDGE,
                                       mean, std)
        t0 = time.perf_counter()
        cpu, props, dets = card_vs_cpu(model, extract, padded, hw,
                                       ORACLE_CUT)
        cpu_s = time.perf_counter() - t0
        ties = {}
        for name, (matched, odd, bdiff, sdiff) in (("proposals", props),
                                                   ("detections", dets)):
            why = [w for _, _, w, _ in odd]
            ties[name] = (len(why) - why.count(None), why.count(None))
            say("ingest", f"chart 0, 'oracle' settings, card vs CPU "
                          f"{name}: {matched} equal (boxes within "
                          f"{bdiff:.3g} px, scores within {sdiff:.3g}), "
                          f"{len(odd)} differ, of which at a tie "
                          f"{ties[name][0]} ({', '.join(sorted(set(w for w in why if w))) or '-'}), "
                          f"unexplained {ties[name][1]}"
                          + "".join(f"; {side} score {sc:.6f}, nearest "
                                    f"other IoU {n[0]:.4f} score gap "
                                    f"{n[1]:.3g}" for side, sc, w, n
                                    in odd if w is None and n)[:600])
        # detections downstream of a proposal that differs at a tie may
        # differ in any way; otherwise each difference must sit at a tie
        if ties["detections"][1] and not props[1]:
            failures.append(f"ingest: {ties['detections'][1]} detections "
                            f"differ between the card and the CPU away "
                            f"from a tie")
        if ties["proposals"][1]:
            failures.append(f"ingest: {ties['proposals'][1]} proposals "
                            f"differ between the card and the CPU away "
                            f"from a tie")
        # the gt record of chart 0 on the CPU: text_feat exactly equal
        with torch.no_grad():
            cls.bias.copy_(bias)
        model.score_thresh_test = 0.5
        cpu.roi_heads.box_predictor.cls_score.bias.data.copy_(bias.cpu())
        cpu.score_thresh_test = 0.5
        cpu_ing = FigureIngestor(cpu, dataset="plotqa", canvas=INGEST_CANVAS,
                                 short_edge=INGEST_SHORT_EDGE,
                                 pixel_mean=mean, pixel_std=std)
        cpu_rec = cpu_ing.ingest(img0, 0, annotation=ann0, ocr_mode="gt")
        bad, err = record_diff(cpu_rec, gt_recs[0])
        if bad or not err <= FEAT_TOL:
            failures.append(f"ingest: chart 0's gt record on the CPU "
                            f"differs from the card's in {bad}, vis_feat "
                            f"by {err:.3g} (tolerance {FEAT_TOL})")
        say("ingest", f"chart 0, 'gt' mode, the port on the CPU (same "
                      f"weights, TF32 off; {cpu_s:.1f} s for the oracle "
                      f"detect on both devices): text_feat, classes and "
                      f"boxes {'equal' if not bad else bad}, the <IMG> "
                      f"feature within {err:.3g} of its largest magnitude "
                      f"(tolerance {FEAT_TOL})")
        del cpu, cpu_ing

        # 4. the extraction loop: batched_detect, records, a shard that
        # ChartQADataset reads back
        feat_root = os.path.join(root, "feat", "test")
        qa_root = os.path.join(root, "qa", "test")
        os.makedirs(feat_root)
        os.makedirs(qa_root)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        padded, hws = zip(*[extract.pad_image(img.astype(np.float32),
                                              INGEST_CANVAS,
                                              INGEST_SHORT_EDGE, mean, std)
                            for img, _, _ in charts])
        dets = extract.batched_detect(model, list(padded), INFER_BATCH,
                                      list(hws))
        records = [extract.record_from_detection(
            i, out, feat, img.shape[:2], hw, dataset="plotqa",
            gt_texts=extract.get_gt_texts(ann, cls_dict, "plotqa"),
            ocr_mode="gt")
            for i, ((out, feat), (img, ann, _), hw)
            in enumerate(zip(dets, charts, hws))]
        np.save(os.path.join(feat_root, "0.npy"),
                np.asarray(records, dtype=object), allow_pickle=True)
        ext_s = time.perf_counter() - t0
        np.save(os.path.join(qa_root, "qa_pairs.npy"), np.asarray(
            [dict(q, qid="S1", answer=1) for q in qas], dtype=object),
            allow_pickle=True)
        ds = ChartQADataset(default_params(
            figure_feat_path=os.path.join(root, "feat", ""),
            qa_parent_dir=os.path.join(root, "qa", ""),
            dataset_config={"dataset_files_divisions": {"test": 8}},
            eval_set="test", vocab_file=vocab), "test", init_split="test")
        worst = 0.0
        for i, rec in enumerate(gt_recs):
            bad, err = record_diff(ds.get_fig_feat(i), rec)
            worst = max(worst, err)
            if bad or not err <= FEAT_TOL:
                failures.append(f"ingest: the shard's record {i} differs "
                                f"from the ingested one in {bad}, vis_feat "
                                f"by {err:.3g}")
        say("ingest", f"extraction: batched_detect at infer_batch "
                      f"{INFER_BATCH} and the records of {len(charts)} charts "
                      f"in {ext_s:.3f} s = {len(charts) / ext_s:.2f} "
                      f"images/s (normalize and pad included, no PNG "
                      f"decode); ChartQADataset.get_fig_feat reads the shard "
                      f"back equal to the ingested records (text_feat, "
                      f"classes, boxes exactly; vis_feat within "
                      f"{worst:.3g}, tolerance {FEAT_TOL}) ({card})")
    torch.cuda.empty_cache()
    say("ingest", f"phase done in {time.perf_counter() - t_phase:.1f} s")
    return launches


def remat_steps(attention, batch, params, card, failures):
    """The flagship model at batch 80 in bf16: PAR_STEPS train steps with
    remat off, then on, from the same weights and generator; the first
    steps held against each other, K1/K2 launches of a remat step, peak
    memory and the median step time of each setting."""
    import numpy as np
    import torch

    from crct_tpu_torch.config import CRCTModelConfig
    from crct_tpu_torch.models.crct import build_model
    from crct_tpu_torch.train.optimizer import AdamW
    from crct_tpu_torch.train.train_loop import device_batch, make_train_step

    model_config = os.path.join(HERE, "config", "vilbert.json")
    db = device_batch(batch, "cuda")
    pd = dict(params, bf16=True)
    runs = {}
    for remat in (False, True):
        cfg = CRCTModelConfig.from_json_file(model_config)
        cfg.remat = remat
        model = build_model(pd, config=cfg, device="cuda", train=True)
        step = make_train_step(model, AdamW(list(model.named_parameters()),
                                            pd, 12))
        gen = torch.Generator().manual_seed(SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        attention.reset_launch_count()
        ms, losses = [], []
        for i in range(PAR_STEPS):
            t = time.perf_counter()
            losses.append(float(step(db, gen)[0]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            if i == 0:
                k = {name: (attention.LAUNCHES[key],
                            attention.BWD_LAUNCHES[key])
                     for name, shape in SHAPES.items()
                     for key in [("bfloat16", DEFAULT, *shape)]}
                grads = {n: p.grad.float().cpu()
                         for n, p in model.named_parameters()
                         if p.grad is not None}
        wall, busy = busy_ms(lambda: step(db, gen))
        runs[remat] = dict(loss=losses[0], grads=grads, launches=k, ms=ms,
                           wall=wall, busy=busy,
                           median=float(np.median(ms[-3:])),
                           peak=torch.cuda.max_memory_allocated() / 1e9,
                           total={name: (attention.LAUNCHES[key],
                                         attention.BWD_LAUNCHES[key])
                                  for name, s in SHAPES.items()
                                  for key in [("bfloat16", DEFAULT, *s)]})
        del model, step
        torch.cuda.empty_cache()

    cfg = CRCTModelConfig.from_json_file(model_config)
    per_step = {"text": cfg.num_hidden_layers,
                "vision": cfg.v_num_hidden_layers,
                "bi_text_queries": len(cfg.v_biattention_id),
                "bi_vision_queries": len(cfg.v_biattention_id)}
    off, on = runs[False], runs[True]
    for name, n in per_step.items():
        if on["launches"][name] != (2 * n, n) or off["launches"][name] != (
                n, n):
            failures.append(f"remat {name}: (K1, K2) launches a step "
                            f"{on['launches'][name]} with remat and "
                            f"{off['launches'][name]} without, want "
                            f"({2 * n}, {n}) and ({n}, {n})")
    loss_rel = abs(on["loss"] - off["loss"]) / abs(off["loss"])
    worst, worst_name, equal = 0.0, "", 0
    for name, g in off["grads"].items():
        d = (on["grads"][name] - g).abs().max().item() / max(
            1.0, g.abs().max().item())
        equal += torch.equal(on["grads"][name], g)
        if d >= worst:
            worst, worst_name = d, name
    if set(on["grads"]) != set(off["grads"]) or not (
            loss_rel <= REMAT_LIMITS["loss_rel"]
            and worst <= REMAT_LIMITS["grad"]):
        failures.append(f"remat: loss relative {loss_rel}, worst gradient "
                        f"{worst_name} off by {worst} of max(1, |g|) (limits "
                        f"{REMAT_LIMITS})")
    if not on["peak"] < off["peak"]:
        failures.append(f"remat: peak {on['peak']:.2f} GB, not below "
                        f"{off['peak']:.2f} GB without remat")
    say("parallel", f"remat at batch {B_TRAIN}, bf16 autocast, dropout "
                    f"{cfg.attention_probs_dropout_prob}, the same weights "
                    f"and generator: first step's loss {on['loss']:.7f} vs "
                    f"{off['loss']:.7f} without remat (relative "
                    f"{loss_rel:.3g}, limit {REMAT_LIMITS['loss_rel']:g}); "
                    f"{equal} of {len(off['grads'])} fp32 gradients equal "
                    f"bit for bit, worst {worst_name} off by {worst:.3g} of "
                    f"max(1, |g|) (limit {REMAT_LIMITS['grad']:g}); (K1, K2) "
                    f"launches a step {sorted(set(on['launches'].values()))} "
                    f"with remat, {sorted(set(off['launches'].values()))} "
                    f"without ({card})")
    for remat, r in ((False, off), (True, on)):
        say("parallel", f"remat {'on' if remat else 'off'}: peak "
                        f"{r['peak']:.2f} GB allocated over {PAR_STEPS} "
                        f"steps, step ms "
                        f"{', '.join(f'{x:.1f}' for x in r['ms'])}, median "
                        f"of the last 3 {r['median']:.2f} ms = "
                        f"{B_TRAIN / r['median'] * 1e3:.1f} QA pairs/s; "
                        f"one more step under torch.profiler: the card busy "
                        f"{r['busy']:.2f} of {r['wall']:.2f} ms ({card})")
    return {"remat train": {(name, "bfloat16"): on["total"][name][0]
                            for name in SHAPES},
            "remat train K2": {(name, "bfloat16"): on["total"][name][1]
                               for name in SHAPES}}


def busy_ms(fn):
    """(wall ms, the card's busy ms) of one synchronized call of ``fn``
    under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    return wall, sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA) / 1e3


def spawn(argv, timeout, env=None):
    """Run a child command to its end (killed at ``timeout`` s): its exit
    code and output."""
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=dict(os.environ, **(env or {})))
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        return -9, out
    return proc.returncode, out


def free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def ddp_train(root, failures, card, nproc=1):
    """cli.train -ddp under torchrun over ``nproc`` processes, one a card
    (4 bf16 steps at batch 80 a card and the in-train eval); the checkpoint
    that rank 0 saves loaded into an unwrapped model with strict=True.
    Returns rank 0's launches."""
    from crct_tpu_torch.config import CRCTModelConfig
    from crct_tpu_torch.data.synthetic import generate_dataset
    from crct_tpu_torch.models.crct import CRCTModel
    from crct_tpu_torch.utils.checkpoint import load_checkpoint

    images = PAR_DDP_IMAGES * nproc
    data = generate_dataset(os.path.join(root, "data"), n_images=images,
                            division=8, n_questions=4, feat_dim=1024,
                            splits=("train",), seed=SEED)
    val = generate_dataset(os.path.join(root, "data"), n_images=VAL_IMAGES,
                           division=8, n_questions=4, feat_dim=1024,
                           splits=("val",), seed=SEED + 1)
    data["dataset_files_divisions"].update(val["dataset_files_divisions"])
    ds_json = os.path.join(root, "ds.json")
    with open(ds_json, "w") as f:
        json.dump(dict(data, main_folder="", splits=["train", "val"],
                       save_path=os.path.join(root, "results"),
                       max_seq_len=124, max_vis_features=44,
                       categories=228), f)
    model_config = os.path.join(HERE, "config", "vilbert.json")
    out_json = os.path.join(root, "ddp.json")
    argv = ["-qa_file", "qa_pairs.npy", "-dataset_config", ds_json,
            "-model_config", model_config, "-seed", str(SEED),
            "-batch_size", str(B_TRAIN), "-bf16", "-num_epochs", "1",
            "-num_workers", "2", "-save_name", "ddp", "-eval_set", "val",
            "-ddp", "-dist_url", "env://"]
    t0 = time.perf_counter()
    rc, out = spawn([sys.executable, "-m", "torch.distributed.run",
                     "--standalone", "--nproc_per_node", str(nproc),
                     os.path.abspath(__file__), "--child", "ddp_train",
                     HERE, out_json, "--", *argv], timeout=420)
    wall = time.perf_counter() - t0
    if rc != 0 or not os.path.exists(out_json):
        failures.append(f"torchrun cli.train -ddp: exit {rc}:\n{out[-3000:]}")
        return {}
    with open(out_json) as f:
        res = json.load(f)
    want = images * 4 * 2 // (B_TRAIN * nproc)
    cfg = CRCTModelConfig.from_json_file(model_config)
    per_step = {"text": cfg.num_hidden_layers,
                "vision": cfg.v_num_hidden_layers,
                "bi_text_queries": len(cfg.v_biattention_id),
                "bi_vision_queries": len(cfg.v_biattention_id)}
    line = f"De facto batch_size: {B_TRAIN}*{nproc}*1 = {B_TRAIN * nproc}"
    if (res["steps"] != want or res["world"] != nproc or res["built"]
            or line not in out):
        failures.append(f"torchrun cli.train -ddp: {res['steps']} steps "
                        f"(want {want}), world {res['world']} (want "
                        f"{nproc}), kernels built again: {res['built']}, "
                        f"'{line}' {'logged' if line in out else 'missing'}")
    for name, n in per_step.items():
        k1, k2 = res["train"][name]
        if (k1, k2) != (n * want, n * want) or res["eval"][name] < 1:
            failures.append(f"torchrun cli.train -ddp {name}: (K1, K2) "
                            f"launches of rank 0's steps {(k1, k2)}, want "
                            f"{(n * want, n * want)}; in-train eval K1 "
                            f"{res['eval'][name]}")
    model = CRCTModel(cfg, categories=228)
    saved = load_checkpoint(res["checkpoint"])["model_state_dict"]
    try:
        model.load_state_dict(saved, strict=True)
        strict = "loads with strict=True"
    except RuntimeError as exc:
        strict = f"does not load: {str(exc)[:300]}"
        failures.append(f"torchrun cli.train -ddp: the checkpoint {strict}")
    group = ("one process, so no process group forms, as in the JAX "
             "initializer" if nproc == 1 else "nccl, a gloo group for the "
             "host's reductions")
    say("parallel", f"torchrun --standalone --nproc_per_node {nproc} "
                    f"cli.train -ddp (world size {res['world']}: {group}): "
                    f"{res['steps']} bf16 steps at batch {B_TRAIN} a rank "
                    f"and the in-train eval (its {res['eval_count']} "
                    f"questions once over the ranks) in {wall:.1f} s wall "
                    f"(the children's start and model build included), "
                    f"losses {res['losses']}, rank 0's K1/K2 launches of "
                    f"the steps "
                    f"{sorted(set(map(tuple, res['train'].values())))} and "
                    f"K1 of its in-train eval {res['eval']}; the kernels "
                    f"loaded from build/kernels/ ({len(res['built'])} built "
                    f"in the child); the rank-0 checkpoint "
                    f"{os.path.basename(res['checkpoint'])} {strict} into "
                    f"an unwrapped CRCTModel ({card})")
    del model, saved
    return {"ddp train": {(name, "bfloat16"): res["train"][name][0]
                          for name in SHAPES},
            "ddp in-train eval": {(name, "bfloat16"): res["eval"][name]
                                  for name in SHAPES},
            "ddp train K2": {(name, "bfloat16"): res["train"][name][1]
                             for name in SHAPES}}


def eval_data(root):
    """The eval phase's synthetic test split, its dataset config and the
    flagship model's random weights as a checkpoint, under root; the eval
    CLI's arguments."""
    from crct_tpu_torch.config import default_params
    from crct_tpu_torch.data.synthetic import generate_dataset
    from crct_tpu_torch.models.crct import build_model
    from crct_tpu_torch.utils.checkpoint import save_checkpoint

    model_config = os.path.join(HERE, "config", "vilbert.json")
    data = generate_dataset(os.path.join(root, "eval"),
                            n_images=EVAL_IMAGES, division=4, n_questions=4,
                            feat_dim=1024, splits=("train", "test"),
                            seed=SEED)
    ds_json = os.path.join(root, "eval.json")
    with open(ds_json, "w") as f:
        json.dump(dict(data, main_folder="", splits=["train", "val", "test"],
                       save_path=os.path.join(root, "results"),
                       max_seq_len=124, max_vis_features=44,
                       categories=228), f)
    ckpt = os.path.join(root, "random.ckpt")
    model = build_model(default_params(model_config=model_config, seed=SEED),
                        device="cuda")
    save_checkpoint(ckpt, model.state_dict())
    del model
    return ["-qa_file", "qa_pairs.npy", "-dataset_config", ds_json,
            "-model_config", model_config, "-seed", str(SEED),
            "-num_workers", "1", "-eval_set", "test",
            "-start_checkpoint", ckpt]


def rank_group(batch, params, root, failures, card, world, backend):
    """``world`` ranks, started by this script: over gloo all on the one
    card (nccl refuses two ranks on one device), over nccl one a card.
    (a) an fp32 QA step at batch 80 / world a rank against the one-rank
    step at batch 80, (b) cli.evaluate over the ranks against the one-rank
    run in this process, (c) an fp32 detector step at one image a rank
    against the one-rank step over the same images, the ranks replaying its
    ReLU signs and proposals. Returns the ranks' launches by path."""
    import io
    from contextlib import redirect_stdout

    import numpy as np

    from crct_tpu_torch.cli import evaluate as cli_eval
    from crct_tpu_torch.detector.trainer import (BATCH_KEYS,
                                                 detector_batch_iterator)

    tag = f"{world} {backend} ranks"
    argv = eval_data(root)
    with redirect_stdout(io.StringIO()):
        one_total, one_breakdown = cli_eval.main(
            argv + ["-save_name", "one", "-predictions_out",
                    os.path.join(root, "one.jsonl")])
    n_q = int(one_total[4, 1])

    # (a)'s batch and (c)'s, for the children
    np.savez(os.path.join(root, "qa_batch.npz"),
             **{k: np.asarray(v) for k, v in batch.items()
                if isinstance(v, np.ndarray)})
    det_batch = next(detector_batch_iterator(ChartSet(CANVAS), world,
                                             BATCH_KEYS, 1, seed=SEED))
    np.savez(os.path.join(root, "det_batch.npz"), **det_batch)
    with open(os.path.join(root, "case.json"), "w") as f:
        json.dump({"params": {k: v for k, v in params.items()
                              if isinstance(v, (int, float, str, bool))},
                   "eval_argv": argv + [
                       "-save_name", "ranks", "-predictions_out",
                       os.path.join(root, "ranks.jsonl")]}, f)

    port = str(free_port())
    t0 = time.perf_counter()
    logs = [open(os.path.join(root, f"rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", "ranks", HERE,
         root, str(r), str(world), port, backend], stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    # a rank that fails ends the others, which would wait for it
    while any(p.poll() is None for p in procs):
        if (any(p.poll() not in (None, 0) for p in procs)
                or time.perf_counter() - t0 > 600):
            for p in procs:
                p.kill()
        time.sleep(0.5)
    wall = time.perf_counter() - t0
    res = []
    for r, p in enumerate(procs):
        logs[r].close()
        path = os.path.join(root, f"rank_{r}.json")
        if p.returncode != 0 or not os.path.exists(path):
            with open(logs[r].name) as f:
                failures.append(f"{tag}, rank {r}: exit {p.returncode}:\n"
                                f"{f.read()[-3000:]}")
            return {}
        with open(path) as f:
            res.append(json.load(f))
    ref = res[0]["reference"]

    # (a) the QA step
    qa = ref["qa"]
    if not (qa["loss_rel"] <= FP32_CROSS["loss_rel"]
            and qa["grad"] <= PAR_QA_GRAD):
        failures.append(f"{tag} QA step: loss relative {qa['loss_rel']}, "
                        f"worst gradient {qa['grad_of']} off by "
                        f"{qa['grad']} of max(1, |g|)")
    same = len({r_["qa_digest"] for r_ in res}) == 1
    if not same:
        failures.append(f"{tag} QA step: the ranks' gradients differ after "
                        f"the all-reduce")
    say("parallel", f"{tag}, fp32 QA step at local batch {B_TRAIN // world}"
                    f" (dropout 0, TF32 off) against the one-rank step at "
                    f"batch {B_TRAIN}: loss {qa['loss']:.7f} vs "
                    f"{qa['want_loss']:.7f} (relative {qa['loss_rel']:.3g}, "
                    f"limit {FP32_CROSS['loss_rel']:g}), worst gradient "
                    f"{qa['grad_of']} off by {qa['grad']:.3g} of max(1, |g|)"
                    f" (limit {PAR_QA_GRAD:g}); {qa['equal']} of {qa['n']} "
                    f"gradients equal bit for bit; the ranks' gradients "
                    f"after the all-reduce equal: {same}; one all-reduce of "
                    f"the gradients {qa['reduce_ms']:.1f} ms ({card})")

    # (b) the eval CLI
    same_tables, n_recs = True, 0
    for r in range(world):
        total = np.asarray(res[r]["total"])
        breakdown = np.asarray(res[r]["breakdown"])
        if not (np.array_equal(total, one_total)
                and np.array_equal(breakdown, one_breakdown)):
            same_tables = False
            failures.append(f"{tag} eval, rank {r}: tables differ from the "
                            f"one-rank run: {total.tolist()} vs "
                            f"{one_total.tolist()}")
        n_recs += res[r]["eval_questions"]
    if n_recs != n_q:
        failures.append(f"{tag} eval: {n_recs} prediction records over the "
                        f"ranks' files, want {n_q}")
    say("parallel", f"cli.evaluate over {tag}, {n_q} questions "
                    f"({', '.join(str(r_['eval_questions']) for r_ in res)} "
                    f"a rank): total and breakdown tables "
                    f"{'equal' if same_tables else 'NOT equal'} to the "
                    f"one-rank run's; {n_recs} prediction records in "
                    f"ranks.jsonl.rank* ({card})")

    # (c) the detector step
    det = ref["det"]
    if not (det["loss_rel"] <= 1e-5 and det["grad"] <= 1e-4
            and det["param"] <= 1e-6):
        failures.append(f"{tag} detector step: loss rel {det['loss_rel']}, "
                        f"gradient of {det['grad_of']} off by {det['grad']}, "
                        f"parameters by {det['param']}")
    k3 = [r_["det_k3"] for r_ in res]
    if k3 != [{n: 1 for n in ROI_SHAPES}] * world:
        failures.append(f"{tag} detector step: K3 launches per rank {k3}, "
                        f"want one of each shape a rank")
    flips = [r_["det_flips"] for r_ in res]
    flip_max = max(r_["det_flip_max"] for r_ in res)
    if flip_max >= PAR_KINK:
        failures.append(f"{tag} detector step: a ReLU input {flip_max} from "
                        f"zero took the other side than in the one-rank "
                        f"step (limit {PAR_KINK:g})")
    untied = [r_["det_props"][1] for r_ in res]
    if any(untied):
        failures.append(f"{tag} detector step: proposals of the ranks' own "
                        f"differ from the one-rank step's at no tie: "
                        f"{untied} a rank")
    say("parallel", f"{tag}, fp32 detector step at one image a rank "
                    f"({CANVAS}^2 canvas) against the one-rank step at batch"
                    f" {world} (the trunk over the batch), the same sampling "
                    f"noise, each rank replaying its image's ReLU signs and "
                    f"proposals of the one-rank step: losses within "
                    f"{det['loss_rel']:.3g} relative (limit 1e-5), worst "
                    f"gradient {det['grad_of']} off by {det['grad']:.3g} of "
                    f"its largest magnitude (limit 1e-4), parameters after "
                    f"SGD within {det['param']:.3g} (limit 1e-6); the ranks' "
                    f"own ReLU inputs on the other side {flips} (each within "
                    f"{flip_max:.3g} of zero, limit {PAR_KINK:g}), their own "
                    f"proposal rows not among its "
                    f"{[r_['det_props'][0] for r_ in res]}, rows that differ "
                    f"at no NMS or top-k tie {untied}; K3 launches per rank "
                    f"{k3} ({card})")
    say("parallel", f"{tag}: {wall:.1f} s wall (the processes' start, rank "
                    f"0's two one-rank reference steps, the three runs); "
                    f"kernels built again in the children: "
                    f"{[r_['built'] for r_ in res]} ({card})")
    if any(r_["built"] for r_ in res):
        failures.append(f"{tag}: kernels built again")
    paths = (f"{backend} QA step", f"{backend} eval", f"{backend} QA step K2")
    out = {p: {} for p in paths + (f"{backend} detector",)}
    for r_ in res:
        for path, key in zip(paths, ("qa_k1", "eval_k1", "qa_k2")):
            for name, c in r_[key].items():
                out[path][(name, "float32")] = (
                    out[path].get((name, "float32"), 0) + c)
        for name, c in r_["det_k3"].items():
            out[f"{backend} detector"][name] = (
                out[f"{backend} detector"].get(name, 0) + c)
    return out


def parallel_phase(card, attention, batch, params, failures):
    """Phase 10: remat on the train path, cli.train -ddp under torchrun,
    and two gloo ranks on the one card. Returns the launches of each of
    its paths."""
    import torch
    counts = remat_steps(attention, batch, params, card, failures)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="crct_par_") as root:
        counts.update(ddp_train(os.path.join(root, "ddp"), failures, card))
        counts.update(rank_group(batch, params, os.path.join(root, "gloo"),
                                 failures, card, 2, "gloo"))
    return counts


def cards_phase(card, batch, params, failures):
    """Across the cards of one machine (run it alone, on 2 or more): cli.train
    -ddp under torchrun over every card (nccl), the rank group of the
    parallel phase over nccl with one rank a card, and a QAScorer with a
    replica on each card answering as one card does."""
    import torch
    n = torch.cuda.device_count()
    if n < 2:
        failures.append(f"cards: {n} card visible, the phase needs 2 or more")
        return
    with tempfile.TemporaryDirectory(prefix="crct_cards_") as root:
        ddp_train(os.path.join(root, "ddp"), failures, card, nproc=n)
        rank_group(batch, params, os.path.join(root, "nccl"), failures, card,
                   n, "nccl")
        serve_over_cards(os.path.join(root, "serve"), failures, card, n)
    # the bench's headline and QA sections over every card, one rank a card
    bench_phase(card, failures, ("--no-e2e", "--no-detector"), nproc=n)


def serve_over_cards(root, failures, card, n):
    """QAScorer over cuda:0..n-1 (one replica a card, each dispatch split
    across them) against QAScorer on cuda:0, on the eval split's questions:
    every candidate's NSP probability within 1e-6, the same answers apart
    from ties within 1e-6 (random weights put candidates ~1e-7 apart)."""
    import torch

    from crct_tpu_torch.cli.evaluate import load_eval_model
    from crct_tpu_torch.config import read_command_line
    from crct_tpu_torch.data.dataset import ChartQADataset
    from crct_tpu_torch.serve import QAScorer

    params = read_command_line(eval_data(root) + ["-save_name", "serve"])
    ds = ChartQADataset(params, params["eval_set"],
                        init_split=params["eval_set"])
    ds.get_all_answers = True
    model = load_eval_model(params, "cuda:0")
    qas = ds.qa[params["eval_set"]][:24]
    one = QAScorer(params, ds, model=model, device="cuda:0")
    many = QAScorer(params, ds, model=model,
                    device=[f"cuda:{i}" for i in range(n)])
    # the first call of each warms its cards (cuBLAS handles, the
    # kernels' attributes); the times are the median of the calls after it
    want = one.score(qas, top=1000)
    got = many.score(qas, top=1000)
    worst, ties = compare_scoring(got, want, failures, tol=1e-6)
    if many.chunk % n:
        failures.append(f"serving over {n} cards: chunk {many.chunk}")

    def median_ms(scorer):
        ms = []
        for _ in range(SERVE_CALLS):
            t0 = time.perf_counter()
            scorer.score(qas, top=1000)
            for i in range(n):
                torch.cuda.synchronize(i)
            ms.append((time.perf_counter() - t0) * 1e3)
        return sorted(ms)[len(ms) // 2], ms

    one_ms, one_all = median_ms(one)
    many_ms, many_all = median_ms(many)
    say("parallel", f"QAScorer over {n} cards ({many.chunk} rows a dispatch"
                    f", {many.chunk // n} a card) against one card, "
                    f"{len(qas)} questions: every candidate's NSP within "
                    f"{worst:.3g} (limit 1e-6), the answers equal apart from"
                    f" {ties} ties within 1e-6; score() after a warm-up call"
                    f" each, median of {SERVE_CALLS}: {many_ms:.1f} ms "
                    f"({', '.join(f'{t:.1f}' for t in many_all)}) against "
                    f"{one_ms:.1f} ms on one card "
                    f"({', '.join(f'{t:.1f}' for t in one_all)}) ({card})")


def child_ddp_train(tree, out_json, argv):
    """torchrun's worker: cli.train.main, the kernels' launches of its
    steps and of its in-train eval apart, its checkpoint (rank 0 writes
    them)."""
    import glob

    sys.path.insert(0, tree)
    import torch

    from crct_tpu_torch import parallel
    from crct_tpu_torch.cli import train as cli_train
    from crct_tpu_torch.ops import attention, build
    from crct_tpu_torch.train import train_loop

    def k1():
        return {n: (attention.LAUNCHES[("bfloat16", DEFAULT, *s)],
                    attention.BWD_LAUNCHES[("bfloat16", DEFAULT, *s)])
                for n, s in SHAPES.items()}

    evals, losses, counted = {}, [], []
    real_eval, real_step = cli_train.in_train_eval, train_loop.Trainer.run_step

    def counted_eval(trainer, dataset, epoch_id):
        before = k1()
        total = real_eval(trainer, dataset, epoch_id)
        torch.cuda.synchronize()
        after = k1()
        evals.update({n: after[n][0] - before[n][0] for n in SHAPES})
        counted.append(int(total[4, 1]))
        return total

    def step(self, b):
        m = real_step(self, b)
        losses.append(round(float(m[0]), 5))
        return m

    attention.reset_launch_count()
    with mock.patch.object(cli_train, "in_train_eval", counted_eval), \
            mock.patch.object(train_loop.Trainer, "run_step", step):
        trainer = cli_train.main(argv)
    if parallel.rank() != 0:
        return 0
    total = k1()
    ckpts = glob.glob(os.path.join(trainer.params_dict["save_path"],
                                   "plotqa_encoder_0_*.ckpt"))
    with open(out_json, "w") as f:
        json.dump({"steps": trainer.step, "world": parallel.world_size(),
                   "losses": losses, "built": sorted(build.BUILD_LOG),
                   "train": {n: (total[n][0] - evals.get(n, 0), total[n][1])
                             for n in SHAPES},
                   "eval": evals, "eval_count": counted[0],
                   "checkpoint": sorted(ckpts)[-1]}, f)
    return 0


def child_ranks(tree, root, rank, world, port, backend):
    """One rank of rank_group. Rank 0 first takes the one-rank reference
    steps, before the group forms."""
    import hashlib
    import io
    from contextlib import redirect_stdout

    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import torch.nn.functional as F

    from crct_tpu_torch import parallel
    from crct_tpu_torch.cli import evaluate as cli_eval
    from crct_tpu_torch.config import CRCTModelConfig
    from crct_tpu_torch.detector import boxes, mask_rcnn
    from crct_tpu_torch.detector.trainer import DetectorTrainer
    from crct_tpu_torch.models import layers
    from crct_tpu_torch.models.crct import build_model
    from crct_tpu_torch.ops import attention, build
    from crct_tpu_torch.ops import roi_align_kernel as rk
    from crct_tpu_torch.train.optimizer import AdamW
    from crct_tpu_torch.train.train_loop import device_batch, make_train_step

    device = f"cuda:{rank if backend == 'nccl' else 0}"
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layers.DropoutRNG.dropout = lambda self, x, p: x     # dropout 0
    with open(os.path.join(root, "case.json")) as f:
        case = json.load(f)
    params = dict(case["params"], bf16=False)
    cfg = CRCTModelConfig.from_json_file(os.path.join(tree, "config",
                                                      "vilbert.json"))
    for k in ("hidden_dropout_prob", "attention_probs_dropout_prob",
              "v_hidden_dropout_prob", "v_attention_probs_dropout_prob"):
        setattr(cfg, k, 0.0)
    qa = dict(np.load(os.path.join(root, "qa_batch.npz")))
    det = dict(np.load(os.path.join(root, "det_batch.npz")))

    def qa_step(rows):
        model = build_model(params, config=cfg, device=device, train=True)
        m = make_train_step(model, AdamW(list(model.named_parameters()),
                                         params, 12))(
            device_batch({k: v[rows] for k, v in qa.items()}, device),
            torch.Generator())
        torch.cuda.synchronize()
        grads = {n: p.grad for n, p in model.named_parameters()
                 if p.grad is not None}
        return float(m[0]), grads

    def det_step(draws, kinks=None):
        """One fp32 detector step over this rank's images. With ``draws``
        None it records the samplers' noise, every ReLU's sign and each
        image's proposals (the one-rank reference); else it replays the
        noise and, from ``kinks``, the reference's ReLU signs and proposals
        for its one image, counting the ReLU inputs and proposal rows of its
        own that differ from them, and the rows that differ at no NMS or
        top-k tie (diff_detections)."""
        real = boxes._draw_uniform
        record = draws is None
        draws = [] if record else list(draws)
        signs, props, seen = [], [], {"image": None, "flips": 0,
                                      "flip_max": 0.0, "props": 0,
                                      "props_untied": 0}
        replay = None if kinks is None else iter(kinks["signs"])
        real_relu, real_prop = F.relu, mask_rcnn.propose
        real_losses = mask_rcnn.MaskRCNN._train_losses

        def draw(gen, n, dev):
            if record:
                draws.append(real(gen, n, dev))
                return draws[-1]
            return draws.pop(0).to(dev)

        def relu(x, inplace=False):
            if replay is None:
                signs.append((seen["image"], x.detach() > 0))
                return real_relu(x)
            want = next(replay).to(x.device)
            if want.shape != x.shape:
                raise RuntimeError(f"ReLU replay: {tuple(want.shape)} "
                                   f"recorded, {tuple(x.shape)} here")
            flip = want != (x.detach() > 0)
            if flip.any():
                seen["flips"] += int(flip.sum())
                seen["flip_max"] = max(seen["flip_max"],
                                       x.detach()[flip].abs().max().item())
            return torch.where(want, x, torch.zeros_like(x))

        def as_dets(out):
            b, sc, v = (t.float().cpu().numpy() for t in out)
            return {"boxes": b, "scores": sc, "valid": v.astype(bool),
                    "classes": np.zeros(len(b), np.int64)}

        def propose(*a, **kw):
            out = real_prop(*a, **kw)
            if kinks is None:
                props.append([t.cpu() for t in out])
                return out
            want = kinks["proposals"]
            # each level's pre-NMS top-k boundary score, as proposals_of
            edges = [torch.sigmoid(torch.sort(x.float(), descending=True)
                                   .values[min(999, x.numel() - 1)]).item()
                     for x in a[0]]
            _, odd, _, _ = diff_detections(as_dets(out), as_dets(want), 0.0,
                                           0.7, len(want[0]), edges)
            seen["props"] += sum(side == "a" for side, _, _, _ in odd)
            seen["props_untied"] += sum(why is None for _, _, why, _ in odd)
            return tuple(t.to(out[0].device) for t in want)

        def train_losses(self, *a, **kw):
            seen["image"] = 0 if seen["image"] is None else seen["image"] + 1
            return real_losses(self, *a, **kw)

        trainer = DetectorTrainer(num_classes=DET_CLASSES, with_mask=True,
                                  depth=50, seed=SEED, batch_size=world,
                                  device=device)
        before = {n: rk.LAUNCHES[("float32", P, C_FPN)]
                  for n, (P, _) in ROI_SHAPES.items()}
        with mock.patch.object(boxes, "_draw_uniform", draw), \
                mock.patch.object(F, "relu", relu), \
                mock.patch.object(mask_rcnn, "propose", propose), \
                mock.patch.object(mask_rcnn.MaskRCNN, "_train_losses",
                                  train_losses):
            losses = trainer.run_step(det)
        torch.cuda.synchronize()
        k3 = {n: rk.LAUNCHES[("float32", P, C_FPN)] - before[n]
              for n, (P, _) in ROI_SHAPES.items()}
        per_image = None
        if record:
            # image i's signs: its slice of the batched trunk and RPN
            # head's, then its own heads'
            per_image = [{"signs": [m[i:i + 1].cpu() if tag is None
                                    else m.cpu()
                                    for tag, m in signs
                                    if tag is None or tag == i],
                          "proposals": props[i]} for i in range(world)]
        return (losses, {n: p.grad.clone()
                         for n, p in trainer.model.named_parameters()},
                {n: p.detach().clone()
                 for n, p in trainer.model.named_parameters()},
                k3, seen, draws if record else None, per_image)

    ref = {}
    if rank == 0:
        want_loss, want = qa_step(slice(None))
        want = {n: g.cpu() for n, g in want.items()}
        torch.cuda.empty_cache()
        # the production one-rank step over the whole batch
        d_losses, d_grads, d_params, _, _, draws, kinks = det_step(None)
        d_grads = {n: g.cpu() for n, g in d_grads.items()}
        d_params = {n: p.cpu() for n, p in d_params.items()}
        torch.save([d.cpu() for d in draws], os.path.join(root, "draws.pt"))
        for i, k in enumerate(kinks):
            torch.save(k, os.path.join(root, f"kinks_{i}.pt"))
        del kinks
        torch.cuda.empty_cache()

    parallel.init_distributed(world, rank,
                              init_method=f"tcp://127.0.0.1:{port}",
                              device=device, backend=backend)
    res = {"built": sorted(build.BUILD_LOG)}

    # (a) the QA step at local batch B_TRAIN / world
    local = B_TRAIN // world
    attention.reset_launch_count()
    loss, grads = qa_step(slice(rank * local, (rank + 1) * local))
    res["qa_k1"] = {n: attention.LAUNCHES[("float32", DEFAULT, *s)]
                    for n, s in SHAPES.items()}
    res["qa_k2"] = {n: attention.BWD_LAUNCHES[("float32", DEFAULT, *s)]
                    for n, s in SHAPES.items()}
    h = hashlib.sha256()
    for n in sorted(grads):
        h.update(grads[n].float().cpu().numpy().tobytes())
    res["qa_digest"] = h.hexdigest()
    if rank == 0:
        worst, worst_name, equal = 0.0, "", 0
        for n, w in want.items():
            g = grads[n].float().cpu()
            d = (g - w).abs().max().item() / max(1.0, w.abs().max().item())
            equal += torch.equal(g, w)
            if d >= worst:
                worst, worst_name = d, n
        ref["qa"] = {"loss": loss, "want_loss": want_loss,
                     "loss_rel": abs(loss - want_loss) / abs(want_loss),
                     "grad": worst, "grad_of": worst_name, "equal": equal,
                     "n": len(want)}
    # one more all-reduce of the gradients, timed alone
    torch.cuda.synchronize()
    t = time.perf_counter()
    parallel.allreduce_gradients(grads.values())
    torch.cuda.synchronize()
    if rank == 0:
        ref["qa"]["reduce_ms"] = (time.perf_counter() - t) * 1e3
    del grads
    torch.cuda.empty_cache()

    # (b) cli.evaluate over the process group
    attention.reset_launch_count()
    with redirect_stdout(io.StringIO()):
        total, breakdown = cli_eval.main(case["eval_argv"] + [
            "-cuda_num", device.split(":")[1]])
    res["total"], res["breakdown"] = total.tolist(), breakdown.tolist()
    res["eval_k1"] = {n: attention.LAUNCHES[("float32", DEFAULT, *s)]
                      for n, s in SHAPES.items()}
    with open(case["eval_argv"][-1] + f".rank{rank}") as f:
        res["eval_questions"] = sum(1 for _ in f)
    torch.cuda.empty_cache()

    # (c) the detector step, one image a rank, the reference's noise
    draws = torch.load(os.path.join(root, "draws.pt"))
    losses, grads, new, res["det_k3"], seen, _, _ = det_step(
        draws[2 * rank:2 * rank + 2],
        torch.load(os.path.join(root, f"kinks_{rank}.pt")))
    res["det_flips"], res["det_flip_max"] = seen["flips"], seen["flip_max"]
    res["det_props"] = (seen["props"], seen["props_untied"])
    if rank == 0:
        rel = max(abs(float(losses[k]) - float(d_losses[k]))
                  / max(abs(float(d_losses[k])), 1e-12) for k in d_losses)
        worst, worst_name = 0.0, ""
        for n, w in d_grads.items():
            r_ = ((grads[n].cpu() - w).abs().max()
                  / w.abs().max().clamp(min=1e-6)).item()
            if r_ >= worst:
                worst, worst_name = r_, n
        ref["det"] = {"loss_rel": rel, "grad": worst, "grad_of": worst_name,
                      "param": max((p.cpu() - d_params[n]).abs().max().item()
                                   for n, p in new.items())}
        res["reference"] = ref
    with open(os.path.join(root, f"rank_{rank}.json"), "w") as f:
        json.dump(res, f)
    parallel.destroy()
    return 0


def bert_state_dict(seed):
    """A BERT-base state dict with HF names (the text-stream layers, the
    pooler, token types and the pretraining heads; the first LayerNorm in
    the old gamma/beta names), weights drawn from ``seed`` at 0.02."""
    import torch
    g = torch.Generator().manual_seed(seed)
    H, F, V, P = (BERT_BASE[k] for k in ("hidden", "intermediate", "vocab",
                                         "positions"))
    shapes = {"bert.embeddings.word_embeddings.weight": (V, H),
              "bert.embeddings.position_embeddings.weight": (P, H),
              "bert.embeddings.token_type_embeddings.weight": (2, H),
              "bert.embeddings.LayerNorm.gamma": (H,),
              "bert.embeddings.LayerNorm.beta": (H,),
              "bert.pooler.dense.weight": (H, H), "bert.pooler.dense.bias": (H,),
              "cls.seq_relationship.weight": (2, H),
              "cls.seq_relationship.bias": (2,)}
    for i in range(BERT_BASE["layers"]):
        base = f"bert.encoder.layer.{i}"
        for sub, (o, n) in (("attention.self.query", (H, H)),
                            ("attention.self.key", (H, H)),
                            ("attention.self.value", (H, H)),
                            ("attention.output.dense", (H, H)),
                            ("intermediate.dense", (F, H)),
                            ("output.dense", (H, F))):
            shapes[f"{base}.{sub}.weight"] = (o, n)
            shapes[f"{base}.{sub}.bias"] = (o,)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            shapes[f"{base}.{ln}.weight"] = (H,)
            shapes[f"{base}.{ln}.bias"] = (H,)
    return {k: torch.randn(s, generator=g) * 0.02 for k, s in shapes.items()}


def weights_phase(card, attention, failures):
    """Phase 11: the weight tools on the card with the flagship model. A
    reference-layout crct.ckpt of the seeded random weights through
    cli.convert_checkpoint, evaluated and served through K1 against the
    same weights loaded directly; a BERT-base through cli.import_bert into
    cli.train -start_checkpoint, a few bf16 steps through K1 and K2 from
    the imported text stream. Returns {"k1"/"k2": {path: {(dtype, shape
    name): launches}}}."""
    import io
    from contextlib import redirect_stdout

    import numpy as np
    import torch

    from crct_tpu_torch.cli import convert_checkpoint as cli_convert
    from crct_tpu_torch.cli import evaluate as cli_eval
    from crct_tpu_torch.cli import import_bert as cli_import
    from crct_tpu_torch.cli import train as cli_train
    from crct_tpu_torch.config import read_command_line
    from crct_tpu_torch.data.synthetic import generate_dataset
    from crct_tpu_torch.serve import make_server
    from crct_tpu_torch.train import eval_loop, train_loop
    from crct_tpu_torch.train.optimizer import language_weight_keys

    counts = {"k1": {}, "k2": {}}

    def kernel_counts():
        return {(k, d, n): (attention.LAUNCHES if k == "k1" else
                            attention.BWD_LAUNCHES)[(d, DEFAULT, *s)]
                for n, s in SHAPES.items() for d in ("float32", "bfloat16")
                for k in ("k1", "k2")}

    def counted(path, fn):
        before = kernel_counts()
        out = fn()
        torch.cuda.synchronize()
        for (k, d, n), c in kernel_counts().items():
            if c > before[(k, d, n)]:
                counts[k].setdefault(path, {})[(d, n)] = c - before[(k, d, n)]
        return out

    def quiet(fn):
        out = io.StringIO()
        with redirect_stdout(out):
            result = fn()
        return result, out.getvalue()

    with tempfile.TemporaryDirectory(prefix="crct_weights_") as root:
        argv = eval_data(root)
        base, direct = argv[:-2], argv[-1]
        # 1. a published-layout checkpoint of the same weights
        t0 = time.perf_counter()
        sd = torch.load(direct, map_location="cpu",
                        weights_only=False)["model_state_dict"]
        n_model = len(sd)
        for key in [k for k in sd if k.endswith("embeddings.LayerNorm.weight")
                    or k.endswith("embeddings.LayerNorm.bias")]:
            sd[key.replace(".weight", ".gamma").replace(".bias", ".beta")] = \
                sd.pop(key)
        g = torch.Generator().manual_seed(SEED)
        for key, shape in LEGACY_KEYS.items():
            sd["bert_pretrained." + key] = torch.randn(shape, generator=g)
        src, dst = (os.path.join(root, n) for n in ("crct.ckpt",
                                                     "converted.ckpt"))
        torch.save({"model_state_dict": sd}, src)
        del sd
        _, text = quiet(lambda: cli_convert.main([src, dst]))
        convert_s = time.perf_counter() - t0
        want = (f"converted {n_model} tensors; skipped {len(LEGACY_KEYS)} "
                f"legacy/unused keys")
        if want not in text:
            failures.append(f"convert_checkpoint printed {text!r}, want "
                            f"{want!r}")

        # 2. cli.evaluate on it, and on the weights loaded directly
        runs = {}
        for name, ckpt in (("converted", dst), ("direct", direct)):
            rec = EvalRecorder(eval_loop)
            preds = os.path.join(root, f"{name}.jsonl")

            def run():
                with rec:
                    return cli_eval.main(base + [
                        "-save_name", name, "-start_checkpoint", ckpt,
                        "-predictions_out", preds])
            t0 = time.perf_counter()
            (total, breakdown), text = quiet(
                lambda: counted(f"weights: eval {name}", run))
            with open(preds) as f:
                recs = [json.loads(ln) for ln in f]
            runs[name] = dict(total=total, breakdown=breakdown, rec=rec,
                              recs=recs, text=text,
                              seconds=time.perf_counter() - t0)
            if f"number of keys transferred: {n_model}\n" not in text:
                failures.append(f"weights: eval of the {name} checkpoint "
                                f"did not transfer {n_model} tensors")
        conv, dirc = runs["converted"], runs["direct"]
        rows_equal = all(np.array_equal(v, w) and np.array_equal(o, wo)
                         for (v, o), (w, wo) in zip(conv["rec"].rank,
                                                    dirc["rec"].rank))
        if not (rows_equal and len(conv["rec"].rank) == len(dirc["rec"].rank)
                and np.array_equal(conv["total"], dirc["total"])
                and np.array_equal(conv["breakdown"], dirc["breakdown"])):
            failures.append("weights: the converted checkpoint's eval "
                            "differs from the directly loaded weights'")
        k1 = sum(counts["k1"].get("weights: eval converted", {}).values())
        if not k1:
            failures.append("weights: no K1 launch in the converted eval")
        n_q = int(conv["total"][0, 1])
        say("weights", f"cli.convert_checkpoint of a reference-layout "
                       f"crct.ckpt (the flagship model's random weights, "
                       f"seed {SEED}; {len(LEGACY_KEYS)} legacy keys, "
                       f"gamma/beta names): '{want}' in {convert_s:.1f} s "
                       f"(writing the source included); cli.evaluate on "
                       f"{n_q} questions: tables and per-row NSP "
                       f"probabilities of {sum(len(v) for v, _ in conv['rec'].rank)} "
                       f"rows {'bit-equal' if rows_equal else 'NOT equal'} "
                       f"to the directly loaded weights' ({conv['seconds']:.1f}"
                       f" s and {dirc['seconds']:.1f} s, loading included); "
                       f"{k1} K1 launches ({card})")

        # 3. serving the converted weights through K1
        params = read_command_line(base + ["-save_name", "serve",
                                           "-start_checkpoint", dst])
        params["port"] = 0
        server, text = quiet(lambda: make_server(params, port=0,
                                                 device="cuda"))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}/v1/answer"
        asked, seen = [], {}
        for gid, qa in enumerate(
                server.scorer.dataset.qa["test"][:N_SERVE_WEIGHTS]):
            img = int(qa["image_index"])
            asked.append((gid, img, seen.get(img, 0)))
            seen[img] = seen.get(img, 0) + 1
        try:
            replies = counted("weights: serve", lambda: [post(
                url, {"image_index": img, "question_id": qi})
                for _, img, qi in asked])
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        probs = conv["rec"].full_probs()
        same = ties = 0
        for (gid, _, _), (status, rec, _) in zip(asked, replies):
            check_rec(rec, failures, "weights: /v1/answer")
            if status != 200:
                failures.append(f"weights: /v1/answer status {status}")
            elif rec["cls_output"] == conv["recs"][gid]["cls_output"]:
                same += 1
            elif top_gap(probs[gid]) <= 1e-4:
                ties += 1
            else:
                failures.append(f"weights: served {rec['cls_output']!r}, "
                                f"evaluate chose "
                                f"{conv['recs'][gid]['cls_output']!r}")
        k1 = sum(counts["k1"].get("weights: serve", {}).values())
        if not k1:
            failures.append("weights: no K1 launch while serving")
        say("weights", f"make_server on the converted checkpoint: "
                       f"{len(asked)} /v1/answer requests, answers equal to "
                       f"evaluate()'s for {same}, {ties} at a near-tie; "
                       f"{k1} K1 launches; median "
                       f"{np.median([r[2] for r in replies]):.1f} ms a "
                       f"request ({card})")

        # 4. BERT-base through cli.import_bert into cli.train
        t0 = time.perf_counter()
        bert = bert_state_dict(SEED)
        torch.save(bert, os.path.join(root, "pytorch_model.bin"))
        out = os.path.join(root, "bert.ckpt")
        _, text = quiet(lambda: cli_import.main(
            [os.path.join(root, "pytorch_model.bin"), out]))
        import_s = time.perf_counter() - t0
        imported = torch.load(out, map_location="cpu",
                              weights_only=False)["model_state_dict"]
        imported = {k[len("bert_pretrained."):]: v
                    for k, v in imported.items()}
        n_text = len(language_weight_keys())
        want = f"imported {n_text} BERT tensors; skipped 5 "
        if want not in text or set(imported) != language_weight_keys():
            failures.append(f"import_bert printed {text!r}; want {want!r} "
                            f"and the {n_text} text-stream keys")
        data = generate_dataset(os.path.join(root, "train"),
                                n_images=WEIGHT_TRAIN_IMAGES, division=8,
                                n_questions=4, feat_dim=1024,
                                splits=("train",), seed=SEED)
        ds_json = os.path.join(root, "train.json")
        with open(ds_json, "w") as f:
            json.dump(dict(data, main_folder="",
                           splits=["train", "train", "train"],
                           save_path=os.path.join(root, "results"),
                           max_seq_len=124, max_vis_features=44,
                           categories=228), f)
        at_step0 = {}
        real_load = train_loop.Trainer._maybe_load_checkpoint

        def load_and_keep(self):
            real_load(self)
            at_step0.update({k: v.detach().cpu().clone() for k, v in
                             self.model.state_dict().items()
                             if k in imported})
        t0 = time.perf_counter()
        with mock.patch.object(train_loop.Trainer, "_maybe_load_checkpoint",
                               load_and_keep):
            trainer, text = quiet(lambda: counted(
                "weights: bert train", lambda: cli_train.main([
                    "-qa_file", "qa_pairs.npy", "-dataset_config", ds_json,
                    "-model_config", os.path.join(HERE, "config",
                                                  "vilbert.json"),
                    "-batch_size", str(B_TRAIN), "-bf16", "-num_epochs", "1",
                    "-num_workers", "1", "-no_eval", "-seed", str(SEED),
                    "-save_name", "bert", "-start_checkpoint", out])))
        train_s = time.perf_counter() - t0
        intact = (set(at_step0) == set(imported) and all(
            torch.equal(at_step0[k], v.float()) for k, v in imported.items()))
        steps = WEIGHT_TRAIN_IMAGES * 4 * 2 // B_TRAIN
        kk = {k: sum(counts[k].get("weights: bert train", {}).values())
              for k in ("k1", "k2")}
        moved = sum(not torch.equal(trainer.model.state_dict()[k].cpu(),
                                    at_step0[k]) for k in at_step0)
        if not intact:
            failures.append("weights: the text stream at step 0 is not the "
                            "imported BERT's")
        if f"number of keys transferred: {n_text}\n" not in text:
            failures.append(f"weights: cli.train did not transfer the "
                            f"{n_text} text-stream tensors")
        if trainer.step != steps or not kk["k1"] or not kk["k2"] or \
                moved == 0:
            failures.append(f"weights: BERT-initialized training took "
                            f"{trainer.step} steps (want {steps}), K1/K2 "
                            f"launches {kk}, {moved} tensors moved")
        say("weights", f"cli.import_bert of a seeded BERT-base "
                       f"({BERT_BASE['layers']} layers, hidden "
                       f"{BERT_BASE['hidden']}, intermediate "
                       f"{BERT_BASE['intermediate']}): '{want.strip()}' in "
                       f"{import_s:.1f} s; cli.train -start_checkpoint, "
                       f"bf16, batch {B_TRAIN}: {n_text} tensors transferred,"
                       f" the text stream at step 0 "
                       f"{'bit-equal to' if intact else 'NOT'} the imported "
                       f"weights, {trainer.step} steps in {train_s:.1f} s "
                       f"(model build and checkpoint included), {kk['k1']} "
                       f"K1 and {kk['k2']} K2 bf16 launches, {moved} of "
                       f"them moved by the steps ({card})")
        del trainer
        torch.cuda.empty_cache()
    say("weights", "the Orbax path (JAX package checkpoints) is not run on "
                   "the card: its machine has no tensorstore. "
                   "tests/test_torch_checkpoint.py holds it against the JAX "
                   "package on the CPU; cli.convert_checkpoint moves such a "
                   "checkpoint to a torch file on a host with tensorstore.")
    return counts


def record_shapes(attention, rk):
    """Patches of the three kernels' launch functions that record what a
    path gives them: (dtype, mode, B, H, Lq, Lk, D) of each K1 and K2
    launch (the mode their last argument), and the inputs of K3's first
    call at each (cotangent dtype, P, C, pyramid, map dtype, sampling
    ratio), copied. They call through, so each launch is counted as
    before."""
    seen = {"k1": set(), "k2": set(), "k3": {}}
    launch, launch_bwd = attention._launch, attention._launch_bwd
    k3 = rk.mlra_backward_kernel

    def k1(q, k, *args):
        seen["k1"].add((str(q.dtype)[6:], args[-1], *q.shape[:3],
                        k.shape[2], q.shape[3]))
        return launch(q, k, *args)

    def k2(q, k, *args):
        seen["k2"].add((str(q.dtype)[6:], args[-1], *q.shape[:3],
                        k.shape[2], q.shape[3]))
        return launch_bwd(q, k, *args)

    def roi(g, geo, shapes, dtype, S):
        key = (str(g.dtype)[6:], g.shape[1], g.shape[3],
               tuple(map(tuple, shapes)), str(dtype)[6:], S)
        if key not in seen["k3"]:
            seen["k3"][key] = (g.detach().clone(),
                               {n: t.clone() for n, t in geo.items()})
        return k3(g, geo, shapes, dtype, S)

    patches = (mock.patch.object(attention, "_launch", k1),
               mock.patch.object(attention, "_launch_bwd", k2),
               mock.patch.object(rk, "mlra_backward_kernel", roi))
    return seen, patches


def check_shapes(attention, rk, seen, phase, card, failures,
                 need=("k1", "k2", "k3")):
    """K1 and K2 against their plain versions at each (dtype, mode, B, H,
    Lq, Lk, D) ``phase``'s path launched them at (``seen``, from
    record_shapes), on random inputs as the kernel phase draws them (both
    masks, dropout 0 and 0.1) and with its limits; K3 against its plain
    version on the geometry of the path's first call at each of its
    shapes, with that call's cotangent and with a unit-normal one, with the
    kernel phase's limits. A kernel of ``need`` with no shape to check
    fails too."""
    import torch
    for kname, seen_k, errors in (("K1", seen["k1"], k1_errors),
                                  ("K2", seen["k2"], k2_errors)):
        for dname, mode, rows, H, Lq, Lk, D in sorted(seen_k):
            g = torch.Generator(device="cuda").manual_seed(SEED)
            name = f"{phase} {kname} (B, H, Lq, Lk, D) = {(rows, H, Lq, Lk, D)}"
            err = errors(attention, name, rows, (H, Lq, Lk, D),
                         getattr(torch, dname), g, failures, mode)
            err = err[0] if kname == "K1" else err
            if kname == "K1" and hasattr(attention, "fwd_design"):
                design = attention.fwd_design(getattr(torch, dname), mode,
                                              Lk, D)
                name += f" ({design} design)"
            say(phase, f"{name} {dname} {mode}: max abs err {err:.3g} "
                       f"against the plain version (tol {K_TOL[dname]}"
                       f"{'' if kname == 'K1' else ' of max(1, |grad|)'}; "
                       f"both masks, dropout 0 and 0.1; {card})")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for (gname, P, C, shapes, dname, S), (g_path, geo) in sorted(
            seen["k3"].items(), key=lambda kv: kv[0][:2]):
        dtype = getattr(torch, dname)
        what = (f"{phase} K3 N {g_path.shape[0]}, P {P}, C {C}, pyramid "
                f"{shapes}, {gname} into {dname}")
        # the path's cotangent is small (a loss over many rois), which makes
        # max(1, |grad|) loose: a unit-normal one on the same geometry too
        unit = torch.randn(g_path.shape, device="cuda", generator=gen,
                           dtype=torch.float32).to(g_path.dtype)
        for cot, g in (("the path's cotangent", g_path),
                       ("a unit-normal cotangent", unit)):
            got = rk.mlra_backward_kernel(g, geo, shapes, dtype, S)
            want = rk.mlra_backward_reference(g, geo, shapes, dtype, S)
            torch.cuda.synchronize()
            err, limit, ok = roi_error(got, want, dtype)
            top = max(w.abs().max().item() for w in want)
            if not ok:
                failures.append(f"{what}, {cot}: max abs err {err} "
                                f"({limit})")
            say(phase, f"{what}, the path's geometry and {cot}: max abs "
                         f"err {err:.3g} against the plain version, largest "
                         f"|grad| {top:.3g} ({limit}; {card})")
    for kname in need:
        if not seen[kname]:
            failures.append(f"{phase}: no {kname.upper()} shape to check")


def proof_phase(card, failures):
    """Phase 12: crct_tpu_torch.tools.full_pipeline_proof --fast on the
    card. Fails where a stage fails, K1, K2 or K3 never launched, or a
    kernel disagrees with its plain version at a shape the proof gave it;
    the accuracy is printed beside chance, not gated (--fast proves the
    plumbing). Returns the proof's JSON line and the kernels' launches in
    it by key."""
    import io
    from contextlib import ExitStack, redirect_stdout

    import torch

    from crct_tpu_torch.ops import attention, roi_align_kernel
    from crct_tpu_torch.tools import full_pipeline_proof

    before = (dict(attention.LAUNCHES), dict(attention.BWD_LAUNCHES),
              dict(roi_align_kernel.LAUNCHES))
    seen, patches = record_shapes(attention, roi_align_kernel)
    with tempfile.TemporaryDirectory(prefix="crct_proof_") as root:
        out = io.StringIO()
        t0 = time.perf_counter()
        try:
            with ExitStack() as stack, redirect_stdout(out):
                for patch in patches:
                    stack.enter_context(patch)
                res = full_pipeline_proof.main(["--fast", "--root", root])
        except Exception as exc:                    # a stage failed
            failures.append(f"proof: {exc!r}; last lines "
                            f"{out.getvalue().splitlines()[-5:]}")
            return None, {"k1": {}, "k2": {}, "k3": {}}
        seconds = time.perf_counter() - t0
    torch.cuda.empty_cache()
    # launches by kernel and key ((dtype, mode, H, Lq, Lk, D); K3 (dtype,
    # P, C))
    launches = {name: {k: c - b.get(k, 0) for k, c in now.items()
                       if c > b.get(k, 0)}
                for name, now, b in zip(
                    ("k1", "k2", "k3"), (attention.LAUNCHES,
                                         attention.BWD_LAUNCHES,
                                         roi_align_kernel.LAUNCHES), before)}
    st = res["stages"]
    for name, stage in st.items():
        say("proof", f"{name}: {stage['seconds']:.1f} s, K1 {stage['k1']}, "
                     f"K2 {stage['k2']}, K3 {stage['k3']} launches ({card})")
    need = {"K3 in detector_train": st["detector_train"]["k3"],
            "K1 in train": st["train"]["k1"],
            "K2 in train": st["train"]["k2"],
            "K1 in evaluate": st["evaluate"]["k1"]}
    for what, n in need.items():
        if not n:
            failures.append(f"proof: no {what}")
    say("proof", f"full_pipeline_proof --fast ({res['charts_train']} + "
                 f"{res['charts_test']} charts, {res['det_iters']} detector "
                 f"iterations, {res['qa_epochs']} QA epoch) in {seconds:.1f} "
                 f"s: held-out accuracy {res['e2e_learned_heldout_accuracy']}"
                 f" (cls only {res['cls_only_accuracy']}, tolerance "
                 f"{res['tolerance_accuracy']}) beside chance {res['chance']}"
                 f" on {res['questions']} questions; not gated at --fast "
                 f"sizes ({card})")
    check_shapes(attention, roi_align_kernel, seen, "proof", card, failures)
    return res, launches


def numbers(obj, path=""):
    """(path, value) of every number in a parsed JSON line, the launch
    counts (checked by kernel) apart."""
    if isinstance(obj, bool):
        return
    if isinstance(obj, (int, float)):
        yield path, obj
    elif isinstance(obj, dict):
        for k, v in obj.items():
            if "launches" not in k:
                yield from numbers(v, f"{path}.{k}" if path else k)
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from numbers(v, f"{path}[{i}]")


def check_numbers(what, line, failures, may_be_zero=()):
    """Every number of the line finite and above 0 (but under the paths
    that start with one of ``may_be_zero``: finite), every MFU at most
    100 %."""
    for path, v in numbers(line):
        if not math.isfinite(v):
            failures.append(f"{what}: {path} = {v}")
        elif v <= 0 and not path.startswith(tuple(may_be_zero)):
            failures.append(f"{what}: {path} = {v}, not above 0")
        elif "mfu" in path and v > 100:
            failures.append(f"{what}: {path} = {v} % above the peak")


def save_line(name, line):
    """A JSON line too long for the end of the output, in chiprun_out/."""
    out = os.path.join(HERE, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"chip_smoke_{name}.json"), "w") as f:
        json.dump(line, f, indent=1)


def bench_phase(card, failures, argv=BENCH_ARGV, nproc=1):
    """Phase 13: the bench's main with ``argv`` in a child process
    (``child_bench``; under torchrun over ``nproc`` cards when above 1),
    which also holds the kernels against their plain versions at every
    shape the bench gave them. Fails where a child exits non-zero or
    reports a failure, where the bench prints no line, a key of bench.py's
    run with those flags is missing, a number is not finite and above 0,
    an MFU passes 100 %, a section did not launch a kernel it runs, or the
    line names another card or world. Returns the line's launches by
    section."""
    import torch
    with tempfile.TemporaryDirectory(prefix="crct_bench_") as root:
        report = os.path.join(root, "rank{rank}.json")
        cmd = [os.path.join(HERE, "chip_smoke.py"), "--child", "bench",
               HERE, report, "--", *argv]
        if nproc > 1:
            cmd = ["-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node", str(nproc), *cmd]
        t0 = time.perf_counter()
        rc, out = spawn([sys.executable, *cmd], timeout=900)
        seconds = time.perf_counter() - t0
        reports = []
        for rank in range(nproc):
            try:
                with open(report.format(rank=rank)) as f:
                    reports.append(json.load(f))
            except OSError:
                reports.append({"failures": [f"rank {rank} wrote no report"]})
    for ln in out.splitlines():          # the children's shape checks
        if ln.startswith("[bench] "):
            print(ln, flush=True)
    for rank, rep in enumerate(reports):
        failures += [f"bench rank {rank}: {f}" for f in rep["failures"]]
    lines = [ln for ln in out.splitlines() if ln.startswith('{"metric"')]
    if rc != 0 or len(lines) != 1:
        failures.append(f"bench {' '.join(argv)}: exit {rc}, {len(lines)} "
                        f"result lines; last lines {out.splitlines()[-8:]}")
        return {}
    line = json.loads(lines[0])
    aux = line["aux"]
    skip = set()
    if "--no-e2e" in argv:
        skip.add("e2e")
    if "--no-detector" in argv:
        skip.add("detector_800px")
    if "--all" not in argv:
        skip.update(("detector", "detector_800px_bf16",
                     "detector_800px_fastnms"))
    if "--roofline" not in argv:
        skip.add("roofline")
    sections = [s for s in BENCH_KEYS if s not in skip]
    missing = [k for k in ("metric", "value", "unit", "vs_baseline")
               if k not in line]
    missing += [k for s in sections for k in BENCH_KEYS[s] if k not in aux]
    missing += [f"launches.{s}" for s in sections
                if s not in aux.get("launches", {})]
    if missing:
        failures.append(f"bench: missing keys {missing}")
        return {}
    what = "bench" + (f" over {nproc} cards" if nproc > 1 else "")
    check_numbers(what, line, failures)
    for s in sections:
        for k in BENCH_KERNELS[s]:
            if aux["launches"][s][k] < 1:
                failures.append(f"{what}: no {k.upper()} launch in {s}")
    named = f"{aux['device_name']}, {aux.get('power_limit_w', 0):.2f} W"
    if named != card or aux["n_chips"] != nproc:
        failures.append(f"{what}: names {named} x {aux['n_chips']}, not "
                        f"{card} x {nproc}")
    if aux["attention_path"] != f"cuda_k1_k2_{DEFAULT}":
        failures.append(f"{what}: attention_path {aux['attention_path']}")
    save_line("bench" + (f"_{nproc}cards" if nproc > 1 else ""), line)
    head = {k: aux[k] for s in sections for k in BENCH_KEYS[s][:2]
            if not isinstance(aux[k], str)}
    say("bench", f"crct_tpu_torch.bench {' '.join(argv)} in {seconds:.1f} s: "
                 f"{line['value']:.2f} QA pairs/s/card (vs_baseline "
                 f"{line['vs_baseline']:.3f}); "
                 + ", ".join(f"{k} {v:.4g}" for k, v in head.items())
                 + "; launches " + ", ".join(
                     f"{s} " + "/".join(str(aux["launches"][s][k])
                                        for k in ("k1", "k2", "k3"))
                     for s in sections)
                 + f"; nvcc {aux.get('nvcc_build_s', 0):.1f} s ({card})")
    torch.cuda.empty_cache()
    return {s: aux["launches"][s]["shapes"] for s in sections}


# the tools phase: (tool, argv at small sizes, paths whose numbers may be 0
# or below: rates of a random model's answers, knockout deltas, differences)
TOOL_RUNS = (
    ("serve_bench", ("--requests", "32", "--threads", "8", "--sequential",
                     "4"), ("fast_topk",)),
    ("eval_overhead_profile", ("--questions", "64", "--passes", "1"), ()),
    ("eval_chunk_sweep", ("--questions", "64", "--chunks", "240,960",
                          "--repeats", "1"), ()),
    ("attention_shape_bench", ("--steps", "1", "--repeats", "2"), ()),
    ("detector_step_decomp", ("--steps", "2", "--repeats", "1", "--warmup",
                              "1"), ("deltas_ms",)),
    ("roi_backward_compare", ("--iters", "5"), ("max_abs_diff",)),
    ("opt_variant_bench", ("--opt-bf16-m", "--steps", "3", "--repeats", "2"),
     ()),
    ("opt_variant_bench", ("--dropout0", "--steps", "3", "--repeats", "2"),
     ()),
    ("shortlist_miss_rate", ("--backbone-steps", "50", "--head-steps",
                             "20"), ("k", "full_protocol_accuracy")),
)


def check_tool(name, res, launched, failures):
    """What each tool's line must show beyond finite, positive numbers."""
    k = launched.record
    need = {"serve_bench": ("k1",), "eval_overhead_profile": ("k1",),
            "eval_chunk_sweep": ("k1",), "attention_shape_bench": ("k1",
                                                                    "k2"),
            "detector_step_decomp": ("k3",), "roi_backward_compare": ("k3",),
            "opt_variant_bench": ("k1", "k2"),
            "shortlist_miss_rate": ("k1", "k2")}[name]
    bad = [kk for kk in need if k[kk] < 1]
    if name == "serve_bench":
        if res["errors"] or res["requests"] != 32:
            bad.append(f"{res['requests']} answered, errors {res['errors']}")
        if res["mean_coalesced_batch"] <= 1:
            bad.append(f"no coalescing ({res['mean_coalesced_batch']})")
    elif name == "eval_chunk_sweep":
        bad += [f"chunk {r['chunk']}: no K1" for r in res["table"]
                if r["k1_launches"] < 1]
    elif name == "attention_shape_bench":
        for shape, r in res["shapes"].items():
            for path in ("kernels", "pallas"):
                if r[f"{path}_launches"]["k1"] < 1:
                    bad.append(f"{shape}: no K1 on the {path} path")
                if shape.startswith("train") \
                        and r[f"{path}_launches"]["k2"] < 1:
                    bad.append(f"{shape}: no K2 on the {path} path")
            for path in ("plain", "sdpa"):
                if any(r[f"{path}_launches"].values()):
                    bad.append(f"{shape}: kernels on the {path} path")
    elif name == "detector_step_decomp":
        if res["k3_launches"]["stub_roialign"]:
            bad.append("K3 launched with RoIAlign stubbed")
    elif name == "roi_backward_compare":
        tol = 2e-5 * max(1.0, res["max_abs_grad"])
        if res["max_abs_diff"]["k3_vs_scatter"] > tol:
            bad.append(f"K3 {res['max_abs_diff']['k3_vs_scatter']:.3g} from "
                       f"the scatter-add gradient (limit {tol:.3g})")
    if bad:
        failures.append(f"tools {name}: {bad}")


def tools_phase(card, failures):
    """Phase 14: the eight tools of crct_tpu_torch/tools/ (the full
    pipeline proof is phase 12) at small sizes, each in this process
    through its main(); its printed line checked as the bench's, and by
    what it measures. The detector knockouts must leave mask_rcnn's and
    box_ops' namespaces as they found them. Then K1, K2 and K3 against
    their plain versions at every shape the tools gave them. Returns each
    run's launches by kernel, dtype and shape."""
    from contextlib import ExitStack

    import torch

    from crct_tpu_torch.detector import boxes, mask_rcnn
    from crct_tpu_torch.ops import attention, roi_align_kernel
    names = (dict(vars(mask_rcnn)), dict(vars(boxes)))
    shapes = {}
    seen, patches = record_shapes(attention, roi_align_kernel)
    with ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        tool_runs(card, failures, shapes)
    if (dict(vars(mask_rcnn)), dict(vars(boxes))) != names:
        failures.append("tools: detector_step_decomp left a stub in "
                        "mask_rcnn's or box_ops' namespace")
    check_shapes(attention, roi_align_kernel, seen, "tools", card, failures)
    torch.cuda.empty_cache()
    return shapes


def tool_runs(card, failures, shapes):
    """Each of TOOL_RUNS through its main(), its line checked; its launches
    by kernel, dtype and shape into ``shapes``."""
    import importlib
    import io
    from contextlib import redirect_stdout

    import torch

    from crct_tpu_torch.bench import Launches
    for name, argv, may_be_zero in TOOL_RUNS:
        tool = importlib.import_module(f"crct_tpu_torch.tools.{name}")
        label = " ".join((name,) + argv[:1]) if name == "opt_variant_bench" \
            else name
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with Launches() as launched, redirect_stdout(buf):
                tool.main(list(argv))
            line = json.loads(buf.getvalue().strip().splitlines()[-1])
        except Exception as exc:        # the tool failed: its last lines
            failures.append(f"tools {label}: {exc!r}; last lines "
                            f"{buf.getvalue().splitlines()[-5:]}")
            continue
        finally:
            torch.cuda.empty_cache()
        seconds = time.perf_counter() - t0
        check_numbers(f"tools {label}", line, failures, may_be_zero)
        check_tool(name, line, launched, failures)
        save_line(f"tool_{label.replace(' --', '_').replace('-', '_')}",
                  line)
        shapes[label] = launched.record["shapes"]
        say("tools", f"{name} {' '.join(argv)} in {seconds:.1f} s: K1/K2/K3 "
                     f"{launched.record['k1']}/{launched.record['k2']}/"
                     f"{launched.record['k3']}; "
                     + json.dumps({k: v for k, v in line.items()
                                   if not isinstance(v, (dict, list))})[:600]
                     + f" ({card})")


def kernel_phase(card, attention, build, roi_align, rk, failures):
    """Phase 3: every kernel against its plain version, timed; the rows of
    the kernels' JSON line by (kernel, shape, dtype)."""
    import torch
    wg_occ = (wgmma_occupancy(build, attention, failures)
              if hasattr(attention, "fwd_design") else {})
    fwd_rows = {}
    for kname, shape in SHAPES.items():
        for row, flops, nbytes, lse_err, rnd, sh in check_kernel(
                attention, kname, shape, failures):
            fwd_rows[(kname, row["dtype"], row["mode"])] = row
            if row.get("design", "").startswith("wgmma") \
                    and ("fwd", kname, row["mode"]) in wg_occ:
                row["smem_bytes"], row["warps"], row["blocks_per_sm"] = \
                    wg_occ[("fwd", kname, row["mode"])]
            say("kernel", f"K1 {kname} {row['dtype']} {row['mode']} "
                          f"({design_note(row)}) "
                          f"(B, H, Lq, Lk, D) = "
                          f"{(B, *shape)}: max abs err "
                          f"{row['max_abs_err']:.3g} (tol "
                          f"{K_TOL[row['dtype']]}), "
                          f"lse within {lse_err:.3g} of max(1, |lse|) (tol "
                          f"1e-5); device times: kernel {row['ms']:.4f} ms, plain "
                          f"{row['plain_ms']:.4f} ms, sdpa "
                          f"{row['library_ms']:.4f} ms, bound "
                          f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
                          f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)"
                          + rounding_note(rnd) + share_note("K1", sh)
                          + f" ({card})")

    # K2's mma.sync layout: shared memory, warps (key slabs) and resident
    # blocks per SM, and the waves of a B_TRAIN * H launch, in fp32 / bf16
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
        # beside it, the design that fp32 launches of the shape take
        # where it is another (the TF32 TMA design at vision's D 64)
        other = ""
        if wg_occ.get(("bwd design", kname, "both")) == "wgmma tf32 tma":
            smem, warps, n = wg_occ[("bwd", kname, "both")]
            other = (f" (fp32 on wgmma tf32 tma: {smem / 1024:.1f} KB, "
                     f"{warps} warps, {n} blocks, "
                     f"{B_TRAIN * H / (n * sms):.2f} waves)")
        occ.append(f"{kname} "
                   f"{lib.attention_bwd_smem(Lq, Lk, D, 0) / 1024:.1f}/"
                   f"{lib.attention_bwd_smem(Lq, Lk, D, 1) / 1024:.1f} KB, "
                   f"{lib.attention_bwd_key_tile(Lq, Lk, D, 0) // 16}/"
                   f"{lib.attention_bwd_key_tile(Lq, Lk, D, 1) // 16} warps, "
                   f"{per_sm[0]}/{per_sm[1]} blocks, "
                   + "/".join(f"{B_TRAIN * H / (n * sms):.2f}"
                              for n in per_sm) + " waves" + other)
    say("build", f"attention_bwd mma.sync per block (fp32/bf16, the "
                 f"{PALLAS} instances) on {sms} SMs at B = {B_TRAIN}: "
                 + "; ".join(occ))
    bwd_rows = {}
    for kname, shape in SHAPES.items():
        rows, ident = check_bwd_kernel(attention, kname, shape, failures)
        for row, flops, nbytes, rnd, sh in rows:
            bwd_rows[(kname, row["dtype"], row["mode"])] = row
            if ("bwd", kname, row["mode"]) in wg_occ \
                    and row.get("design", "").startswith("wgmma"):
                row["smem_bytes"], row["warps"], row["blocks_per_sm"] = \
                    wg_occ[("bwd", kname, row["mode"])]
            say("kernel", f"K2 {kname} {row['dtype']} {row['mode']} "
                          f"({design_note(row)}) "
                          f"(B, H, Lq, Lk, D) = "
                          f"{(B_TRAIN, *shape)}: max abs err "
                          f"{row['max_abs_err']:.3g} (tol "
                          f"{K_TOL[row['dtype']]} of "
                          f"max(1, |grad|)); <out,C> = <v,dv> under dropout "
                          f"to {ident:.2g} relative; "
                          + {True: "two launches bit-equal; ",
                             False: "two launches DIFFER; ",
                             None: ""}[row.get("bit_equal")]
                          + f"kernel {row['ms']:.4f} "
                          f"ms, plain {row['plain_ms']:.4f} ms, sdpa backward"
                          f" {row['library_ms']:.4f} ms (device times),"
                          f" bound {row['bound_ms']:.4f} ms "
                          f"({row['bound_by']}: {flops / 1e9:.2f} GFLOP, "
                          f"{nbytes / 1e6:.1f} MB)" + rounding_note(rnd)
                          + share_note("K2", sh) + f" ({card})")

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
                    help=f"comma-separated, of {', '.join(PHASES)}, times "
                         f"and cards; "
                         f"the result line is printed only when all run")
    ap.add_argument("--seeds", type=int, default=1,
                    help="generator seeds of each cross-check step")
    args = ap.parse_args()
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES) - {"times", "cards"}
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
    began = ["the build", t0]       # the phase under way and its start

    def mark(phase):
        now = time.perf_counter()
        say("time", f"{began[0]} took {now - began[1]:.1f} s")
        say("time", f"{phase} starts {now - t0:.1f} s after the build "
                    f"started")
        began[:] = [phase, now]

    with ThreadPoolExecutor(len(KERNELS)) as pool:   # one nvcc per source
        list(pool.map(build.build, KERNELS))
    for kname in KERNELS:
        build.load(kname)
        seconds, log = build.BUILD_LOG.get(kname, (0.0, "cached"))
        use = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
               if ("registers" in ln or "smem" in ln) and "(C75" not in ln]
        say("build", f"{kname} for sm_90a in {seconds:.1f} s (nvcc); "
                     f"{use}")
    say("build", f"{len(KERNELS)} kernels built and loaded in "
                 f"{time.perf_counter() - t0:.1f} s")
    wgmma_build_report(build, attention, failures)

    if "times" in phases:
        mark("times")
        ms = kernel_times(attention)
        for key, t in ms.items():
            say("times", f"{key}: K1 {t['fwd']:.4f} ms ({t['fwd_design']} "
                         f"design), K2 {t['bwd']:.4f} ms ({t['bwd_design']} "
                         f"design); K1 at "
                         f"{SMALL_ROWS} rows {t['fwd_small']:.4f} ms, "
                         f"{t['fwd_small_wall_us']:.1f} us a call with the "
                         f"host ({card})")
        k3 = roi_times(roi_align, rk)
        for key, t in k3.items():
            say("times", f"K3 {key}: {t:.4f} ms, everything the wrapper "
                         f"launches ({card})")
        print(json.dumps({"phase": "times", "tree": tree, "card": card,
                          "ms": ms, "k3_ms": k3}), flush=True)
    if "kernel" in phases:
        mark("kernel")
        fwd_rows, bwd_rows, roi_rows = kernel_phase(card, attention, build,
                                                    roi_align, rk, failures)
    if "serve" in phases:
        mark("serve")
        launches = serve(card, attention, failures)
    if "eval" in phases:
        mark("eval")
        eval_counts = eval_phase(card, attention, failures)
    batch = None
    if "train" in phases:
        mark("train")
        train_counts, in_train_k1, batch, params = train(card, attention,
                                                         failures)
    if "cross" in phases:
        mark("cross")
        if batch is None:
            batch, params = train_batch()
        readings, cross_launches = cross_check(
            attention, batch, params, failures,
            [SEED + i for i in range(args.seeds)])
        if not whole:
            print(json.dumps({"phase": "cross", "tree": tree, "card": card,
                              "readings": readings}), flush=True)
    if "detector" in phases:
        mark("detector")
        roi_counts = detector(card, attention, roi_align, rk, failures)
    if "ingest" in phases:
        mark("ingest")
        ingest_launches = ingest_phase(card, attention, failures)
    if "parallel" in phases or "cards" in phases:
        if batch is None:
            batch, params = train_batch()
    if "parallel" in phases:
        mark("parallel")
        par = parallel_phase(card, attention, batch, params, failures)
    if "cards" in phases:
        mark("cards")
        cards_phase(card, batch, params, failures)
    if "weights" in phases:
        mark("weights")
        weights = weights_phase(card, attention, failures)
    if "proof" in phases:
        mark("proof")
        proof, proof_launches = proof_phase(card, failures)
        if not whole and proof is not None:
            print(json.dumps({"phase": "proof", "card": card, **proof}),
                  flush=True)
    if "bench" in phases:
        mark("bench")
        bench_shapes = bench_phase(card, failures)
    if "tools" in phases:
        mark("tools")
        tool_shapes = tools_phase(card, failures)
    mark("the end")
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    if not whole:
        return 0
    # launches in the main paths, all in the default attention mode: fp32
    # K1 rows count serving's, the eval phase's fp32 paths and the ingest
    # phase's answers, bf16 rows the (bf16) training run's, its in-train
    # eval's and eval -bf16's; the parallel phase's: K1 in bf16 in the remat
    # steps and the -ddp run, in fp32 in the gloo ranks' QA step and eval;
    # K2 likewise. The cross-check's steps launch both kernels in fp32 and
    # in bf16 in each mode: the -pallas mode's path. An fp32 row (one kernel
    # instance, "both" modes) counts the launches of either mode.
    par_k1 = {p: c for p, c in par.items()
              if not p.endswith("K2") and p != "gloo detector"}
    par_k2 = {p[:-3]: c for p, c in par.items() if p.endswith("K2")}

    def of_row(key, kname, dname, mode, at=2):
        """Whether a launch key (dtype, mode, H, Lq, Lk, D) counts for the
        row of (kname, dname, mode); ``at`` where its H stands."""
        return (key[0] == dname and mode in ("both", key[1])
                and tuple(key[at:at + 4]) == SHAPES[kname])

    def cross(k, kname, dname, mode):
        n = sum(c for key, c in cross_launches[k].items()
                if of_row(key, kname, dname, mode))
        return {"cross": n} if n else {}

    def proof(k, kname, dname, mode):
        # the proof's tiny model: the same kind, Lq and Lk
        return sum(c for key, c in proof_launches[k].items()
                   if key[0] == dname and mode in ("both", key[1])
                   and key[3:5] == SHAPES[kname][1:3])

    for (kname, dname, mode), row in fwd_rows.items():
        paths = {}
        if mode != PALLAS:
            paths = {p: c[(dname, kname)] for p, c in eval_counts.items()
                     if c.get((dname, kname))}
            if dname == "float32":
                paths = {"serve": launches[kname], **paths,
                         "ingest": ingest_launches[kname]}
            else:
                paths = {"train": train_counts[kname][0],
                         "in-train eval": in_train_k1[kname], **paths}
            paths.update({p: c[(kname, dname)] for p, c in par_k1.items()
                          if c.get((kname, dname))})
            paths.update({p: c[(dname, kname)]
                          for p, c in weights["k1"].items()
                          if c.get((dname, kname))})
        paths.update(cross("k1", kname, dname, mode))
        row["path"] = ", ".join(paths)
        row["launches"] = sum(paths.values())
        row["proof_launches"] = proof("k1", kname, dname, mode)
    for (kname, dname, mode), row in bwd_rows.items():
        paths = {}
        if mode != PALLAS:
            paths = {} if dname == "float32" else {
                "train": train_counts[kname][1]}
            paths.update({p: c[(kname, dname)] for p, c in par_k2.items()
                          if c.get((kname, dname))})
            paths.update({p: c[(dname, kname)]
                          for p, c in weights["k2"].items()
                          if c.get((dname, kname))})
        paths.update(cross("k2", kname, dname, mode))
        row["path"] = ", ".join(paths) or "none"
        row["launches"] = sum(paths.values())
        row["proof_launches"] = proof("k2", kname, dname, mode)
    # the bench's sections and the tools' runs, by kernel, dtype, mode and
    # shape (Launches' keys)
    extra = {f"bench {s}": c for s, c in bench_shapes.items()}
    extra.update({f"tools {t}": c for t, c in tool_shapes.items()})

    def add_paths(row, keys):
        more = {p: sum(c.get(key, 0) for key in keys)
                for p, c in extra.items()}
        more = {p: n for p, n in more.items() if n}
        row["path"] = ", ".join([row["path"]] * (row["path"] != "none")
                                + list(more)) or "none"
        row["launches"] += sum(more.values())

    for tag, rows in (("K1", fwd_rows), ("K2", bwd_rows)):
        for (kname, dname, mode), row in rows.items():
            add_paths(row, [f"{tag} {dname} {m} "
                            + "x".join(map(str, SHAPES[kname]))
                            for m in ((DEFAULT, PALLAS) if mode == "both"
                                      else (mode,))])
    kernels = list(fwd_rows.values()) + list(bwd_rows.values())
    # the detector phase trains in fp32 (and so do the gloo ranks and the
    # proof); the bench's and the tools' K3 launches by dtype
    for row in roi_rows:
        shape = row["name"][len("roi_align_bwd["):].split(",")[0].rstrip("]")
        fp32 = row["dtype"] == "float32"
        row["path"] = "detector train, gloo detector" if fp32 else "none"
        row["launches"] = (roi_counts[shape] + par["gloo detector"].get(
            shape, 0)) if fp32 else 0
        row["proof_launches"] = proof_launches["k3"].get(
            (row["dtype"], ROI_SHAPES[shape][0], C_FPN), 0)
        add_paths(row, [f"K3 {row['dtype']} P{ROI_SHAPES[shape][0]} "
                        f"C{C_FPN}"])
    kernels += roi_rows
    idle = [row["name"] for row in kernels if row["launches"] < 1]
    if idle:
        print(f"FAIL: no path launched {idle}", file=sys.stderr)
        return 1
    save_line("kernels", {"card": card, "kernels": kernels})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def child_bench(tree, report, argv):
    """The bench phase's child (one a card under torchrun): the bench's
    main with ``argv``, which prints its line as ``python -m
    crct_tpu_torch.bench`` does, under record_shapes' patches; then K1, K2
    and K3 held against their plain versions at every shape this rank's
    bench gave them (check_shapes). Its failures go to ``report`` (its
    ``{rank}`` the rank's)."""
    sys.path.insert(0, tree)
    from contextlib import ExitStack

    from crct_tpu_torch import bench
    from crct_tpu_torch.ops import attention, roi_align_kernel

    seen, patches = record_shapes(attention, roi_align_kernel)
    with ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        bench.main(argv)
    failures = []
    # K3 runs in the detector sections alone
    need = ("k1", "k2") if "--no-detector" in argv and "--all" not in argv \
        else ("k1", "k2", "k3")
    check_shapes(attention, roi_align_kernel, seen, "bench", device_line(),
                 failures, need)
    with open(report.format(rank=os.environ.get("RANK", "0")), "w") as f:
        json.dump({"failures": failures}, f)
    return 0


def child_main(args):
    """The children: the bench phase's ``bench TREE REPORT -- ARGV`` (under
    torchrun over several cards), the parallel phase's ``ddp_train TREE
    OUT_JSON -- ARGV`` (started by torchrun) or ``ranks TREE ROOT RANK
    WORLD PORT BACKEND``."""
    if args[0] == "bench":
        return child_bench(args[1], args[2], args[args.index("--") + 1:])
    if args[0] == "ddp_train":
        return child_ddp_train(args[1], args[2], args[args.index("--") + 1:])
    return child_ranks(args[1], args[2], int(args[3]), int(args[4]), args[5],
                       args[6])


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child_main(sys.argv[2:]))
    sys.exit(main())
