"""Benchmark of the port: QA-stage training throughput (QA pairs/s/card) and
the system's other throughputs (the port of ``bench.py``).

Runs the flagship full-size model (config/vilbert.json scale: 12 text layers
at 768, 6 vision layers at 1024, 6 co-attention blocks at bi_hidden 1024)
through ``train_loop.make_train_step`` at the reference's per-device batch
(80, README.md:69) on PlotQA shapes (124 tokens, 44 regions), under bf16
autocast over fp32 masters as ``cli.train -bf16`` runs it, with the
attention numerics of the JAX package's default path (``--pallas``: of its
Pallas path; ``aux.attention_path`` names the one that ran), then:

  eval           ``make_eval_step``, parameters cast to bf16 as ``cli.evaluate
                 -bf16`` does, on 480-row chunks: candidate rows/s
  fast scorer    ``make_fast_eval_step``: questions/s, one backbone pass each
  top-k 8        ``evaluate()`` on pre-materialised batches with
                 ``-fast_scorer -fast_scorer_topk 8``, and the full protocol
  input pipeline the native tokenizer and ``DataLoader``: samples/s
  roofline       (``--roofline``) device ms of the forward, the grad, the
                 grad without dropout and one AdamW update
  e2e            chart PNGs -> ``extract.batched_detect`` -> feature records
                 -> ``evaluate()``: charts/s (skip with ``--no-e2e``)
  detector       ``detector/trainer.make_detector_train_step`` at 800 x 1088,
                 batch 2 a card (skip with ``--no-detector``); ``--all`` adds
                 512 px at batch 8, ``bf16=True`` and ``fast_train_nms=True``.

Prints ONE JSON line, {"metric", "value", "unit", "vs_baseline", "aux"}, on
rank 0. The keys are bench.py's, so that each number has its counterpart
there; only the keys named after a chip's peak name the card
(``mfu_pct_h100_bf16``). A "chip" in a key is one card: one process a card
under torchrun, as the CLIs run, each rank timing the same synchronized loop
and the rates divided by the world size. ``aux`` also holds the card's name
and power limit from nvidia-smi, the seconds nvcc took to build the kernels
(before any timer starts), per section the launches of K1, K2 and K3 (on a
CUDA tensor each wrapper launches its kernel or raises: there is no plain
fallback there) and the peak device memory.

Every timed number is the median of repeated windows, each started and
closed by ``torch.cuda.synchronize()`` after a warm-up run of the same work
(the roofline's ``_ms`` keys but ``roofline_step_ms``: the card's kernel
time in each window, under torch.profiler); ``aux["spread"][key]`` holds
the windows' count and quartiles. No window is dropped or retried, and
nothing is read from or written to BENCH_LAST_GOOD.json. A section that
fails raises: the bench then prints no line.

FLOPs: ``torch.utils.flop_counter.FlopCounterMode``. The QA step is counted
on the CPU through the plain attention (K1 and K2 launch through ctypes
inside an autograd Function, which the mode cannot see) at flagship widths
and two rows, and scaled by the batch, which the count is linear in. The
detector step is counted on its own device; K3, invisible to the mode, is a
scatter of the pooled gradients, negligible beside the convolutions. MFU
divides by the card's dense peak for the step's dtype (``PEAK_TFLOPS``):
bf16 for the QA model, fp32 for the detector, which runs without TF32.

vs_baseline: the reference publishes no throughput numbers (BASELINE.md), so
the denominator is bench.py's documented estimate of the PyTorch-DDP per-GPU
training throughput of the same model and batch on the reference's 4-GPU
rig: fp16 autocast at ~0.7 s a step at batch 80, ~115 QA pairs/s/GPU. It is
an estimate for that GPU rig, not a measurement.

Usage: python -m crct_tpu_torch.bench [--no-e2e] [--no-detector] [--all]
           [--roofline] [--pallas] [--device cpu] [--tiny]
       torchrun --nproc_per_node N -m crct_tpu_torch.bench ...
(``--tiny``: a small model and sizes, to rehearse the bench on the CPU)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import tempfile
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from crct_tpu_torch import parallel
from crct_tpu_torch.config import CRCTModelConfig, default_params
from crct_tpu_torch.ops.attention import PALLAS, ROUND_PROBS
from crct_tpu_torch.utils.device import resolve_device
from crct_tpu_torch.utils.profiling import device_ms

BASELINE_QA_PAIRS_PER_SEC_PER_GPU = 115.0
BATCH_PER_CHIP = 80
WARMUP_STEPS = 3
MEASURE_STEPS = 20
# dense peaks in TFLOP/s by the card's name (NVIDIA's data sheet, SXM part,
# no sparsity; fp32 outside the tensor cores)
PEAK_TFLOPS = {"NVIDIA H100 80GB HBM3": {"bfloat16": 989.4, "float32": 67.0}}
KERNELS = ("attention_fwd", "attention_bwd", "roi_align_bwd")
FLOP_COUNT_ROWS = 2
# calls in a window of the roofline's device time: it is steady from call to
# call, and the profiler slows the host several times over
PROFILED_CALLS = 2

# the flagship sizes, and --tiny's for a rehearsal on the CPU
SIZES = {
    "full": dict(batch=BATCH_PER_CHIP, warmup=WARMUP_STEPS,
                 steps=MEASURE_STEPS, repeats=5, passes=3, eval_chunk=480,
                 fast_batch=64, questions=240, pipeline_samples=2400,
                 pipeline_images=64, e2e_images=8, e2e_canvas=512,
                 det_depth=50, det_hw=(800, 1088), det_batch=2,
                 det_hw_small=(512, 512), det_batch_small=8, det_steps=10,
                 det_repeats=3, det_roi_batch=256, eval_batch_size=None),
    "tiny": dict(batch=4, warmup=1, steps=1, repeats=2, passes=1,
                 eval_chunk=24, fast_batch=4, questions=8,
                 pipeline_samples=80, pipeline_images=8, e2e_images=2,
                 e2e_canvas=64, det_depth=14, det_hw=(64, 96), det_batch=2,
                 det_hw_small=(64, 64), det_batch_small=2, det_steps=1,
                 det_repeats=1, det_roi_batch=16, eval_batch_size=24),
}


def sized(size: Dict[str, Any], *names: str) -> Dict[str, Any]:
    """The sizes a section takes, by name (a name ``size`` lacks raises)."""
    return {name: size[name] for name in names}


def tiny_config() -> CRCTModelConfig:
    """The proof tool's tiny QA model (hidden 64, 1024-d region features)."""
    from crct_tpu_torch.tools.full_pipeline_proof import TINY_MODEL
    return CRCTModelConfig.from_dict(dict(TINY_MODEL))


def _synthetic_step_batch(rng: np.random.Generator, B: int, L: int, R: int,
                          vdim: int, vocab: int, cats: int
                          ) -> Dict[str, np.ndarray]:
    """A reference-shaped batch (see crct_tpu_torch.train.train_loop.
    STEP_KEYS) as numpy arrays; the caller puts them on its device."""
    needs = (np.arange(B) % 2).astype(np.float32)
    Rv = np.zeros((B, 4), np.float32)
    Rv[:, 0] = needs * 5.0
    Rv[:, 1] = needs
    Rv[:, 2] = 0.01
    Rv[:, 3] = np.where(needs > 0, 10.0, 0.0)
    seps = np.zeros((B, 50), np.int32)
    seps[:, 0] = L - 2
    return {
        "tokens": rng.integers(0, vocab, (B, L)).astype(np.int32),
        "segments": rng.integers(-1, 12, (B, L)).astype(np.int32),
        "loc": rng.random((B, L, 4)).astype(np.float32),
        "sep_indices": seps,
        "hist_len": np.zeros((B, 1), np.int32),
        "image_feat": rng.random((B, R, vdim)).astype(np.float32),
        "image_loc": rng.random((B, R, 4)).astype(np.float32),
        "image_target": rng.integers(0, cats, (B, R)).astype(np.int32),
        "image_mask": np.ones((B, R), np.float32),
        "R": Rv,
        "next_sentence_labels": rng.integers(0, 2, (B,)).astype(np.int32),
    }


def analytic_train_flops(B: int = 80, L: int = 124, R: int = 44) -> float:
    """Analytic matmul FLOPs for one flagship train step (fwd + bwd = 3x
    fwd matmuls), from the config/vilbert.json dims. Counts ONLY useful
    matmul FLOPs — no masked/padded work, no elementwise — so it is the
    conservative MFU denominator (the XLA cost model overcounts by also
    charging masked rows and non-matmul ops)."""
    H, FF, VH, VFF, BI = 768, 3072, 1024, 1024, 1024

    def mm(tokens, d_in, d_out):
        return 2.0 * tokens * d_in * d_out

    f = 0.0
    # embeddings (loc/type linears; table lookups are gathers, 0 FLOP)
    f += mm(B * L, 4, H)
    f += mm(B * R, 1024, VH) + mm(B * R, 4, VH)
    # 12 text self-attention layers
    f += 12 * (4 * mm(B * L, H, H)          # QKV + out proj
               + 2 * mm(B * L, L, H)        # scores + context
               + 2 * mm(B * L, H, FF))      # FFN in + out
    # 6 vision self-attention layers
    f += 6 * (4 * mm(B * R, VH, VH)
              + 2 * mm(B * R, R, VH)
              + 2 * mm(B * R, VH, VFF))
    # 6 connection layers (bi-attention + per-stream dense/FFN)
    f += 6 * (3 * mm(B * L, H, BI)          # text QKV -> bi
              + 3 * mm(B * R, VH, BI)       # vision QKV -> bi
              + 4 * mm(B * L, R, BI)        # two cross-attns, scores+ctx
              + mm(B * L, BI, H) + mm(B * R, BI, VH)   # back-projections
              + 2 * mm(B * L, H, FF)        # t_ffn
              + 2 * mm(B * R, VH, VFF))     # v_ffn
    # poolers + NSP head
    f += mm(B, H, BI) + mm(B, VH, BI) + mm(B, BI, 2)
    # hybrid regressor pipes (txt 768->768->512->256->256,
    # vis 1024->1024->512->256->256, fusion 512->512->256->256->1)
    reg = (768 * 768 + 768 * 512 + 512 * 256 + 256 * 256
           + 1024 * 1024 + 1024 * 512 + 512 * 256 + 256 * 256
           + 512 * 512 + 512 * 256 + 256 * 256 + 256 * 1)
    f += 2.0 * B * reg
    return 3.0 * f          # backward ~= 2x forward matmul FLOPs


def train_step_flops(cfg: Optional[CRCTModelConfig] = None,
                     batch: int = BATCH_PER_CHIP) -> float:
    """FLOPs of one QA train step's forward and backward at ``batch`` rows:
    FlopCounterMode over the step on the CPU at FLOP_COUNT_ROWS rows, through
    the plain attention, scaled by the batch. The count depends on shapes
    only, so the model keeps torch's default initialization and runs fp32."""
    from torch.utils.flop_counter import FlopCounterMode

    from crct_tpu_torch.models.crct import CRCTModel
    from crct_tpu_torch.train.train_loop import device_batch

    cfg = dataclasses.replace(cfg or CRCTModelConfig(), dtype="float32")
    model = CRCTModel(cfg, categories=228).train()
    rows = device_batch(_synthetic_step_batch(
        np.random.default_rng(0), B=FLOP_COUNT_ROWS, L=124, R=44,
        vdim=cfg.v_feature_size, vocab=cfg.vocab_size, cats=228), "cpu")
    with FlopCounterMode(display=False) as counter:
        model(rows, torch.Generator().manual_seed(0)).loss.backward()
    return counter.get_total_flops() * batch / FLOP_COUNT_ROWS


# ---------------------------------------------------------------------------
# the card, the kernels' launches, timing
# ---------------------------------------------------------------------------

def card_info(device) -> Dict[str, Any]:
    """The card's name and power limit as nvidia-smi gives them
    (``device_name``, ``power_limit_w``); on the CPU ``device_name`` "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device_name": "cpu"}
    index = device.index if device.index is not None else 0
    line = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return {"device_name": name, "power_limit_w": float(limit.split()[0])}


def peak_tflops(device_name: str) -> Dict[str, float]:
    """The card's dense peaks by dtype; a card the table does not know
    raises rather than dividing by another card's peak."""
    if device_name not in PEAK_TFLOPS:
        raise RuntimeError(f"no peak FLOP/s known for {device_name!r}: add "
                           f"it to PEAK_TFLOPS from the card's data sheet")
    return PEAK_TFLOPS[device_name]


def build_kernels() -> float:
    """Build the three kernels (one nvcc a source, all at once) and load
    them; the seconds it took (near 0 when already built)."""
    from crct_tpu_torch.ops import build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(build.build, KERNELS))
    for name in KERNELS:
        build.load(name)
    return time.perf_counter() - t0


def _launch_totals() -> Counter:
    from crct_tpu_torch.ops import attention, roi_align_kernel
    total = Counter()
    for tag, counts in (("K1", attention.LAUNCHES),
                        ("K2", attention.BWD_LAUNCHES)):
        for (dtype, mode, H, Lq, Lk, D), n in list(counts.items()):
            total[f"{tag} {dtype} {mode} {H}x{Lq}x{Lk}x{D}"] += n
    for (dtype, P, C), n in list(roi_align_kernel.LAUNCHES.items()):
        total[f"K3 {dtype} P{P} C{C}"] += n
    return total


class Launches:
    """K1, K2 and K3 launches inside a ``with`` block: ``record`` holds each
    kernel's total and the launches by kernel, dtype and shape."""

    def __enter__(self):
        self._start = _launch_totals()
        return self

    def __exit__(self, *exc):
        shapes = _launch_totals() - self._start
        self.record = {k: sum(n for s, n in shapes.items()
                              if s.startswith(k.upper() + " "))
                       for k in ("k1", "k2", "k3")}
        self.record["shapes"] = dict(sorted(shapes.items()))
        return False


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def windows(fn: Callable[[], Any], repeats: int, device) -> List[float]:
    """Seconds of ``repeats`` calls of ``fn``, each call between two
    synchronizes of ``device``."""
    seconds = []
    for _ in range(repeats):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        seconds.append(time.perf_counter() - t0)
    return seconds


def put_median(out: Dict[str, Any], key: str, samples) -> float:
    """``out[key]`` = the samples' median, ``out["spread"][key]`` their count
    and quartiles."""
    q1, med, q3 = np.percentile(np.asarray(samples, np.float64),
                                [25, 50, 75])
    out[key] = float(med)
    out.setdefault("spread", {})[key] = {"n": len(samples), "q1": float(q1),
                                         "q3": float(q3)}
    return float(med)


def eval_model(cfg: CRCTModelConfig, device, seed: int,
                fast_scorer: bool = False):
    """An eval model with random weights from ``seed``, its parameters cast
    to the config's dtype (bf16 for the flagship bench), as ``cli.evaluate
    -bf16`` casts them."""
    from crct_tpu_torch.models.crct import build_model
    return build_model(dict(default_params(seed=seed),
                            fast_scorer=fast_scorer),
                       dataclasses.replace(cfg), device=device)


def synthetic_eval_setup(root: str, cfg: CRCTModelConfig, questions: int,
                          eval_batch_size: Optional[int], **overrides):
    """A synthetic test split of 16 figures with ``questions`` questions on
    this rank (``questions`` times the world size in all), its params and
    its dataset with every candidate answer."""
    from crct_tpu_torch.data.dataset import ChartQADataset
    from crct_tpu_torch.data.synthetic import generate_dataset

    n_img = 16
    total = questions * parallel.world_size()
    cfg_ds = generate_dataset(os.path.join(root, "d"), n_images=n_img,
                              division=4, feat_dim=cfg.v_feature_size,
                              n_questions=-(-total // n_img))
    params = default_params(
        figure_feat_path=cfg_ds["figure_feat_path"],
        qa_parent_dir=cfg_ds["qa_parent_dir"],
        dataset_config={"dataset_files_divisions":
                        cfg_ds["dataset_files_divisions"]},
        splits=cfg_ds["splits"], categories=cfg_ds["categories"],
        eval_set="test", eval_batch_size=eval_batch_size, **overrides)
    ds = ChartQADataset(params, ["test"], init_split="test")
    ds.get_all_answers = True
    return params, ds


def materialize(ds, batch_size: int) -> List[Dict[str, np.ndarray]]:
    """This rank's shard of the split as loader batches of numpy arrays."""
    from crct_tpu_torch.data.dataset import DataLoader
    loader = DataLoader(ds, batch_size=batch_size, shuffle=False,
                        drop_last=False, num_workers=1,
                        num_shards=parallel.world_size(),
                        shard_index=parallel.rank())
    return [{k: np.asarray(v) for k, v in b.items()} for b in loader]


def n_questions(batches) -> int:
    return sum(len(np.asarray(b["id"]).reshape(-1)) for b in batches)


# ---------------------------------------------------------------------------
# sections
# ---------------------------------------------------------------------------

def train_state(cfg: CRCTModelConfig, device, batch: int,
                opt_bf16_m: bool = False):
    """The headline's model (bf16 autocast over fp32 masters, dropout on),
    its AdamW, its step, this rank's shard of a global batch of ``batch``
    rows a card on ``device`` and the dropout generator."""
    from crct_tpu_torch.models.crct import build_model
    from crct_tpu_torch.train.optimizer import AdamW
    from crct_tpu_torch.train.train_loop import device_batch, make_train_step

    world = parallel.world_size()
    model = build_model(default_params(bf16=True, seed=0),
                        dataclasses.replace(cfg), device=device, train=True)
    hp = dict(lr=2e-5, image_lr=2e-5, min_lr=1.3e-5, warmup=3000, wd=0.01,
              opt_bf16_m=opt_bf16_m)
    optimizer = AdamW(list(model.named_parameters()), hp,
                      iters_per_epoch=1000)
    parallel.broadcast_module(model)
    full = _synthetic_step_batch(np.random.default_rng(0), B=batch * world,
                                 L=124, R=44, vdim=cfg.v_feature_size,
                                 vocab=cfg.vocab_size, cats=228)
    mine = parallel.shard(batch * world)
    db = device_batch({k: v[mine] for k, v in full.items()}, device)
    generator = torch.Generator().manual_seed(parallel.rank_seed(2))
    return (model, optimizer, make_train_step(model, optimizer), db,
            generator)


def bench_train(cfg: CRCTModelConfig, device, *, batch: int = BATCH_PER_CHIP,
                warmup: int = WARMUP_STEPS, steps: int = MEASURE_STEPS,
                repeats: int = 5, opt_bf16_m: bool = False,
                time_optimizer: bool = False):
    """The headline: ``make_train_step`` at ``batch`` rows a card. Returns
    (keys, state): the state (model, batch on the card, dropout generator,
    and with ``time_optimizer`` the device ms of one AdamW update on the
    last step's gradients, ``repeats`` samples of PROFILED_CALLS updates
    each, else None) serves the roofline."""
    model, optimizer, step, db, generator = train_state(cfg, device, batch,
                                                        opt_bf16_m)
    for _ in range(warmup):
        step(db, generator)
    seconds = windows(lambda: [step(db, generator) for _ in range(steps)],
                      repeats, device)
    world = parallel.world_size()
    out: Dict[str, Any] = {}
    put_median(out, "value", [batch * world * steps / s / world
                              for s in seconds])
    put_median(out, "train_step_ms", [s / steps * 1e3 for s in seconds])
    optimizer_ms = None
    if time_optimizer:
        optimizer_ms = [device_ms(optimizer.step, device,
                                  iters=PROFILED_CALLS, warmup=0)
                        for _ in range(repeats)]
    return out, (model, db, generator, optimizer_ms)


def bench_eval(cfg: CRCTModelConfig, device, *, eval_chunk: int = 480,
               steps: int = MEASURE_STEPS, repeats: int = 5):
    """Eval-path throughput with the 120-candidate fan-out: candidate rows
    scored per second through the eval step (the reference's real
    bottleneck, evaluation.py:243-262 — every question expands to up to 120
    rows, fig_dataloader.py:76), ``eval_chunk`` rows a card a step."""
    from crct_tpu_torch.train.eval_loop import make_eval_step, to_device

    model = eval_model(cfg, device, seed=1)
    rows = _synthetic_step_batch(np.random.default_rng(1), B=eval_chunk,
                                 L=124, R=44, vdim=cfg.v_feature_size,
                                 vocab=cfg.vocab_size, cats=228)
    rows.pop("next_sentence_labels")
    rows = to_device(rows, device)
    step = make_eval_step(model)
    step(rows)
    seconds = windows(lambda: [step(rows) for _ in range(steps)], repeats,
                      device)
    out: Dict[str, Any] = {}
    rate = put_median(out, "eval_candidate_rows_per_sec_per_chip",
                      [eval_chunk * steps / s for s in seconds])
    out["eval_questions_per_sec_per_chip_at_120_fanout"] = rate / 120.0
    return out


def bench_fast_scorer(cfg: CRCTModelConfig, device, *, fast_batch: int = 64,
                      steps: int = MEASURE_STEPS, repeats: int = 5):
    """Fast-scorer eval throughput: one backbone pass per question + the
    light candidate head (vs 120 backbone passes in the reference
    protocol). Random weights — a pure throughput number."""
    from crct_tpu_torch.train.eval_loop import (FAST_CAND_TOKENS,
                                                make_fast_eval_step,
                                                to_device)

    B, C = fast_batch, 120
    rng = np.random.default_rng(2)
    model = eval_model(cfg, device, seed=3, fast_scorer=True)
    rows = _synthetic_step_batch(rng, B=B, L=124, R=44,
                                 vdim=cfg.v_feature_size,
                                 vocab=cfg.vocab_size, cats=228)
    rows.pop("next_sentence_labels")
    rows["attention_mask"] = np.ones((B, 124), np.float32)
    rows["cand_tokens"] = rng.integers(1, cfg.vocab_size,
                                       (B, C, FAST_CAND_TOKENS))
    rows["cand_valid"] = np.ones((B, C), np.float32)
    rows = to_device(rows, device)
    step = make_fast_eval_step(model)
    step(rows)
    seconds = windows(lambda: [step(rows) for _ in range(steps)], repeats,
                      device)
    out: Dict[str, Any] = {}
    put_median(out, "fast_scorer_questions_per_sec_per_chip",
               [B * steps / s for s in seconds])
    return out


def bench_fast_topk8(cfg: CRCTModelConfig, device, *, questions: int = 240,
                     passes: int = 3, eval_batch_size: Optional[int] = None):
    """Measured ``-fast_scorer -fast_scorer_topk 8`` throughput through the
    REAL ``evaluate()`` loop — shortlist argsort, candidate-row gather,
    chunked fast + rescore dispatches, and all accounting — at flagship
    scale on PlotQA shapes. Loader batches are pre-materialized so the
    number isolates the eval engine (the host example builder is benched
    separately as input_pipeline_samples_per_sec_per_host). The full
    reference protocol is measured on the SAME batches (reference fan-out:
    evaluation.py:243-262)."""
    from crct_tpu_torch.train.eval_loop import evaluate

    with tempfile.TemporaryDirectory() as td:
        params, ds = synthetic_eval_setup(td, cfg, questions,
                                           eval_batch_size, fast_scorer=True,
                                           fast_scorer_topk=8)
        # 120 questions a batch: the fast chunks and the rescore chunks
        # fill evenly
        batches = materialize(ds, 120)
        n_q = n_questions(batches)
        fanout = float(np.mean(np.concatenate(
            [np.asarray(b["num_ans"]).reshape(-1) for b in batches])))
        model = eval_model(cfg, device, seed=4, fast_scorer=True)
        out: Dict[str, Any] = {"eval_measured_mean_candidates": fanout}
        for key, p in (
                ("fast_topk8_questions_per_sec_per_chip", params),
                ("eval_protocol_questions_per_sec_per_chip_measured",
                 dict(params, fast_scorer=False, fast_scorer_topk=0))):
            def run(p=p):
                evaluate(batches, ds, dict(p), model, csv=False,
                         log_print=lambda m: None)
            run()                                       # warm-up pass
            put_median(out, key, [n_q / s for s in
                                  windows(run, passes, device)])
        return out


def bench_input_pipeline(cfg: CRCTModelConfig, device, *,
                         pipeline_samples: int = 2400,
                         pipeline_images: int = 64, batch: int = 80,
                         passes: int = 3):
    """Host-side input pipeline: samples/s through the example builder and
    the loader (PlotQA-shaped synthetic records, 1024-d features, the native
    C++ tokenizer as the CLIs use it). Each rank feeds its card with a loader
    of its own, so the host's rate is the sum over the ranks. The number to
    compare with the train step's consumption (QA pairs/s/card x cards)."""
    from crct_tpu_torch.data.dataset import ChartQADataset, DataLoader
    from crct_tpu_torch.data.native import write_vocab_file
    from crct_tpu_torch.data.synthetic import generate_dataset
    from crct_tpu_torch.data.tokenizer import WordPieceTokenizer

    with tempfile.TemporaryDirectory() as td:
        cfg_ds = generate_dataset(os.path.join(td, "d"),
                                  n_images=pipeline_images, division=8,
                                  n_questions=16,
                                  feat_dim=cfg.v_feature_size)
        vocab_path = write_vocab_file(WordPieceTokenizer.synthetic().vocab,
                                      os.path.join(td, "vocab.txt"))
        params = default_params(
            figure_feat_path=cfg_ds["figure_feat_path"],
            qa_parent_dir=cfg_ds["qa_parent_dir"],
            dataset_config={"dataset_files_divisions":
                            cfg_ds["dataset_files_divisions"]},
            splits=cfg_ds["splits"], categories=cfg_ds["categories"],
            vocab_file=vocab_path)
        ds = ChartQADataset(params, ["train"])
        loader = DataLoader(ds, batch_size=batch, shuffle=True,
                            drop_last=True, num_workers=1)
        next(iter(loader))         # warm (lazy shard loads + native lib)

        def run():
            n = 0
            while n < pipeline_samples:
                for _ in loader:
                    n += batch
                    if n >= pipeline_samples:
                        break
            return n

        seconds = []
        for _ in range(passes):
            t0 = time.perf_counter()
            n = run()
            seconds.append(time.perf_counter() - t0)
        rates = parallel.global_sum(np.asarray([n / s for s in seconds]))
        out: Dict[str, Any] = {}
        put_median(out, "input_pipeline_samples_per_sec_per_host", rates)
        return out


def bench_e2e_charts(cfg: CRCTModelConfig, device, *, e2e_images: int = 8,
                     e2e_canvas: int = 512, det_depth: int = 50,
                     passes: int = 3, eval_batch_size: Optional[int] = None):
    """End-to-end charts/s on one card: chart PNG -> Mask R-CNN R50-FPN
    detection -> feature extraction (<IMG> token, GT-text oracle, axes
    normalization) -> full-size CRCT QA answer through ``evaluate()``. One
    untimed pass first, then ``passes`` timed ones."""
    from PIL import Image

    from crct_tpu_torch.data.dataset import ChartQADataset, DataLoader
    from crct_tpu_torch.detector.coco import PIXEL_MEAN, PIXEL_STD
    from crct_tpu_torch.detector.extract import (batched_detect,
                                                 build_feature_record,
                                                 get_gt_texts,
                                                 get_nonvis_ids,
                                                 inject_img_token,
                                                 path_to_img_id,
                                                 sorted_image_files)
    from crct_tpu_torch.detector.mask_rcnn import (MaskRCNN,
                                                   init_detector_weights)
    from crct_tpu_torch.detector.synthetic_charts import generate_png_dataset
    from crct_tpu_torch.train.eval_loop import (evaluate,
                                                resolve_eval_question_batch)

    IMG = e2e_canvas
    td = tempfile.mkdtemp(prefix="crct_bench_e2e_")
    try:
        env = generate_png_dataset(os.path.join(td, "data"),
                                   n_images=e2e_images, seed=0, split="test")
        out_dir = os.path.join(td, "fig_features", "test")
        qa_dir = os.path.join(td, "QA", "test")
        os.makedirs(out_dir, exist_ok=True)
        os.makedirs(qa_dir, exist_ok=True)
        shutil.copy(env["qa_file"], os.path.join(qa_dir, "qa_pairs.npy"))

        detector = MaskRCNN(num_classes=25, depth=det_depth, with_mask=True)
        init_detector_weights(detector, torch.Generator().manual_seed(0))
        detector = detector.to(device).eval()
        with open(env["annotations"]) as f:
            gt_ann = json.load(f)
        _, cls_dict = get_nonvis_ids("plotqa")
        files = sorted_image_files(env["png_dir"])

        def extract_pass():
            stack, sizes = [], []
            for img_path in files:
                with Image.open(img_path) as im:
                    raw = np.asarray(im.convert("RGB"), np.float32)
                sizes.append(raw.shape[:2])
                norm = (raw - PIXEL_MEAN) / PIXEL_STD
                padded = np.zeros((IMG, IMG, 3), np.float32)
                padded[:raw.shape[0], :raw.shape[1]] = norm[:IMG, :IMG]
                stack.append(padded)
            whs = [np.asarray([min(h, IMG), min(w, IMG)], np.float32)
                   for h, w in sizes]
            det_out = batched_detect(detector, stack, len(files), whs)
            records = []
            for img_path, (h, w), (out, img_feat) in zip(files, sizes,
                                                         det_out):
                valid = out["valid"]
                feats, classes, boxes = inject_img_token(
                    out["features"][valid], out["classes"][valid],
                    out["boxes"][valid], np.asarray(img_feat), (h, w))
                image_id = path_to_img_id(img_path)
                gt_texts = get_gt_texts(gt_ann[image_id], cls_dict, "plotqa")
                # random weights: silence the per-image "No axes were
                # detected" warnings
                records.append(build_feature_record(
                    image_id, feats, classes, boxes, (h, w),
                    dataset="plotqa", gt_texts=gt_texts, ocr_mode="gt",
                    verbose=False))
            np.save(os.path.join(out_dir, "0.npy"),
                    np.asarray(records, dtype=object), allow_pickle=True)

        # eval_batch_size None: the CLI's auto row chunk and loader batch
        params = default_params(
            figure_feat_path=os.path.join(td, "fig_features") + "/",
            qa_parent_dir=os.path.join(td, "QA") + "/",
            dataset_config={"dataset_files_divisions": {"test": e2e_images}},
            eval_set="test", eval_batch_size=eval_batch_size,
            save_path=os.path.join(td, "results"))
        model = eval_model(cfg, device, seed=1)
        phases: Dict[str, List[float]] = {"qa_build_s": [], "qa_eval_s": []}
        counted = []

        def qa_pass():
            t = time.perf_counter()
            ds = ChartQADataset(params, ["test"], init_split="test")
            ds.get_all_answers = True
            loader = DataLoader(ds, batch_size=resolve_eval_question_batch(
                                    params), shuffle=False,
                                drop_last=False, num_workers=1)
            # materialize: host example building apart from device eval
            batches = list(loader)
            phases["qa_build_s"].append(time.perf_counter() - t)
            counted.append(n_questions(batches))
            t = time.perf_counter()
            evaluate(batches, ds, params, model, csv=False,
                     log_print=lambda m: None)
            sync(device)
            phases["qa_eval_s"].append(time.perf_counter() - t)

        extract_pass()                   # untimed first pass
        qa_pass()
        for v in phases.values():
            v.clear()
        whole, extract_s = [], []
        for _ in range(passes):
            sync(device)
            t0 = time.perf_counter()
            extract_pass()
            sync(device)
            t1 = time.perf_counter()
            qa_pass()
            whole.append(time.perf_counter() - t0)
            extract_s.append(t1 - t0)
        out: Dict[str, Any] = {}
        put_median(out, "e2e_charts_per_sec_per_chip",
                   [e2e_images / s for s in whole])
        put_median(out, "e2e_extract_s", extract_s)
        put_median(out, "e2e_qa_s", [w - e for w, e in zip(whole,
                                                            extract_s)])
        for k, v in phases.items():
            put_median(out, k, v)
        out["qa_questions"] = counted[-1]
        return out
    finally:
        shutil.rmtree(td, ignore_errors=True)


def bench_detector_train(device, *, det_hw=(800, 1088), det_batch: int = 2,
                         key_suffix: str = "_800px", bf16: bool = False,
                         fast_nms: bool = False, det_depth: int = 50,
                         warmup: int = WARMUP_STEPS, det_steps: int = 10,
                         det_repeats: int = 3, det_roi_batch: int = 256,
                         with_flops: bool = False,
                         peaks: Optional[Dict[str, float]] = None):
    """Detector train-step throughput: Mask R-CNN R50-FPN (25 classes), a
    synthetic batch of ``det_batch`` images a card on the ``det_hw`` canvas,
    the reference solver (frcnn.py:167-175) through ``DetectorTrainer``'s
    step, fp32 without TF32 (``bf16``: autocast over fp32 masters;
    ``fast_nms``: the parallel train-time NMS). ``with_flops`` counts one
    step's FLOPs on the card (its MFU against ``peaks``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from crct_tpu_torch.detector.trainer import DetectorTrainer, device_batch

    world = parallel.world_size()
    B, (IH, IW), MAXB = det_batch * world, det_hw, 40
    rng = np.random.default_rng(0)
    raw = np.sort(rng.random((B, MAXB, 2, 2), np.float32) * min(IH, IW),
                  axis=2)
    batch = {
        "image": rng.random((B, IH, IW, 3)).astype(np.float32),
        "gt_boxes": np.concatenate([raw.min(2), raw.max(2)], -1),
        "gt_classes": rng.integers(0, 25, (B, MAXB)).astype(np.int32),
        "gt_valid": (rng.random((B, MAXB)) < 0.5).astype(np.float32),
        "gt_masks28": (rng.random((B, MAXB, 28, 28)) < 0.5).astype(
            np.float32),
    }
    trainer = DetectorTrainer(num_classes=25, with_mask=True,
                              depth=det_depth, batch_size=B, bf16=bf16,
                              fast_nms=fast_nms, roi_batch=det_roi_batch,
                              device=device)
    mine = parallel.shard(B)
    db = device_batch({k: v[mine] for k, v in batch.items()}, device)

    def step():
        return trainer.step_fn(db, trainer.generator)

    for _ in range(warmup):
        step()
    seconds = windows(lambda: [step() for _ in range(det_steps)],
                      det_repeats, device)
    out: Dict[str, Any] = {}
    rate = put_median(out, f"detector_train_imgs_per_sec_per_chip"
                           f"{key_suffix}",
                      [B * det_steps / s / world for s in seconds])
    if with_flops:
        with FlopCounterMode(display=False) as counter:
            step()
        flops = float(counter.get_total_flops())
        out[f"detector_train_step_tflop{key_suffix}"] = flops / 1e12
        if peaks:
            peak = peaks["bfloat16" if bf16 else "float32"]
            out[f"detector_mfu_pct{key_suffix}"] = (
                100.0 * flops * (rate / det_batch) / 1e12 / peak)
    return out


def bench_roofline(model, db, generator, device, *, batch: int,
                   step_ms_headline: float, optimizer_ms: List[float],
                   repeats: int = 5,
                   peaks: Optional[Dict[str, float]] = None):
    """Decompose the train step's device time on the headline's model and
    batch: forward only, forward + backward, and forward + backward with
    dropout off, each the card's kernels' time (``device_ms``: the host's
    launching and the card's idle gaps left out) of PROFILED_CALLS calls,
    in turns, ``repeats`` times; the dropout's share is the median of each
    turn's grad minus no-dropout difference, the optimizer's one AdamW
    update's device time (timed in the headline's section). bench.py times
    walls and takes the step minus the grad and the grad minus the
    no-dropout grad: on the TPU its step waits on no host, while here it
    does (``roofline_step_ms``, the headline's wall, is far above the
    device's grad), and a difference of host-bound walls is noise. MFU
    denominators come from analytic_train_flops."""
    params = list(model.parameters())

    def fwd():
        with torch.no_grad():
            model(db, generator)

    def grad():
        for p in params:
            p.grad = None
        model(db, generator).loss.backward()

    def no_dropout(fn):
        # dropout off: the submodules that draw it in eval mode, the model
        # in training mode for its losses (JAX's deterministic=True)
        def run():
            model.bert.eval()
            model.cls.eval()
            try:
                fn()
            finally:
                model.train()
        return run

    runs = {"fwd": fwd, "grad": grad, "grad_no_dropout": no_dropout(grad)}
    ms = {name: [] for name in runs}
    for run in runs.values():
        run()
    for _ in range(repeats):
        for name, run in runs.items():
            ms[name].append(device_ms(run, device, iters=PROFILED_CALLS,
                                      warmup=0))
    for p in params:
        p.grad = None
    out: Dict[str, Any] = {}
    fwd_ms = put_median(out, "roofline_fwd_ms", ms["fwd"])
    grad_ms = put_median(out, "roofline_grad_ms", ms["grad"])
    put_median(out, "roofline_grad_no_dropout_ms", ms["grad_no_dropout"])
    put_median(out, "roofline_dropout_ms",
               [g - d for g, d in zip(ms["grad"], ms["grad_no_dropout"])])
    put_median(out, "roofline_optimizer_ms", optimizer_ms)
    out["roofline_step_ms"] = step_ms_headline
    if peaks:
        a = analytic_train_flops(B=batch)
        out["roofline_fwd_mfu_pct"] = (100.0 * a / 3.0 / 1e12
                                       / (fwd_ms / 1e3) / peaks["bfloat16"])
        out["roofline_grad_mfu_pct"] = (100.0 * a / 1e12 / (grad_ms / 1e3)
                                        / peaks["bfloat16"])
    return out


# ---------------------------------------------------------------------------
# the line
# ---------------------------------------------------------------------------

class _Aux(dict):
    """``aux``: section keys merged in, spreads into one ``spread`` dict, and
    per section its launches and (on the card) peak memory."""

    def section(self, name: str, device, fn: Callable[[], Dict[str, Any]]):
        cuda = torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        with Launches() as launched:
            out = dict(fn())
        self.setdefault("launches", {})[name] = launched.record
        if cuda:
            self.setdefault("peak_mem_gb", {})[name] = (
                torch.cuda.max_memory_allocated(device) / 1e9)
        self.setdefault("spread", {}).update(out.pop("spread", {}))
        self.update(out)
        return out


def main(argv=None) -> Optional[Dict[str, Any]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-e2e", action="store_true",
                    help="skip the chart-to-answer section")
    ap.add_argument("--no-detector", action="store_true",
                    help="skip the 800 x 1088 detector section")
    ap.add_argument("--all", action="store_true",
                    help="also the 512 px, bf16 and fast-NMS detector steps")
    ap.add_argument("--roofline", action="store_true",
                    help="also the forward / grad / no-dropout decomposition")
    ap.add_argument("--pallas", action="store_true",
                    help="K1 and K2 with the numerics of the JAX Pallas "
                         "path (bf16 probabilities kept fp32 through P.V)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true",
                    help="a small model and sizes (a rehearsal on the CPU)")
    ap.add_argument("--repeats", type=int, default=None,
                    help="timed windows (or passes) of each section, at "
                         "most (default: the size's, 5 and 3)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)     # no card: raise before any work
    dist_params = {"device": args.device}
    formed = parallel.maybe_initialize_distributed(dist_params)
    if device.type == "cuda":
        device = torch.device("cuda", max(dist_params.get("cuda_num", 0), 0))
        torch.cuda.set_device(device)
    # fp32 products at full fp32 precision, as the detector trainer and the
    # extractor run them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    size = dict(SIZES["tiny" if args.tiny else "full"])
    if args.repeats is not None:
        if args.repeats < 1:
            ap.error("--repeats must be at least 1")
        for key in ("repeats", "passes", "det_repeats"):
            size[key] = min(size[key], args.repeats)
    cfg = tiny_config() if args.tiny else CRCTModelConfig()
    cfg.dtype = "bfloat16"
    cfg.use_pallas_attention = args.pallas
    world = parallel.world_size()

    aux = _Aux(attention_path="cuda_k1_k2_"
               + (PALLAS if args.pallas else ROUND_PROBS), n_chips=world,
               **card_info(device))
    peaks = None
    if device.type == "cuda":
        peaks = peak_tflops(aux["device_name"])
        aux["peak_tflops"] = peaks
        aux["nvcc_build_s"] = build_kernels()
    from crct_tpu_torch.data import native
    t0 = time.perf_counter()
    native.build_library()
    aux["gxx_build_s"] = time.perf_counter() - t0

    state = None

    def headline():
        nonlocal state
        out, state = bench_train(
            cfg, device, time_optimizer=args.roofline,
            **sized(size, "batch", "warmup", "steps", "repeats"))
        return out

    aux.section("train", device, headline)
    qps = aux.pop("value")
    aux.section("eval", device, lambda: bench_eval(
        cfg, device, **sized(size, "eval_chunk", "steps", "repeats")))
    aux.section("fast_scorer", device, lambda: bench_fast_scorer(
        cfg, device, **sized(size, "fast_batch", "steps", "repeats")))
    # -fast_scorer_topk 8 composite: one fast backbone pass + 8 full-model
    # candidate rows per question, the two dispatch types measured above
    aux["fast_topk8_questions_per_sec_per_chip_derived"] = 1.0 / (
        1.0 / aux["fast_scorer_questions_per_sec_per_chip"]
        + 8.0 / aux["eval_candidate_rows_per_sec_per_chip"])
    aux.section("fast_topk8", device, lambda: bench_fast_topk8(
        cfg, device, **sized(size, "questions", "passes",
                             "eval_batch_size")))
    aux.section("input_pipeline", device, lambda: bench_input_pipeline(
        cfg, device, **sized(size, "pipeline_samples", "pipeline_images",
                             "batch", "passes")))
    if args.roofline:
        # the optimizer's state went with the headline's section
        model, db, generator, optimizer_ms = state
        if device.type == "cuda":
            torch.cuda.empty_cache()
        aux.section("roofline", device, lambda: bench_roofline(
            model, db, generator, device, batch=size["batch"],
            step_ms_headline=aux["train_step_ms"],
            optimizer_ms=optimizer_ms, repeats=size["repeats"],
            peaks=peaks))
        del model, db, generator
    state = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if not args.no_e2e:
        aux.section("e2e", device, lambda: bench_e2e_charts(
            cfg, device, **sized(size, "e2e_images", "e2e_canvas",
                                 "det_depth", "passes", "eval_batch_size")))
    det = dict(sized(size, "det_hw", "det_batch", "det_depth", "warmup",
                     "det_steps", "det_repeats", "det_roi_batch"),
               peaks=peaks)
    if args.all:
        aux.section("detector", device, lambda: bench_detector_train(
            device, **dict(det, det_hw=size["det_hw_small"],
                           det_batch=size["det_batch_small"], key_suffix="")))
        aux.section("detector_800px_bf16", device, lambda: (
            bench_detector_train(device, **dict(
                det, key_suffix="_800px_bf16", bf16=True))))
        aux.section("detector_800px_fastnms", device, lambda: (
            bench_detector_train(device, **dict(
                det, key_suffix="_800px_fastnms", fast_nms=True))))
    if not args.no_detector:
        aux.section("detector_800px", device, lambda: bench_detector_train(
            device, **dict(det, with_flops=True)))

    result = None
    if parallel.rank() == 0:
        # the step's FLOPs at this batch: counted on the CPU, after every
        # timed section
        flops = train_step_flops(cfg, batch=size["batch"])
        a_flops = analytic_train_flops(B=size["batch"])
        aux["train_step_tflop"] = flops / 1e12
        aux["train_step_tflop_analytic"] = a_flops / 1e12
        if peaks:
            per_sec = qps / size["batch"]
            aux["mfu_pct_h100_bf16"] = (100.0 * flops * per_sec / 1e12
                                        / peaks["bfloat16"])
            aux["mfu_pct_h100_bf16_analytic"] = (
                100.0 * a_flops * per_sec / 1e12 / peaks["bfloat16"])
        result = {
            "metric": "train QA-pairs/sec/chip (batch 80, bf16, full CRCT)",
            "value": qps,
            "unit": "qa_pairs/s/chip",
            "vs_baseline": qps / BASELINE_QA_PAIRS_PER_SEC_PER_GPU,
            "aux": dict(aux),
        }
        print(json.dumps(result), flush=True)
    if formed:
        parallel.destroy()
    return result


if __name__ == "__main__":
    main()
