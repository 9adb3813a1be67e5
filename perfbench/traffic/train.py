"""Training traffic: ``make_train_step`` over a pool of distinct batches.

The step is the port's (``train/train_loop.make_train_step``) with AdamW as
the ``Trainer`` builds it, bf16 autocast over fp32 masters as ``cli.train
-bf16`` runs it, dropout from one CPU generator. The pool's batches sit in
pinned host memory and are copied to the card at every step, and the
metric vector is read every ``metric_every`` steps, as the epoch loop
reads it.

Set-up makes the weights and the pool from the seed, builds the step and
drives it through its first three steps, each on other rows, reading
what the correctness check compares (each step's loss, the first
gradient from AdamW's state after one step, each leaf's change after
three), then warms up. The window times every step by CUDA events at
the step boundaries. With ``--trace``, or where the cell reports the
card's busy time a step end to end, a stretch of steps right after the
window runs under the profiler; with ``--trace`` the per-layer metrics are
read. The reference then repeats the first three steps from the same
weights, batches and dropout seeds, after the program's state is freed.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

from perfbench import common, gen, program, reference

STEP_KEYS = ["tokens", "segments", "loc", "sep_indices", "hist_len",
             "image_feat", "image_loc", "image_mask", "image_target", "R",
             "next_sentence_labels", "area"]
FIRST_STEPS = 3


def hyper(mix) -> Dict[str, float]:
    return dict(lr=mix["lr"], image_lr=mix["lr"], min_lr=mix["min_lr"],
                warmup=mix["warmup"], wd=mix["wd"], opt_bf16_m=False)


def keep_divisor(cfg, mix) -> float:
    """What kept attention probabilities are divided by: bf16(1 - rate) in
    the default attention mode with bf16 compute (JAX's XLA path), else
    1 - rate."""
    rate = cfg["model"]["attention_probs_dropout_prob"]
    if mix["dtype"] == "bfloat16" and mix["attention_mode"] == "round_probs":
        return float(torch.tensor(1.0 - rate, dtype=torch.bfloat16))
    return 1.0 - rate


class Feed:
    """The pool's batches on the host (pinned on a card's host) and the
    copy of one to the device."""

    def __init__(self, cfg, mix, seed, device):
        pool = gen.train_pool(cfg, seed, mix["pool_batches"], mix["batch"])
        pin = torch.device(device).type == "cuda"
        self.device = device
        self.host = [{k: (torch.from_numpy(b[k]).pin_memory() if pin
                          else torch.from_numpy(b[k]))
                      for k in STEP_KEYS if k in b} for b in pool]

    def __call__(self, i: int) -> Dict[str, torch.Tensor]:
        b = self.host[i % len(self.host)]
        return {k: v.to(self.device, non_blocking=True)
                for k, v in b.items()}


class Program:
    """The program's training step, its model and optimizer, and the
    dropout generator, set up from a seed."""

    def __init__(self, ctx, seed: int):
        from crct_tpu_torch.train.optimizer import AdamW
        from crct_tpu_torch.train.train_loop import make_train_step
        cfg, mix = ctx.cfg, ctx.mix
        weights = gen.make_weights(cfg, seed, ctx.device)
        ctx.phase("weights")
        self.model = program.model(cfg, weights, ctx.device, mix["dtype"],
                                   train=True)
        del weights
        ctx.phase("model")
        self.optimizer = AdamW(list(self.model.named_parameters()),
                               hyper(mix), mix["iters_per_epoch"])
        self.step = make_train_step(self.model, self.optimizer)
        self.generator = torch.Generator().manual_seed(gen.torch_seed(seed, 4))
        self.cfg = cfg

    def first_steps(self, feed: Feed) -> Dict[str, Any]:
        """Steps 1-3 through the window's own call and feed, on batches 0-2
        of the pool, and what the check compares."""
        params = dict(self.model.named_parameters())
        order = [n for n, _, _ in reference.param_spec(self.cfg)]
        p0 = {k: p.detach().clone() for k, p in params.items()}
        losses, grad_norms, sketches = [], None, None
        for i in range(FIRST_STEPS):
            m = self.step(feed(i), self.generator)
            losses.append(float(m[0]))
            if grad_norms is None:
                # the gradient as AdamW got it: mu = (1 - b1) g after one
                # update from zero
                g1 = {k: self.optimizer.state[k]["mu"].float()
                      / (1 - reference.B1) for k in order}
                grad_norms = {k: float(g.norm()) for k, g in g1.items()}
                sketches = {k: reference.sketch(j, g1[k]).cpu()
                            for j, k in enumerate(order)}
                del g1
        change = {k: float((params[k].detach() - p0[k]).norm())
                  for k in params}
        return {"losses": losses, "grad_norms": grad_norms,
                "change_norms": change, "grad_sketches": sketches}


def reference_steps(ctx, seed: int, feed: Feed, prec: str = "fp32",
                    rows=None) -> Dict[str, Any]:
    """The reference's first three steps from the seed's weights, on the
    same batches, drawing dropout from a generator seeded as the
    program's."""
    cfg, mix = ctx.cfg, ctx.mix
    W0 = gen.make_weights(cfg, seed, ctx.device)
    batches = [feed(i) for i in range(FIRST_STEPS)]
    g = torch.Generator().manual_seed(gen.torch_seed(seed, 4))
    hp = dict(lr=mix["lr"], min_lr=mix["min_lr"], warmup=mix["warmup"],
              wd=mix["wd"], t_total=mix["iters_per_epoch"] * 20.0)
    with reference.fp32_matmuls():
        return reference.train_steps(cfg, W0, batches, g, hp,
                                     keep_divisor(cfg, mix), prec, rows)


def gaps(prog: Dict[str, Any], ref: Dict[str, Any], scale: Dict[str, Any],
         worst=None) -> List:
    """The compared numbers. By the worst leaf, the gap between the
    program's and the reference's norms of the first gradient
    (``grad_gap``) and of the change over three steps (``change_gap``),
    each against the larger of the leaf's and the median leaf's reference
    norm. And ``grad_error``: the median leaf's relative error of the
    first gradient, estimated from Gaussian sketches (``reference.sketch``),
    over the same of ``scale``, the reference with its products rounded to
    bf16. Rounding averages out of a norm but not out of this error; the
    error's size swings from seed to seed with how far the rows' NSP terms
    cancel in the gradient, and the scale, computed on the same seed,
    takes that swing out. A leaf whose reference gradient is under a
    thousandth of the median leaf's (a key's bias under softmax) has a
    gradient of rounding alone and moves by round-off alone: it is left
    out of all three. ``worst``, a dict, gets the leaf that sets each
    worst-leaf number."""
    gr = ref["grad_norms"]
    g_med = float(np.median(list(gr.values())))
    moved = [k for k in gr if gr[k] >= 1e-3 * g_med]
    out = []
    for name, key in (("grad_gap", "grad_norms"),
                      ("change_gap", "change_norms")):
        r = ref[key]
        med = float(np.median([r[k] for k in moved]))
        by_leaf = {k: abs(prog[key][k] - r[k]) / max(r[k], med)
                   for k in moved}
        leaf = max(by_leaf, key=by_leaf.get)
        if worst is not None:
            worst[name] = leaf
        out.append((name, by_leaf[leaf]))
    rs = ref["grad_sketches"]

    def error(side):
        return float(np.median([float((side["grad_sketches"][k] - rs[k]).norm()
                                      / rs[k].norm()) for k in moved]))

    out.append(("grad_error", error(prog) / error(scale)))
    return out


class StepClock:
    """Step boundaries: CUDA events on the step's stream, read after the
    window; on the CPU the host's clock."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks: List[Any] = []

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> np.ndarray:
        if self.cuda:
            return np.asarray([a.elapsed_time(b) for a, b in
                               zip(self.marks, self.marks[1:])])
        return np.diff(np.asarray(self.marks)) * 1e3


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx) -> Dict[str, Any]:
    mix, dev, B = ctx.mix, ctx.device, ctx.mix["batch"]
    ctx.phase("start")
    program.build_kernels(dev)
    ctx.phase("kernels")
    feed = Feed(ctx.cfg, mix, ctx.seed, dev)
    ctx.phase("pool")
    prog = Program(ctx, ctx.seed)
    ctx.phase("optimizer")
    first = prog.first_steps(feed)
    ctx.phase("first_steps")
    n = FIRST_STEPS
    for _ in range(mix["warmup_steps"]):
        last = prog.step(feed(n), prog.generator)
        n += 1
    last.cpu()
    sync(dev)
    ctx.phase("warmup")
    setup_s = time.time() - ctx.t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    clock = StepClock(dev)
    failed, steps = 0, 0
    t0 = time.perf_counter()
    clock.mark()
    while True:
        m = prog.step(feed(n + steps), prog.generator)
        clock.mark()
        steps += 1
        if steps % mix["metric_every"] == 0:
            failed += int(not np.isfinite(float(m.cpu()[0])))
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    step_ms = clock.step_ms()
    n += steps
    step_p95 = float(np.percentile(step_ms, 95))
    out: Dict[str, Any] = {"attempted": steps, "failed": failed}
    out["e2e"] = {"train_qa_pairs_per_s": steps * B / window_s,
                  "train_step_ms_p95": step_p95, "setup_s": setup_s}
    print(f"window steps {steps} seconds {window_s!r} pairs_per_s "
          f"{steps * B / window_s!r} step_ms_p95 {step_p95!r}",
          file=sys.stderr, flush=True)

    # the card's busy time a step, an end-to-end metric where the cell
    # names it, is read from the same traced stretch as the per-layer
    # metrics: on the card only, after the window, whose rates it leaves
    # untraced
    busy_e2e = "train_busy_ms_per_step" in ctx.e2e_names
    if ctx.trace or (busy_e2e and dev.type == "cuda"):
        def stretch():
            for i in range(mix["trace_steps"]):
                prog.step(feed(n + i), prog.generator)
        trace = common.traced(stretch, dev, ctx.scratch)
        out["trace"] = trace
        out["e2e"]["train_busy_ms_per_step"] = \
            1e3 * trace["busy_s"] / mix["trace_steps"]
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else 0)
    if ctx.trace:
        out["per_layer"] = ctx.read_per_layer(
            {"ctx": ctx, "program": prog, "trace": out["trace"],
             "steps": steps, "window_s": window_s, "batch": B,
             "step_ms_p95": step_p95, "trace_steps": mix["trace_steps"]})

    del prog, last, m
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_steps(ctx, ctx.seed, feed)
    numbers = gaps(first, ref, reference_steps(ctx, ctx.seed, feed, "bf16"))
    out["checks"] = ctx.checks(numbers)
    out["correct"] = failed == 0
    return out


def calibrate(ctx, seeds):
    """The readings that set the limits, a dict a seed: the program's first
    three steps against the reference, and in the program's place the
    reference in fp8 (the control) and the reference with half of every
    batch left out (a fault)."""
    program.build_kernels(ctx.device)
    for seed in seeds:
        yield readings(ctx, seed)


def readings(ctx, seed: int) -> Dict[str, Any]:
    feed = Feed(ctx.cfg, ctx.mix, seed, ctx.device)
    prog = Program(ctx, seed)
    first = prog.first_steps(feed)
    del prog
    gc.collect()
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_steps(ctx, seed, feed)
    scale = reference_steps(ctx, seed, feed, "bf16")
    control = reference_steps(ctx, seed, feed, "fp8")
    half = reference_steps(ctx, seed, feed, rows=ctx.mix["batch"] // 2)
    where: Dict[str, Any] = {}
    c_where: Dict[str, Any] = {}
    h_where: Dict[str, Any] = {}
    return {"seed": seed,
            "program": dict(gaps(first, ref, scale, where)),
            "control_fp8": dict(gaps(control, ref, scale, c_where)),
            "fault_half_batch": dict(gaps(half, ref, scale, h_where)),
            "worst_leaf": {"program": where, "control_fp8": c_where,
                           "fault_half_batch": h_where},
            "loss_gap": {k: max(abs(a - b) / abs(b) for a, b in
                                zip(r["losses"], ref["losses"]))
                         for k, r in (("program", first),
                                      ("control_fp8", control),
                                      ("fault_half_batch", half))}}
