"""Evaluation traffic: ``train/eval_loop.evaluate()``, the full protocol.

Every candidate answer of a question is scored by the model (fp32 as
``cli.evaluate`` runs by default, the automatic chunk of rows and question
batch), and the question's answer is the candidate of the highest NSP
probability. The loader batches are made by the benchmark from the seed
(``gen.EvalQuestions``) and cycled; example building is not timed.

The window is one call of ``evaluate()`` over batches handed out until
``--seconds`` have passed. What it produced is read where it is produced:
each chunk's NSP logits by a forward hook on the model, each question's
answer, confidence and regression output by ``evaluate()``'s prediction
records. After the window a sample of the questions drawn from the seed,
the one with the most candidates among them, is scored again by the
reference, on the same rows.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Dict, List

import numpy as np
import torch

from perfbench import common, gen, program, reference


class Setup:
    """The program's eval model with the seed's weights, the seed's
    questions and the params ``evaluate()`` reads."""

    def __init__(self, ctx, seed: int, model=None):
        from crct_tpu_torch.config import default_params
        cfg, mix = ctx.cfg, ctx.mix
        d = cfg["dataset"]
        weights = gen.make_weights(cfg, seed, ctx.device)
        ctx.phase("weights")
        if model is None:
            model = program.model(cfg, weights, ctx.device, mix["dtype"],
                                  train=False)
        else:
            model.load_state_dict(weights, strict=True)
        del weights
        self.model = model
        ctx.phase("model")
        self.questions = gen.EvalQuestions(
            cfg, seed, mix["questions"], mix["question_batch"],
            mix["candidates"])
        self.params = default_params(
            dataset=d["dataset"], categories=d["categories"],
            binary_answers=d["binary_answers"], eval_batch_size=None,
            max_seq_len=d["max_seq_len"], max_vis_features=d["max_vis_features"],
            bf16=mix["dtype"] == "bfloat16")
        self.chunks: List = []
        self.preds: List[Dict[str, Any]] = []
        self.hook = self.model.register_forward_hook(
            lambda mod, inp, out: self.chunks.append(
                (out.nsp_logits, out.reg_output)))

    def evaluate(self, batch_ids):
        from crct_tpu_torch.train.eval_loop import evaluate
        batches = (self.questions.batches[i] for i in batch_ids)
        evaluate(batches, self.questions, self.params, self.model, csv=False,
                 log_print=lambda msg: None, on_predictions=self.preds.extend)

    def reset(self):
        self.chunks.clear()
        self.preds.clear()


def served(setup: Setup, fed: List[int], chunk: int) -> List[Dict[str, Any]]:
    """Per question served, in order: its id, the NSP probability the
    program gave each candidate, its answer, confidence and regression
    output. Raises where the outputs do not match the questions fed."""
    qs = setup.questions
    it = iter(setup.chunks)
    out = []
    preds = iter(setup.preds)
    for b in fed:
        ids = [int(i) for i in qs.batches[b]["id"]]
        n = int(sum(qs.num_ans[i] for i in ids))
        k = -(-n // chunk)
        logits = torch.cat([next(it)[0] for _ in range(k)])[:n].float()
        probs = torch.softmax(logits, -1)[:, 0].cpu().numpy()
        at = 0
        for q in ids:
            rec = next(preds)
            if rec["question_id"] != q:
                raise RuntimeError(f"prediction for {rec['question_id']}, "
                                   f"question {q} was fed")
            m = int(qs.num_ans[q])
            out.append({"id": q, "probs": probs[at:at + m],
                        "answer": int(rec["cls_output"][1:]),
                        "confidence": rec["confidence"],
                        "reg_output": rec.get("reg_output")})
            at += m
    if next(it, None) is not None or next(preds, None) is not None:
        raise RuntimeError("more outputs than questions fed")
    return out


def sample(records: List[Dict[str, Any]], seed: int, size: int,
           num_ans) -> List[Dict[str, Any]]:
    """``size`` of the served questions drawn from the seed, the one with
    the most candidates always among them."""
    rng = np.random.default_rng(gen.substream(seed, 5))
    longest = max(range(len(records)), key=lambda i: num_ans[records[i]["id"]])
    rest = [i for i in range(len(records)) if i != longest]
    pick = [longest] + list(rng.choice(rest, min(size - 1, len(rest)),
                                       replace=False))
    return [records[i] for i in pick]


def reference_scores(ctx, seed: int, qids, prec: str = "fp32"):
    """The reference's per-row outputs for the questions ``qids``, from the
    seed's weights and questions."""
    cfg = ctx.cfg
    W = gen.make_weights(cfg, seed, ctx.device)
    qs = gen.EvalQuestions(cfg, seed, ctx.mix["questions"],
                           ctx.mix["question_batch"], ctx.mix["candidates"])
    out = {}
    with reference.fp32_matmuls():
        for q in sorted(set(qids)):
            rows = {k: torch.from_numpy(np.ascontiguousarray(v)).to(ctx.device)
                    for k, v in qs.rows(q).items()}
            s = reference.score_rows(cfg, W, rows, prec)
            out[q] = {k: v.cpu().numpy() for k, v in s.items()}
            out[q]["y"] = float(qs.rows(q)["R"][0, 3] or 1.0)
            out[q]["needs_reg"] = bool(qs.rows(q)["R"][0, 1] > 0)
    return out


def gaps(picked, ref) -> List:
    """The compared numbers: the widest gap of a candidate's NSP
    probability, by how much the reference's probability of the answer
    chosen lies below its best, and the widest gap of a regression output
    in normalized units."""
    nsp = max(float(np.abs(r["probs"] - ref[r["id"]]["nsp_prob"]).max())
              for r in picked)
    choice = max(float(ref[r["id"]]["nsp_prob"].max()
                       - ref[r["id"]]["nsp_prob"][r["answer"]])
                 for r in picked)
    regs = [float(abs(r["reg_output"] / ref[r["id"]]["y"]
                      - ref[r["id"]]["reg_norm"][r["answer"]]))
            if r["reg_output"] is not None else float("inf")
            for r in picked if ref[r["id"]]["needs_reg"]]
    return [("nsp_gap", nsp), ("answer_gap", choice),
            ("reg_gap", max(regs) if regs else 0.0)]


def as_served(ref_q) -> Dict[str, Any]:
    """A question as the reference in the program's place serves it."""
    p = ref_q["nsp_prob"]
    a = int(np.argmax(p))
    return {"probs": p, "answer": a, "confidence": float(p[a]),
            "reg_output": float(ref_q["reg_output"][a])}


def run(ctx) -> Dict[str, Any]:
    from crct_tpu_torch.train.eval_loop import resolve_eval_chunk
    mix, dev = ctx.mix, ctx.device
    ctx.phase("start")
    program.build_kernels(dev, ("attention_fwd",))
    ctx.phase("kernels")
    setup = Setup(ctx, ctx.seed)
    ctx.phase("pool")
    chunk = resolve_eval_chunk(setup.params)
    nb = len(setup.questions.batches)
    setup.evaluate(range(mix["warmup_batches"]))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup.reset()
    ctx.phase("warmup")
    setup_s = time.time() - ctx.t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    fed: List[int] = []
    t0 = time.perf_counter()

    def handed():
        while time.perf_counter() - t0 < ctx.seconds:
            fed.append(len(fed) % nb)
            yield fed[-1]

    setup.evaluate(handed())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    records = served(setup, fed, chunk)
    questions = len(records)
    rows = int(sum(len(r["probs"]) for r in records))
    failed = sum(1 for r in records if not np.isfinite(r["probs"]).all())
    out: Dict[str, Any] = {"attempted": questions, "failed": failed}
    out["e2e"] = {"eval_questions_per_s": questions / window_s,
                  "setup_s": setup_s}
    if ctx.trace:
        n = len(fed)
        trace = common.traced(lambda: setup.evaluate(
            [(n + i) % nb for i in range(mix["trace_batches"])]), dev,
            ctx.scratch)
        out["trace"] = trace
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else 0)
    if ctx.trace:
        out["per_layer"] = ctx.read_per_layer(
            {"ctx": ctx, "setup": setup, "trace": out["trace"],
             "questions": questions, "rows": rows, "window_s": window_s,
             "chunk": chunk, "batches": len(fed),
             "trace_batches": mix["trace_batches"]})

    picked = sample(records, ctx.seed, mix["check_questions"],
                    setup.questions.num_ans)
    del setup
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_scores(ctx, ctx.seed, [r["id"] for r in picked])
    out["checks"] = ctx.checks(gaps(picked, ref))
    out["correct"] = failed == 0
    return out


def calibrate(ctx, seeds):
    """The readings that set the limits, a dict a seed: the program over a
    short window of ``calibrate_batches`` loader batches against the
    reference, and in the program's place the reference in TF32 (the
    control) and the program with one answer altered (a fault), on the
    same questions. One model serves every seed, its weights reloaded."""
    program.build_kernels(ctx.device, ("attention_fwd",))
    model = None
    for seed in seeds:
        setup = Setup(ctx, seed, model)
        model = setup.model
        yield readings(ctx, seed, setup)


def readings(ctx, seed: int, setup: Setup) -> Dict[str, Any]:
    from crct_tpu_torch.train.eval_loop import resolve_eval_chunk
    chunk = resolve_eval_chunk(setup.params)
    fed = list(range(ctx.mix["calibrate_batches"]))
    setup.evaluate(fed)
    records = served(setup, fed, chunk)
    picked = sample(records, seed, ctx.mix["check_questions"],
                    setup.questions.num_ans)
    setup.reset()
    setup.hook.remove()
    ids = [r["id"] for r in picked]
    ref = reference_scores(ctx, seed, ids)
    tf32 = reference_scores(ctx, seed, ids, "tf32")
    control = [dict(as_served(tf32[q]), id=q) for q in ids]
    altered = [dict(r) for r in picked]
    altered[0]["answer"] = int(np.argmin(ref[altered[0]["id"]]["nsp_prob"]))
    return {"seed": seed, "program": dict(gaps(picked, ref)),
            "control_tf32": dict(gaps(control, ref)),
            "fault_answer_altered": dict(gaps(altered, ref))}
