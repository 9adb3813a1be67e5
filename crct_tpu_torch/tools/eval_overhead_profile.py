"""Decompose real ``evaluate()`` wall time into host, transfer, dispatch and
compute (the port of ``tools/eval_overhead_profile.py``).

The measured protocol number (the bench's
``eval_protocol_questions_per_sec_per_chip_measured``) sits below the eval
step's row-throughput bound (``eval_candidate_rows_per_sec_per_chip`` over
the candidate fan-out). This tool runs the SAME synthetic setup as
``bench.bench_fast_topk8`` (flagship model, parameters in bf16) and times
each phase of the full-protocol dedup path explicitly, so the gap gets an
owner (the reference bottleneck being replaced: per-candidate sub-batches,
CRCT/evaluation.py:243-262).

Phases (full protocol, dedup), each closed by ``torch.cuda.synchronize()``:
  flatten   _flatten_valid_rows on the [B, 120, ...] loader batch (host)
  put_vis   per-question visual arrays -> the card
  pack      _chunk_rows slice + pad (host)
  put       the text chunk -> the card
  dispatch  the eval step (device compute + launches, K1)
  fetch     the 4 output vectors -> the host
  account   argmax, reducers, accumulators (host)

Closing every phase serializes the pipeline the real loop overlaps, so the
sum can exceed the end-to-end time: each number is an upper bound on that
phase's cost, and the e2e line (the median of timed ``evaluate()`` passes)
is what the bench sees.

Usage: python -m crct_tpu_torch.tools.eval_overhead_profile [--questions 240]
       [--device cpu] [--tiny]
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch

PHASES = ("flatten", "put_vis", "pack", "put", "dispatch", "fetch",
          "account")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--questions", type=int, default=240)
    ap.add_argument("--passes", type=int, default=3,
                    help="timed evaluate() passes (their median is e2e_s)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny model and 24-row chunks (the CPU)")
    args = ap.parse_args(argv)

    from crct_tpu_torch import bench
    from crct_tpu_torch.config import CRCTModelConfig
    from crct_tpu_torch.train import eval_loop as el
    from crct_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)     # no card: raise before any work
    cfg = bench.tiny_config() if args.tiny else CRCTModelConfig()
    cfg.dtype = "bfloat16"
    with tempfile.TemporaryDirectory() as td:
        params, ds = bench.synthetic_eval_setup(
            td, cfg, args.questions, 24 if args.tiny else None)
        t0 = time.perf_counter()
        batches = bench.materialize(ds, 120)
        t_mat = time.perf_counter() - t0
        n_q = bench.n_questions(batches)
        print(f"[setup] {n_q} questions in {len(batches)} loader batches, "
              f"materialize {t_mat:.2f}s", flush=True)
        model = bench.eval_model(cfg, device, seed=4)
        chunk = el.resolve_eval_chunk(params)
        step = el.make_eval_step_dedup(model)
        bf16 = model.compute_dtype == torch.bfloat16
        T = {k: 0.0 for k in PHASES}
        n_chunks = 0

        def phase(name, t):
            bench.sync(device)
            T[name] += time.perf_counter() - t
            return time.perf_counter()

        def run_instrumented():
            nonlocal n_chunks
            qb_pad = max(np.asarray(b["tokens"]).shape[0] for b in batches)
            for batch in batches:
                ids = np.asarray(batch["id"]).reshape(-1)
                t = time.perf_counter()
                rows, offsets = el._flatten_valid_rows(
                    batch, keys=el.EVAL_TEXT_KEYS)
                qidx = np.repeat(np.arange(len(ids), dtype=np.int64),
                                 np.diff(offsets).astype(np.int64))
                t = phase("flatten", t)
                vis = {}
                for k in el.EVAL_VIS_KEYS:
                    if k not in batch:
                        continue
                    v = np.asarray(batch[k])[:, 0]
                    if qb_pad > len(ids):
                        v = np.concatenate([v, np.zeros(
                            (qb_pad - len(ids),) + v.shape[1:], v.dtype)])
                    v = torch.from_numpy(np.ascontiguousarray(v))
                    if k == "image_feat" and bf16:
                        v = v.to(torch.bfloat16)
                    vis[k] = v.to(device, non_blocking=True)
                t = phase("put_vis", t)
                # materialized so the slice + pad cost lands in 'pack'
                chunks = list(el._chunk_rows(dict(rows, _qidx=qidx), chunk))
                t = phase("pack", t)
                pending = []
                for piece, valid in chunks:
                    n_chunks += 1
                    q = piece.pop("_qidx")
                    piece = el.to_device(piece, device)
                    t = phase("put", t)
                    outs = step(piece, vis, q)
                    t = phase("dispatch", t)
                    pending.append((outs, valid))
                coll = None
                for outs, valid in pending:
                    outs = [o[:valid].float().cpu().numpy() for o in outs]
                    if coll is None:
                        coll = [[] for _ in outs]
                    for acc, o in zip(coll, outs):
                        acc.append(o)
                nsp_probs, _, reg5, regl1 = [np.concatenate(a)
                                             for a in coll]
                t = phase("fetch", t)
                gt_id = np.asarray(batch["gt_id"]).reshape(-1)
                needs_reg = np.asarray(batch["needs_reg"]).reshape(
                    len(ids), -1)[:, 0].astype(bool)
                answers_idx = el.segmented_argmax(nsp_probs, offsets)
                starts = offsets[:-1].astype(np.int64)
                sel = np.minimum(starts + answers_idx,
                                 max(len(nsp_probs) - 1, 0))
                nonempty = np.diff(offsets) > 0
                reg_right = (np.where(nonempty, reg5[sel], np.inf)
                             <= 0.05) & needs_reg
                tol = np.asarray(batch["tolerance_margin"]).reshape(
                    len(ids), -1)[:, 0]
                reg_t_right = (np.where(nonempty, regl1[sel], np.inf)
                               <= tol) & needs_reg
                nsp_right = (answers_idx == gt_id) & nonempty
                el.reduce_total_acc(np.zeros((6, 2)), needs_reg, nsp_right,
                                    reg_right, reg_t_right)
                el.reduce_breakdown(np.zeros((5, 4, 3, 3)), ds, batch,
                                    nsp_right & (~needs_reg | reg_right),
                                    nsp_right & (~needs_reg | reg_t_right),
                                    needs_reg)
                phase("account", t)

        run_instrumented()          # warm-up pass
        for k in T:
            T[k] = 0.0
        n_chunks = 0
        with bench.Launches() as launched:
            t_instr = bench.windows(run_instrumented, 1, device)[0]

        # ---- unblocked end to end through the REAL evaluate() ------------
        def run():
            el.evaluate(batches, ds, dict(params), model, csv=False,
                        log_print=lambda m: None)

        run()
        out = {"questions": n_q, "chunks": n_chunks, "chunk_rows": chunk}
        e2e = bench.put_median(out, "e2e_s",
                               bench.windows(run, args.passes, device))
        out.update(e2e_q_per_s=n_q / e2e, instrumented_s=t_instr,
                   phases_s=T, launches=launched.record,
                   **bench.card_info(device))
        print(json.dumps(out), flush=True)
        return out


if __name__ == "__main__":
    main()
