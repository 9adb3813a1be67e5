"""Sweep the auto eval row chunk through the REAL ``evaluate()`` (the port of
``tools/eval_chunk_sweep.py``).

The auto default (``eval_loop.EVAL_AUTO_ROWS_PER_CARD``) sets the rows of
every eval dispatch. This sweeps chunk in {120, 240, 480, 960} through
``evaluate()`` on the full reference protocol (the synthetic flagship setup
of ``bench.bench_fast_topk8``, parameters in bf16, K1 on the card), letting
``resolve_eval_question_batch`` follow each chunk as the default CLI would,
and prints a table with the winner. The reference analogue of this economics
is the per-candidate fan-out loop, CRCT/evaluation.py:243-262. Each chunk's
rate is the median of ``--repeats`` timed passes after an untimed one; the
accuracy tables of every chunk are compared with the first's
(``tables_equal``): a chunk changes the dispatches, never the answers.

Usage: python -m crct_tpu_torch.tools.eval_chunk_sweep [--questions 240]
       [--chunks 120,240,480,960] [--device cpu] [--tiny]
"""
from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--questions", type=int, default=240)
    ap.add_argument("--chunks", default="120,240,480,960")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed passes per chunk size (their median)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny model (the CPU)")
    args = ap.parse_args(argv)
    chunk_list = [int(c) for c in args.chunks.split(",")]

    from crct_tpu_torch import bench
    from crct_tpu_torch.config import CRCTModelConfig
    from crct_tpu_torch.train import eval_loop as el
    from crct_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)     # no card: raise before any work
    cfg = bench.tiny_config() if args.tiny else CRCTModelConfig()
    cfg.dtype = "bfloat16"
    auto = el.EVAL_AUTO_ROWS_PER_CARD
    with tempfile.TemporaryDirectory() as td:
        params, ds = bench.synthetic_eval_setup(td, cfg, args.questions,
                                                None)
        model = bench.eval_model(cfg, device, seed=4)
        table, first = [], None
        try:
            for chunk in chunk_list:
                el.EVAL_AUTO_ROWS_PER_CARD = chunk
                # the loader batch follows the chunk as the default CLI's
                q_batch = el.resolve_eval_question_batch(params)
                batches = bench.materialize(ds, q_batch)
                n_q = bench.n_questions(batches)
                tables = []

                def run():
                    tables.append(el.evaluate(
                        batches, ds, dict(params), model, csv=False,
                        log_print=lambda m: None))

                run()                                  # untimed pass
                with bench.Launches() as launched:
                    seconds = bench.windows(run, max(1, args.repeats),
                                            device)
                row = {"chunk": chunk, "loader_batch": q_batch,
                       "questions": n_q}
                bench.put_median(row, "questions_per_sec_per_chip",
                                 [n_q / s for s in seconds])
                row["k1_launches"] = launched.record["k1"]
                first = first or tables[0]
                row["tables_equal"] = all(
                    all(np.array_equal(a, b) for a, b in zip(t, first))
                    for t in tables)
                table.append(row)
                print(json.dumps(row), flush=True)
        finally:
            el.EVAL_AUTO_ROWS_PER_CARD = auto
    winner = max(table, key=lambda r: r["questions_per_sec_per_chip"])
    out = {"winner_chunk": winner["chunk"], "table": table,
           "tables_equal": all(r["tables_equal"] for r in table),
           **bench.card_info(device)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
