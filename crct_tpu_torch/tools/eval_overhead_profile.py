"""Decompose real ``evaluate()`` wall time into host, transfer, dispatch and
compute (the port of ``tools/eval_overhead_profile.py``).

The measured protocol number (the bench's
``eval_protocol_questions_per_sec_per_chip_measured``) sits below the eval
step's row-throughput bound (``eval_candidate_rows_per_sec_per_chip`` over
the candidate fan-out). This tool runs the SAME synthetic setup as
``bench.bench_fast_topk8`` (flagship model, parameters in bf16) through the
real ``evaluate()`` with the tracer on (``utils/tracing``) and sums the
spans of each phase of the full-protocol dedup path, so the gap gets an
owner (the reference bottleneck being replaced: per-candidate sub-batches,
CRCT/evaluation.py:243-262).

Phases (the ``eval.*`` spans, full protocol, dedup):
  flatten   _flatten_valid_rows on the [B, 120, ...] loader batch (host)
  put_vis   per-question visual arrays -> the card
  pack      _chunk_rows slice + pad (host)
  put       the text chunk -> the card
  dispatch  the eval step's gather and launches (K1)
  fetch     the 4 output vectors -> the host
  account   argmax, reducers, accumulators (host)

No phase is closed by a synchronize: the card's compute shows in the phase
where the host first waits for it, ``fetch`` or, where the model's forward
makes a blocking copy, ``dispatch``. The phases of the traced pass sum to
its wall time less the loader's and the loop's own, and the e2e line (the
median of untraced ``evaluate()`` passes) is what the bench sees.

Usage: python -m crct_tpu_torch.tools.eval_overhead_profile [--questions 240]
       [--device cpu] [--tiny]
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

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
    from crct_tpu_torch.utils import tracing
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

        def run():
            el.evaluate(batches, ds, dict(params), model, csv=False,
                        log_print=lambda m: None)

        run()                       # warm-up pass
        tracing.enable()
        try:
            with bench.Launches() as launched:
                t_instr = bench.windows(run, 1, device)[0]
        finally:
            tracing.disable()
        spans = tracing.drain()["spans"]
        T = {k: sum(s["end_ns"] - s["start_ns"] for s in spans
                    if s["name"] == "eval." + k) / 1e9 for k in PHASES}
        n_chunks = sum(s["name"] == "eval.dispatch" for s in spans)
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
