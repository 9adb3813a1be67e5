"""Opt-in training-recipe variants of the headline step (the port of
``tools/opt_variant_bench.py``).

Times the same flagship train step as the bench's headline (batch 80 a
card, bf16 autocast over fp32 masters, PlotQA shapes, K1 and K2) under:

    --opt-bf16-m   bf16 AdamW first moments (-opt_bf16_m)
    --dropout0     every dropout probability 0 (a model-config change the
                   user can make in vilbert.json; NOT the reference recipe)

Prints one JSON line: the variant, the step's ms and QA pairs/s/card
(medians of ``--repeats`` windows of ``--steps`` steps, with their
quartiles), the analytic MFU against the card's bf16 peak, and the K1 and
K2 launches of the timed windows.

Usage: python -m crct_tpu_torch.tools.opt_variant_bench [--opt-bf16-m]
       [--dropout0] [--steps 20] [--device cpu] [--tiny]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--opt-bf16-m", action="store_true")
    ap.add_argument("--dropout0", action="store_true")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps a timed window (default: the bench's 20)")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny model at batch 4 (the CPU)")
    args = ap.parse_args(argv)

    from crct_tpu_torch import bench
    from crct_tpu_torch.config import CRCTModelConfig
    from crct_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)     # no card: raise before any work
    cfg = bench.tiny_config() if args.tiny else CRCTModelConfig()
    cfg.dtype = "bfloat16"
    if args.dropout0:
        cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
        cfg.v_hidden_dropout_prob = cfg.v_attention_probs_dropout_prob = 0.0
    batch = 4 if args.tiny else bench.BATCH_PER_CHIP
    steps = args.steps or (1 if args.tiny else bench.MEASURE_STEPS)
    with bench.Launches() as launched:
        out, _ = bench.bench_train(cfg, device, batch=batch, steps=steps,
                                   repeats=args.repeats,
                                   opt_bf16_m=args.opt_bf16_m)
    qps = out.pop("value")
    result = {
        "variant": {"opt_bf16_m": args.opt_bf16_m,
                    "dropout0": args.dropout0},
        "train_step_ms": out["train_step_ms"],
        "qa_pairs_per_sec_per_chip": qps,
        "spread": {"qa_pairs_per_sec_per_chip": out["spread"]["value"],
                   "train_step_ms": out["spread"]["train_step_ms"]},
        "launches": launched.record,
        **bench.card_info(device),
    }
    if device.type == "cuda":
        peak = bench.peak_tflops(result["device_name"])["bfloat16"]
        result["mfu_pct_h100_bf16_analytic"] = (
            100.0 * bench.analytic_train_flops(B=batch) * (qps / batch)
            / 1e12 / peak)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
