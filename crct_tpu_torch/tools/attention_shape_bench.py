"""Per-shape attention path comparison inside the real steps (the port of
``tools/attention_shape_bench.py``).

The JAX tool compares XLA's attention path with the Pallas kernels'. Here,
at each of its shapes, the flagship model's real steps (``make_eval_step``
with the parameters in bf16, ``make_train_step`` under bf16 autocast at
batch 80) run through K1 and K2 in the two modes that stand for those
paths: ``kernels`` in the default mode (the XLA path's numerics, P rounded
to bf16), ``pallas`` in the Pallas path's (P fp32 through P.V); then
through the plain attention (``ops.attention.plain_attention`` in the
default mode, what the kernels are held against) in the same steps, and
through SDPA (``scaled_dot_product_attention``), a library yardstick that
the port never calls. The attention core is swapped at
``models.layers.fused_attention`` for every run but the first and put back
after each. SDPA's dropout draws its own mask: the step costs the same.

Each entry is rows/s: the median of ``--repeats`` windows of ``--steps``
steps, each window between two synchronizes, after a warm-up step; the
paths' windows are taken in turns, in an order reversed every round.

Usage: python -m crct_tpu_torch.tools.attention_shape_bench [--steps 20]
       [--shapes eval_chunk_480,...] [--device cpu] [--tiny]
"""
from __future__ import annotations

import argparse
import json
from collections import Counter
from unittest import mock

import numpy as np
import torch

# (name, kind, rows)
SHAPES = [
    ("eval_chunk_480", "eval", 480),   # the bench's eval chunk
    ("eval_b120", "eval", 120),        # one 120-candidate question
    ("serve_b8", "eval", 8),           # a small interactive serving batch
    ("train_b80", "train", 80),        # the reference train batch
]


def sdpa_attention(q, k, v, additive_mask, dropout_rate: float = 0.0,
                   seed: int = 0, mode: str = ""):
    """``fused_attention``'s signature over torch's SDPA (the yardstick; it
    has one numerics, whatever the mode)."""
    mask = None if additive_mask is None else additive_mask.to(q.dtype)
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, dropout_p=dropout_rate)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--shapes", default="",
                    help="comma-separated subset of " +
                         ",".join(s[0] for s in SHAPES))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny model at an eighth of the rows (the CPU)")
    args = ap.parse_args(argv)

    from crct_tpu_torch import bench
    from crct_tpu_torch.config import CRCTModelConfig
    from crct_tpu_torch.models import layers
    from crct_tpu_torch.ops.attention import PALLAS, plain_attention
    from crct_tpu_torch.train.eval_loop import make_eval_step, to_device
    from crct_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)     # no card: raise before any work
    cfg = bench.tiny_config() if args.tiny else CRCTModelConfig()
    cfg.dtype = "bfloat16"
    shapes = SHAPES
    if args.shapes:
        keep = set(args.shapes.split(","))
        shapes = [s for s in SHAPES if s[0] in keep]
    kernels = layers.fused_attention

    def pallas(*args, mode=None, **kwargs):
        """K1 and K2 in the Pallas path's mode, whatever the model's."""
        return kernels(*args, mode=PALLAS, **kwargs)

    paths = {"kernels": kernels, "pallas": pallas, "plain": plain_attention,
             "sdpa": sdpa_attention}
    rng = np.random.default_rng(0)
    results = {}
    for name, kind, rows in shapes:
        B = max(2, rows // 8) if args.tiny else rows
        batch = bench._synthetic_step_batch(
            rng, B=B, L=124, R=44, vdim=cfg.v_feature_size,
            vocab=cfg.vocab_size, cats=228)
        if kind == "eval":
            model = bench.eval_model(cfg, device, seed=0)
            eval_rows = to_device({k: v for k, v in batch.items()
                                   if k != "next_sentence_labels"}, device)
            eval_step = make_eval_step(model)

            def step():
                eval_step(eval_rows)
        else:
            # a fresh model and optimizer; its state dies with the shape
            model, _, train_step, db, generator = bench.train_state(
                cfg, device, B)

            def step():
                train_step(db, generator)

        # each path's warm-up, then its windows in turns with the others'
        # (the order reversed every other round), so that a drift of the
        # host or the card over the shape's run biases no path
        seconds = {path: [] for path in paths}
        launched = {path: Counter() for path in paths}
        for r in range(-1, args.repeats):
            for path in list(paths)[::1 if r % 2 else -1]:
                with mock.patch.object(layers, "fused_attention",
                                       paths[path]), \
                        bench.Launches() as counted:
                    if r < 0:
                        step()
                    else:
                        seconds[path] += bench.windows(
                            lambda: [step() for _ in range(args.steps)], 1,
                            device)
                launched[path].update({k: counted.record[k]
                                       for k in ("k1", "k2")})
        res = {}
        for path in paths:
            bench.put_median(res, path, [B * args.steps / s
                                         for s in seconds[path]])
            res[f"{path}_ms_per_step"] = float(np.median(seconds[path])) \
                / args.steps * 1e3
            res[f"{path}_launches"] = {k: launched[path][k]
                                       for k in ("k1", "k2")}
            print(f"{name:16s} {path:8s} {res[path]:9.1f} rows/s "
                  f"({res[f'{path}_ms_per_step']:7.2f} ms/step)", flush=True)
        res["pallas_over_kernels"] = res["pallas"] / res["kernels"]
        res["kernels_over_plain"] = res["kernels"] / res["plain"]
        res["kernels_over_sdpa"] = res["kernels"] / res["sdpa"]
        res["rows"] = B
        results[name] = res
        del model, step
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out = {"shapes": results, **bench.card_info(device)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
