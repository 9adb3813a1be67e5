"""Shortlist miss rate of ``-fast_scorer_topk`` K in {4, 8, 16} (the port of
``tools/shortlist_miss_rate.py``).

The top-k mode's accuracy guarantee is conditional: its numerics are the
reference all-candidate protocol's (evaluation.py:243-262) whenever the true
answer makes the fast head's K-candidate shortlist, so its accuracy loss
equals the shortlist miss rate. This tool measures that miss rate on a
LEARNED task (the lexical-retrieval recipe of
tests/test_train.py::test_training_learns_retrieval_task: a from-scratch
tiny CRCT that learns the rule, then a fast-scorer head trained on the
frozen backbone), beside the end-to-end top-k accuracy through the real
``evaluate()`` for each K. It runs on the card (K1, K2 in the backbone's
training) unless ``--device cpu`` is given.

The recipe amplifies rounding-sized differences (tests/
test_torch_recipe.py): from one initial state a run may leave the NSP
plateau at ln 2 = 0.693 on one device and stay on it on another. The line
holds the backbone's mean loss over its last 50 steps and
``backbone_learned``, that loss under the JAX test's 0.45: the miss rates
of a backbone that learned nothing say nothing.

Usage: python -m crct_tpu_torch.tools.shortlist_miss_rate [--ks 4,8,16]
       [--backbone-steps 600] [--head-steps 200] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import numpy as np

# the recipe's model, tests/helpers.py::tiny_model_config with 32-d
# features and no dropout: the bench's tiny model with these changes
RECIPE = dict(vocab_size=600, v_feature_size=32, max_position_embeddings=128,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
              v_hidden_dropout_prob=0.0, v_attention_probs_dropout_prob=0.0)


def recipe_config():
    from crct_tpu_torch.bench import tiny_config
    return dataclasses.replace(tiny_config(), **RECIPE)


PLATEAU_LOSS = 0.45   # tests/test_train.py's limit on the tail loss


def recipe(root: str):
    """The recipe's params, its dataset (train and val splits of 16
    synthetic retrieval figures under ``root``) and six epochs of train
    batches, as the JAX test cycles them."""
    from crct_tpu_torch.config import default_params
    from crct_tpu_torch.data.dataset import ChartQADataset, DataLoader
    from crct_tpu_torch.data.synthetic import generate_dataset

    ds_cfg = generate_dataset(os.path.join(root, "data"), n_images=16,
                              division=8, n_questions=4, feat_dim=32,
                              task="retrieval")
    params = default_params(
        figure_feat_path=ds_cfg["figure_feat_path"],
        qa_parent_dir=ds_cfg["qa_parent_dir"], dataset_config=ds_cfg,
        max_vis_features=44, categories=228,
        save_path=os.path.join(root, "results"), batch_size=32,
        eval_batch_size=64, max_seq_len=96, lr=2e-3, image_lr=2e-3,
        min_lr=5e-4, warmup=60, num_workers=0)
    ds = ChartQADataset(params, ["train", "val"])
    ds.split = "train"
    loader = DataLoader(ds, batch_size=32, shuffle=True, drop_last=True,
                        num_workers=0)
    return params, ds, [b for _ in range(6) for b in loader]


def train_backbone(params, batches, device, steps: int):
    """The recipe's backbone trained ``steps`` steps on ``device``: the
    Trainer and its losses."""
    from crct_tpu_torch.models.crct import build_model
    from crct_tpu_torch.train.train_loop import Trainer

    trainer = Trainer(params, build_model(params, recipe_config(),
                                          device=device, train=True),
                      iters_per_epoch=30, device=device)
    losses = [trainer.run_step(batches[i % len(batches)])[0]
              for i in range(steps)]
    return trainer, [float(x) for x in losses]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ks", default="4,8,16")
    ap.add_argument("--backbone-steps", type=int, default=600,
                    help="the recipe's steps of the backbone")
    ap.add_argument("--head-steps", type=int, default=200,
                    help="the recipe's steps of the fast-scorer head")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    ks = [int(k) for k in args.ks.split(",")]

    from crct_tpu_torch.bench import Launches, card_info
    from crct_tpu_torch.data.dataset import DataLoader
    from crct_tpu_torch.models.crct import build_model
    from crct_tpu_torch.train.eval_loop import (build_fast_rows, evaluate,
                                                make_fast_eval_step,
                                                to_device)
    from crct_tpu_torch.train.fast_scorer_train import train_fast_scorer
    from crct_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)     # no card: raise before any work
    cfg = recipe_config()
    with tempfile.TemporaryDirectory() as td, Launches() as launched:
        # --- the learned retrieval task (test_train.py's recipe) ----------
        params, ds, batches = recipe(td)
        trainer, losses = train_backbone(params, batches, device,
                                         args.backbone_steps)
        tail_loss = float(np.mean(losses[-50:]))
        learned = tail_loss < PLATEAU_LOSS
        print(f"backbone trained: tail loss {tail_loss:.4f}"
              + ("" if learned else " (on the plateau: the miss rates "
                 "below say nothing)"), flush=True)

        # --- fast-scorer head on the frozen backbone ----------------------
        pf = dict(params, fast_scorer=True)
        model_f = build_model(pf, cfg, device=device)
        missing = model_f.load_state_dict(trainer.model.state_dict(),
                                          strict=False).missing_keys
        if not all(k.startswith("fast_scorer.") for k in missing):
            raise RuntimeError(f"backbone keys missing: {missing}")
        train_fast_scorer(pf, ds, model_f, steps=args.head_steps, lr=1e-3,
                          batch_questions=16, log_print=lambda s: None)
        print("fast head trained", flush=True)

        # --- shortlist recall: is the GT candidate in the fast top-K? -----
        def val_loader():
            ds.split = "val"
            ds.get_all_answers = True
            return DataLoader(ds, batch_size=8, shuffle=False,
                              drop_last=False, num_workers=0)

        fast_step = make_fast_eval_step(model_f)
        ranks = []
        for batch in val_loader():
            frows = build_fast_rows(batch)
            logits = fast_step(to_device(frows, device))[0]
            logits = logits.float().cpu().numpy()               # [B, P]
            logits = np.where(frows["cand_valid"] > 0, logits, -np.inf)
            gt = np.asarray(batch["gt_id"]).reshape(-1)
            order = np.argsort(-logits, axis=1, kind="stable")
            ranks.extend(int(np.where(order[b] == gt[b])[0][0])
                         for b in range(len(gt)))
        ranks = np.asarray(ranks)

        def eval_acc(extra):
            t, _, _ = evaluate(val_loader(), ds, dict(params, **extra),
                               model_f, csv=False, progress=False,
                               log_print=lambda m: None)
            ds.get_all_answers = False
            return float(t[0, 0] / t[0, 1])

        acc_full = eval_acc({})
        out = {"n_questions": int(len(ranks)),
               "backbone_tail_loss": tail_loss,
               "backbone_learned": learned,
               "full_protocol_accuracy": acc_full}
        rows_md = ["| K | shortlist miss rate | topk-K accuracy "
                   "| full-protocol accuracy |", "|---|---|---|---|"]
        for k in ks:
            miss = float((ranks >= k).mean())
            acc_k = eval_acc({"fast_scorer": True, "fast_scorer_topk": k})
            out[f"k{k}"] = {"miss_rate": miss, "topk_accuracy": acc_k}
            rows_md.append(f"| {k} | {miss:.3f} | {acc_k:.3f} "
                           f"| {acc_full:.3f} |")
            print(f"K={k}: miss={miss:.3f} acc={acc_k:.3f} "
                  f"(full {acc_full:.3f})", flush=True)
    print("\n".join(rows_md), flush=True)
    out.update(launches=launched.record, **card_info(device))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
