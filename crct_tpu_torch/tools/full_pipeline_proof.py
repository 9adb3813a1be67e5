"""Pixels -> accuracy, end to end, with learning in both stages (the port
of ``tools/full_pipeline_proof.py``).

Chains the port's CLIs on synthetic charts, with the JAX tool's flags and
seeds, on the card unless ``--device cpu`` is given:

  1. render chart images + plotqa-schema annotations + QA pairs
     (``detector/synthetic_charts.generate_png_dataset``)
  2. ``cli.detector_train`` - train Mask R-CNN on the charts' COCO boxes
     (the RoIAlign backward through K3 on the card)
  3. ``cli.extract_features`` - trained-detector visual features + GT-text
     oracle -> ``.npy`` feature shards
  4. ``cli.train`` - train the CRCT QA model on the extracted features
     (attention through K1 and K2)
  5. ``cli.evaluate`` - held-out-split accuracy table (K1)

The QA answers (bar counts, per-category values) are only recoverable from
what the detector found, so above-chance held-out accuracy is an
end-to-end proof that the two-stage pipeline learns from pixels.

Prints one JSON line: the JAX tool's fields (held-out accuracy beside
chance), the whole run's seconds and, per stage, its seconds and the
launches of K1, K2 and K3.

Usage: python -m crct_tpu_torch.tools.full_pipeline_proof [--fast]
       [--device cpu]
(--fast = smoke sizes, which prove the plumbing, not learning)
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile
import time

import numpy as np

TINY_MODEL = {
    "vocab_size": 30522, "hidden_size": 64, "num_hidden_layers": 4,
    "num_attention_heads": 4, "intermediate_size": 128,
    "v_feature_size": 1024, "v_hidden_size": 32, "v_num_hidden_layers": 2,
    "v_num_attention_heads": 2, "v_intermediate_size": 32,
    "bi_hidden_size": 32, "bi_num_attention_heads": 4,
    "v_biattention_id": [0, 1], "t_biattention_id": [2, 3],
    "max_position_embeddings": 512, "plotqa_vocab_types": 12,
    "pooling_method": "mul",
}


class _Stage:
    """Seconds and kernel launches of one stage, into ``stages[name]``."""

    def __init__(self, stages, name):
        self.stages, self.name = stages, name

    def __enter__(self):
        from crct_tpu_torch.ops import attention, roi_align_kernel
        self.counts = (attention.launch_count(),
                       attention.bwd_launch_count(),
                       roi_align_kernel.launch_count())
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from crct_tpu_torch.ops import attention, roi_align_kernel
        now = (attention.launch_count(), attention.bwd_launch_count(),
               roi_align_kernel.launch_count())
        self.stages[self.name] = {
            "seconds": time.perf_counter() - self.t0,
            **{k: b - a for k, a, b in zip(("k1", "k2", "k3"), self.counts,
                                            now)}}
        print(f"[proof] {self.name}: {self.stages[self.name]}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="smoke sizes (minutes); accuracy then only "
                         "proves plumbing, not learning")
    ap.add_argument("--root", default="", help="work dir (default: tmp)")
    ap.add_argument("--det-iters", type=int, default=0)
    ap.add_argument("--qa-epochs", type=int, default=0)
    ap.add_argument("--fast-nms", action="store_true",
                    help="train the detector with the parallel train-time "
                         "NMS")
    ap.add_argument("--score-thresh", type=float, default=0.0,
                    help="override the --ocr extraction score threshold "
                         "(default 0.05 for --ocr)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default) or the CPU")
    ap.add_argument("--ocr", action="store_true",
                    help="extract with --OCR (text read from the pixels) "
                         "instead of the GT-text oracle")
    args = ap.parse_args(argv)
    if args.ocr and args.fast_nms:
        ap.error("--ocr and --fast-nms change different stages; run them "
                 "separately so each result isolates one variable")

    from crct_tpu_torch.utils.device import resolve_device
    resolve_device(args.device)            # no card: raise before any work
    n_train, n_test = (8, 4) if args.fast else (48, 16)
    det_iters = args.det_iters or (12 if args.fast else 200)
    qa_epochs = args.qa_epochs or (1 if args.fast else 8)
    dev = ["--device", args.device]
    stages = {}
    t_start = time.perf_counter()

    root = args.root or tempfile.mkdtemp(prefix="e2e_proof_")
    print(f"[proof] work dir {root}", flush=True)
    from crct_tpu_torch.detector.synthetic_charts import generate_png_dataset
    with _Stage(stages, "charts"):
        train_env = generate_png_dataset(os.path.join(root, "charts"),
                                         n_images=n_train, seed=0,
                                         split="train")
        test_env = generate_png_dataset(os.path.join(root, "charts"),
                                        n_images=n_test, seed=1000,
                                        split="test")

    # ---- stage 1: detector training on the charts' COCO boxes ----------
    # stages skip when their outputs already exist, so an interrupted run
    # resumes with the same --root
    det_out = os.path.join(root, "detector")
    det_ckpt = os.path.join(det_out, f"detector_{det_iters}.ckpt")
    with _Stage(stages, "detector_train"):
        if os.path.exists(det_ckpt):
            print(f"[proof] {det_ckpt} exists - skipping detector training",
                  flush=True)
        else:
            print(f"[proof] training detector ({det_iters} iters)...",
                  flush=True)
            from crct_tpu_torch.cli.detector_train import main as det_main
            det_main(["--dataset", "plotqa",
                      "--annotations", train_env["coco"],
                      "--image-dir", train_env["png_dir"],
                      "--image-size", "320", "--batch-size", "2",
                      "--depth", "14",
                      "--max-iter", str(det_iters),
                      "--checkpoint-every", str(det_iters),
                      "--max-boxes", "40", "--output-dir", det_out]
                     + (["--fast-nms"] if args.fast_nms else []) + dev)
    assert os.path.exists(det_ckpt), det_ckpt

    # ---- stage 2: feature extraction with the trained detector ---------
    from crct_tpu_torch.cli.extract_features import main as ext_main
    feat_root = os.path.join(root, "fig_features")
    with _Stage(stages, "extract_features"):
        for split in ("train", "test"):
            if glob.glob(os.path.join(feat_root, split, "*.npy")):
                print(f"[proof] {split} feature shards exist - skipping "
                      "extraction", flush=True)
                continue
            print(f"[proof] extracting {split} features "
                  f"({'real OCR' if args.ocr else 'GT-text oracle'})...",
                  flush=True)
            ext_main(["--load-weights", det_ckpt,
                      "--dir-path", os.path.join(root, "charts"),
                      "--split", split,
                      "--output", os.path.join(feat_root, split),
                      "--batch-size", "64",
                      "--OCR" if args.ocr else "--ocr-gt",
                      "--dataset", "plotqa",
                      "--num-classes", "16", "--depth", "14",
                      "--image-size", "320",
                      "--short-edge", "0", "--infer-batch", "4"]
                     + (["--score-thresh",
                         str(args.score_thresh or 0.05)] if args.ocr else [])
                     + dev)

    # ---- stage 3+4: QA train on train split, evaluate on test ----------
    qa_root = os.path.join(root, "QA")
    for split, env in (("train", train_env), ("test", test_env)):
        os.makedirs(os.path.join(qa_root, split), exist_ok=True)
        qa = np.load(env["qa_file"], allow_pickle=True)
        np.save(os.path.join(qa_root, split, "qa_pairs.npy"), qa,
                allow_pickle=True)
    with open(os.path.join(root, "tiny_model.json"), "w") as f:
        json.dump(TINY_MODEL, f)
    ds_cfg = {
        "dataset": "plotqa", "categories": 228, "max_vis_features": 44,
        "max_seq_len": 124, "binary_answers": False,
        "main_folder": root + "/",
        "model_config": "tiny_model.json", "save_path": "results/",
        "figure_feat_path": "fig_features/", "qa_parent_dir": "QA/",
        "tensorboard": "", "checkpoints_dir": "results/",
        "dataset_files_divisions": {"train": 64, "test": 64},
        "splits": ["train", "train", "test"],
    }
    with open(os.path.join(root, "ds.json"), "w") as f:
        json.dump(ds_cfg, f)

    print(f"[proof] training QA model ({qa_epochs} epochs)...", flush=True)
    from crct_tpu_torch.cli.train import main as train_main
    with _Stage(stages, "train"):
        train_main(["-qa_file", "qa_pairs.npy", "-dataset_config",
                    os.path.join(root, "ds.json"), "-batch_size", "8",
                    "-num_epochs", str(qa_epochs), "-num_workers", "1",
                    "-save_name", "qa", "-no_eval", "-lr", "2e-4",
                    "-min_lr", "2e-4", "-warmup", "10",
                    "-device", args.device])
    cks = sorted(glob.glob(os.path.join(root, "results", "qa", "*.ckpt")),
                 key=os.path.getmtime)
    assert cks, "QA training saved no checkpoint"

    print("[proof] evaluating on the held-out split...", flush=True)
    from crct_tpu_torch.cli.evaluate import main as eval_main
    with _Stage(stages, "evaluate"):
        total, _ = eval_main(["-qa_file", "qa_pairs.npy", "-dataset_config",
                              os.path.join(root, "ds.json"), "-eval_set",
                              "test", "-save_name", "qa_eval",
                              "-eval_batch_size", "64",
                              "-num_workers", "1",
                              "-start_checkpoint", cks[-1],
                              "-device", args.device])

    # headline = the protocol's strict Total Accuracy row (row 4):
    # cls-right AND (not-reg OR reg within 5%); row 0 (cls only) and row 5
    # (tolerance) reported beside it
    n_q = float(total[4, 1])
    acc = float(total[4, 0]) / max(n_q, 1.0)
    acc_cls = float(total[0, 0]) / max(float(total[0, 1]), 1.0)
    acc_tol = float(total[5, 0]) / max(float(total[5, 1]), 1.0)
    # chance: picking uniformly among each question's candidates
    from crct_tpu_torch.config import default_params
    from crct_tpu_torch.data.dataset import ChartQADataset
    params = default_params(
        figure_feat_path=os.path.join(root, "fig_features") + "/",
        qa_parent_dir=os.path.join(root, "QA") + "/",
        dataset_config={"dataset_files_divisions":
                        ds_cfg["dataset_files_divisions"]},
        splits=["train", "train", "test"], eval_set="test",
        save_path=os.path.join(root, "results"))
    ds = ChartQADataset(params, ["test"], init_split="test")
    chance = float(np.mean(
        [1.0 / max(1, len(ds.get_possible_answers(
            int(q["image_index"])))) for q in ds.qa["test"]]))
    result = {"e2e_learned_heldout_accuracy": round(acc, 4),
              "cls_only_accuracy": round(acc_cls, 4),
              "tolerance_accuracy": round(acc_tol, 4),
              # candidate-uniform chance: an upper bound on chance for the
              # strict metric (a random reg value almost never lands
              # within 5%), so acc > chance is conservative evidence
              "chance": round(chance, 4),
              "questions": int(n_q), "det_iters": det_iters,
              "qa_epochs": qa_epochs, "charts_train": n_train,
              "charts_test": n_test, "fast": bool(args.fast),
              "fast_nms": bool(args.fast_nms), "ocr": bool(args.ocr),
              "device": args.device,
              "root": root, "seconds": time.perf_counter() - t_start,
              "stages": stages}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
