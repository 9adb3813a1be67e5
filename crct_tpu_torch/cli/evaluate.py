"""Full evaluation CLI of the PyTorch port (reference CRCT/evaluation.py).

Evaluates on the card unless ``-device cpu`` is given:

    python -m crct_tpu_torch.cli.evaluate -qa_file qa_pairs_test.npy \\
        -dataset_config config/plotqa.json -eval_set test \\
        -start_checkpoint crct.ckpt [-cuda_num N] [-bf16]

``-start_checkpoint`` is one of the port's checkpoints, a reference
``crct.ckpt`` or a JAX package checkpoint (an Orbax directory; reading one
needs tensorstore, else convert it with ``cli.convert_checkpoint`` on a
host that has it), loaded in transfer mode: the parameters whose name and
shape match, the rest as initialized. Resumable: the question ids already in the result
CSV are left out of the index set and the accumulators reload from their
snapshots (reference evaluation.py:69-126,146-153). ``-predictions_out
answers.jsonl`` also writes one JSON record per question (answer,
cls_output, reg_output, confidence, gt_answer). ``-fast_scorer`` scores
through the fast-scorer head of a ``cli.train_fast_scorer`` checkpoint, and
``-fast_scorer_topk K`` rescores its K best candidates with the full model.

Over N cards, one process each: ``torchrun --nproc_per_node N -m
crct_tpu_torch.cli.evaluate ...``. Each rank scores its shard of the
questions and writes its own result CSV; the tables are summed over the
ranks, and ``-predictions_out`` is written per rank to ``<path>.rank{r}``.
"""

from __future__ import annotations

import json
import pprint

import numpy as np

from crct_tpu_torch import parallel
from crct_tpu_torch.config import read_command_line
from crct_tpu_torch.data.dataset import ChartQADataset, DataLoader
from crct_tpu_torch.models.crct import build_model
from crct_tpu_torch.train.eval_loop import (evaluate, get_prev_done_ids,
                                            make_histogram_png,
                                            print_acc_table,
                                            print_breakdown_table,
                                            resolve_eval_question_batch)
from crct_tpu_torch.utils.checkpoint import load_start_checkpoint
from crct_tpu_torch.utils.device import params_device


def load_eval_model(params, device):
    """The eval model on ``device`` with the weights of
    ``-start_checkpoint`` (else a deterministic init from ``-seed``)."""
    model = build_model(params, device=device)
    if params.get("start_checkpoint"):
        load_start_checkpoint(model, params["start_checkpoint"])
    n = sum(p.numel() for p in model.parameters())
    print(f"Model's parameters: {n}")
    return model


def main(argv=None):
    params = read_command_line(argv)
    parallel.maybe_initialize_distributed(params)
    device = params_device(params)
    pprint.pprint({k: v for k, v in params.items() if k != "dvqa_floats"})

    dataset = ChartQADataset(params, params["eval_set"],
                             init_split=params["eval_set"])
    dataset.get_all_answers = True

    done_ids = get_prev_done_ids(params)
    cont_eval = done_ids is not None
    indices = None
    if cont_eval:
        print("-" * 20, f"Done Ids: {len(done_ids)}", "-" * 20, flush=True)
        indices = np.array(sorted(set(range(len(dataset)))
                                  - set(done_ids.tolist())), np.int64)

    loader = DataLoader(dataset, batch_size=resolve_eval_question_batch(params),
                        shuffle=False, drop_last=False,
                        num_workers=params.get("num_workers", 8) or 1,
                        indices=indices,
                        # each rank its shard of the questions
                        # (DistributedSampler parity, evaluation.py:153)
                        num_shards=parallel.world_size(),
                        shard_index=parallel.rank())
    model = load_eval_model(params, device)

    on_predictions = pred_file = None
    if params.get("predictions_out"):
        path = params["predictions_out"]
        if parallel.world_size() > 1:    # one file a rank, like the CSVs
            path += f".rank{parallel.rank()}"
        pred_file = open(path, "a" if cont_eval else "w")

        def on_predictions(recs):
            for r in recs:
                pred_file.write(json.dumps(r, default=str) + "\n")
            pred_file.flush()

    try:
        total, breakdown, histogram = evaluate(
            loader, dataset, params, model,
            progress=params["eval_type"], csv=True, cont_eval=cont_eval,
            on_predictions=on_predictions)
    finally:
        loader.close()
        if pred_file is not None:
            pred_file.close()

    print_acc_table(print, total)
    if "plotqa" in params["dataset"]:
        print_breakdown_table(params, print, breakdown)
        if parallel.rank() == 0:    # one writer of the shared PNG
            make_histogram_png(params, histogram)
    print("Done evaluation", flush=True)
    return total, breakdown


if __name__ == "__main__":
    main()
