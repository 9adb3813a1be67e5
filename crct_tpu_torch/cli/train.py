"""Training entry point of the PyTorch port (reference CRCT/train.py).

Trains on the card unless ``-device cpu`` is given:

    python -m crct_tpu_torch.cli.train -qa_file qa_pairs_V1_train.npy \\
        -dataset_config config/plotqa.json -batch_size 80 -bf16

``-cuda_num N`` picks the card. Data parallelism runs one process per
card, started by torchrun (or by hand with ``-dist_url tcp://host:port
-world_size N -rank r``), each on ``-batch_size`` rows a step:

    torchrun --nproc_per_node 4 -m crct_tpu_torch.cli.train -ddp \
        -qa_file qa_pairs_V1_train.npy -dataset_config config/plotqa.json \
        -batch_size 80 -bf16

``-mesh_shape``, when given, must equal the world size. After each epoch
the model is evaluated on at most 500 questions of ``-eval_set`` by the full
protocol, each rank scoring its shard of them (``-no_eval`` skips it). With
``-fast_scorer`` the trained model has no fast-scorer head, as in the JAX
trainer: the head trains afterwards (``cli.train_fast_scorer``).
``-start_checkpoint`` takes the port's own epoch checkpoints, a reference
``crct.ckpt`` (or ``cli.import_bert``'s text stream) or a JAX package
checkpoint (an Orbax directory, read with tensorstore), in transfer mode:
the parameters whose name and shape match, the rest as initialized. With
``-continue`` it also restores the optimizer state (the JAX optimizer's
too, ``-opt_bf16_m`` and ``-batch_multiply`` included), the step and the
epoch after the one in the checkpoint's name.
"""

from __future__ import annotations

import pprint

import numpy as np

from crct_tpu_torch import parallel
from crct_tpu_torch.config import read_command_line
from crct_tpu_torch.data.dataset import ChartQADataset, DataLoader
from crct_tpu_torch.train.eval_loop import (evaluate, print_acc_table,
                                            print_breakdown_table,
                                            resolve_eval_question_batch)
from crct_tpu_torch.train.train_loop import _maybe_tensorboard, run_training
from crct_tpu_torch.utils.device import params_device
from crct_tpu_torch.utils.logging import log_line

def in_train_eval(trainer, dataset, epoch_id):
    """<=500-sample validation eval each epoch (reference train.py:294-338),
    on the training model (scored in eval mode in its compute dtype). Each
    rank scores its shard of the sample and the tables are summed over the
    ranks: the totals of one process that scores them all."""
    params = dict(trainer.params_dict)
    # in-train eval always uses the reference protocol: a training model
    # has no fast-scorer head
    params["fast_scorer"] = False
    dataset.split = params["eval_set"]
    dataset.get_all_answers = True
    rng = np.random.default_rng(params.get("seed", 0) + epoch_id)
    idx = rng.permutation(len(dataset))[:500]
    loader = DataLoader(dataset, batch_size=resolve_eval_question_batch(params),
                        shuffle=False, num_workers=params.get("num_workers", 8) or 1,
                        drop_last=False, indices=idx,
                        num_shards=parallel.world_size(),
                        shard_index=parallel.rank())
    try:
        total, breakdown, _ = evaluate(
            loader, dataset, params, trainer.model,
            csv=False, log_print=lambda m: log_line(params, m))
    finally:
        loader.close()
    print_acc_table(lambda m: log_line(params, m), total)
    if params["dataset"] != "figure_qa":
        print_breakdown_table(params, lambda m: log_line(params, m), breakdown)
    dataset.get_all_answers = False
    _tb_eval_scalars(trainer, params, total, epoch_id)
    return total


def _tb_eval_scalars(trainer, params, total, epoch_id):
    """Per-epoch eval scalars + hparams (reference train.py:340-350)."""
    writer = _maybe_tensorboard(params)
    if writer is None:
        return

    def frac(row):
        return float(total[row, 0] / total[row, 1]) if total[row, 1] else 0.0
    writer.add_scalar("Accuracy/Eval Total Acc", frac(4), epoch_id)
    writer.add_scalar("Accuracy/Eval Reg Acc", frac(2), epoch_id)
    writer.add_scalar("Accuracy/Eval nsp Acc", frac(0), epoch_id)
    hparams = {k: v for k, v in params.items()
               if isinstance(v, (int, float, str, bool))}
    try:
        writer.add_hparams(hparams, {"hparam/Eval_acc": frac(4)})
    except Exception:
        pass
    writer.flush()


def main(argv=None):
    params = read_command_line(argv)
    parallel.maybe_initialize_distributed(params)
    if params.get("mesh_shape") and \
            int(params["mesh_shape"]) != parallel.world_size():
        raise SystemExit(f"-mesh_shape {params['mesh_shape']} but the world "
                         f"has {parallel.world_size()} ranks: one rank "
                         f"drives one card")
    device = params_device(params)
    pprint.pprint({k: v for k, v in params.items() if k != "dvqa_floats"})
    splits = ["train"] if params["pretrain"] else ["train", params["eval_set"]]
    dataset = ChartQADataset(params, splits)
    return run_training(params, dataset,
                        eval_fn=None if params["no_eval"] else in_train_eval,
                        device=device)


if __name__ == "__main__":
    main()
