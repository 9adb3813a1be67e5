"""Training entry point of the PyTorch port (reference CRCT/train.py).

Trains on the card unless ``-device cpu`` is given:

    python -m crct_tpu_torch.cli.train -qa_file qa_pairs_V1_train.npy \\
        -dataset_config config/plotqa.json -batch_size 80 -bf16 -no_eval

``-cuda_num N`` picks the card. In-train evaluation is not ported yet, so
``-no_eval`` is required; ``-ddp`` (one process per card) is not ported
either. ``-start_checkpoint`` takes a torch checkpoint in the reference
layout: the port's own epoch checkpoints or a reference ``crct.ckpt``.
"""

from __future__ import annotations

import pprint

from crct_tpu_torch.config import read_command_line
from crct_tpu_torch.data.dataset import ChartQADataset
from crct_tpu_torch.train.train_loop import run_training
from crct_tpu_torch.utils.device import resolve_device

# flags of the JAX trainer whose paths the port does not have yet
NOT_PORTED = ("ddp", "mesh_shape", "fast_scorer", "pallas")


def main(argv=None):
    params = read_command_line(argv)
    for flag in NOT_PORTED:
        if params.get(flag):
            raise SystemExit(f"-{flag} is not yet ported to the PyTorch "
                             f"trainer")
    if not params["no_eval"]:
        raise SystemExit("in-train evaluation is not ported yet (ROADMAP.md "
                         "§1, slice 3: evaluate() and cli/evaluate.py); "
                         "pass -no_eval")
    device = params["device"]
    if device == "cuda" and params["cuda_num"] >= 0:
        device = f"cuda:{params['cuda_num']}"
    device = resolve_device(device)
    pprint.pprint({k: v for k, v in params.items() if k != "dvqa_floats"})
    dataset = ChartQADataset(params, ["train"])
    return run_training(params, dataset, device=device)


if __name__ == "__main__":
    main()
