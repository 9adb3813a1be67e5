"""Train the opt-in fast-scorer head on a trained CRCT checkpoint.

    python -m crct_tpu_torch.cli.train_fast_scorer -qa_file qa_pairs.npy \\
        -dataset_config config/plotqa.json -start_checkpoint trained.ckpt \\
        -save_name fs_run [-fs_steps 2000] [-fs_lr 1e-3] [-device cpu]

On the card unless ``-device cpu`` is given. Backbone weights come from
``-start_checkpoint`` (the port's, a reference ``crct.ckpt`` or the JAX
package's, loaded in transfer mode as the JAX CLI loads it) and stay
frozen; only the light candidate head trains (listwise CE over
each question's candidate set). The output, ``<save_path>/fast_scorer.ckpt``,
holds backbone + head in fp32; evaluate or serve with ``-fast_scorer
-start_checkpoint <out>`` for one backbone pass per question instead of the
x120 candidate fan-out.
"""

from __future__ import annotations

import os
import pprint

from crct_tpu_torch.config import read_command_line
from crct_tpu_torch.data.dataset import ChartQADataset
from crct_tpu_torch.models.crct import build_model
from crct_tpu_torch.train.fast_scorer_train import train_fast_scorer
from crct_tpu_torch.utils.checkpoint import (load_start_checkpoint,
                                             save_checkpoint)
from crct_tpu_torch.utils.convert import FAST_SCORER_PREFIX
from crct_tpu_torch.utils.device import params_device


def main(argv=None):
    params = read_command_line(argv)
    params["fast_scorer"] = True
    device = params_device(params)
    pprint.pprint({k: v for k, v in params.items() if k != "dvqa_floats"})

    dataset = ChartQADataset(params, ["train"])
    model = build_model(params, device=device)
    loaded = {}
    if params.get("start_checkpoint"):
        loaded = load_start_checkpoint(model, params["start_checkpoint"],
                                       warn_head=False)

    model, last_ce = train_fast_scorer(
        params, dataset, model,
        steps=params["fs_steps"], lr=params["fs_lr"],
        batch_questions=max(2, params["batch_size"] // 4))

    # the backbone as loaded (fp32, not the compute dtype it ran in) and the
    # trained head
    state = {k: v.float() for k, v in model.state_dict().items()}
    state.update({k: v.float() for k, v in loaded.items()
                  if k in state and v.shape == state[k].shape
                  and not k.startswith(FAST_SCORER_PREFIX)})
    os.makedirs(params["save_path"], exist_ok=True)
    out = os.path.join(params["save_path"], "fast_scorer.ckpt")
    save_checkpoint(out, state)
    print(f"final CE: {last_ce}")
    print(f"     --> Saved model as: {out}")
    return out


if __name__ == "__main__":
    main()
