"""One-shot converter into a port checkpoint (the port of
``crct_tpu/cli/convert_checkpoint.py``).

Usage:
    python -m crct_tpu_torch.cli.convert_checkpoint SRC DST [--report]

``SRC`` is a reference ``crct.ckpt`` in torch format (the published
weights, ``bert_pretrained.*`` keys, legacy heads included) or a JAX package
checkpoint: an Orbax directory that ``crct_tpu`` wrote (reading it needs
tensorstore). ``DST`` is a port checkpoint (``utils.checkpoint.
save_checkpoint``): the model's parameters in the reference layout, step 0.
The second form is how a model trained on the TPU reaches a host without
tensorstore, such as the card's: convert on a host that has it, and pass
the torch file to ``-start_checkpoint``. Prints ``converted N tensors;
skipped M legacy/unused keys`` as the JAX CLI does, and with ``--report``
the skipped keys.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("src", help="torch .ckpt path, or a JAX package "
                                    "checkpoint directory")
    parser.add_argument("dst", help="output port checkpoint (torch file)")
    parser.add_argument("--report", action="store_true",
                        help="print per-key conversion report")
    args = parser.parse_args(argv)

    import torch

    from crct_tpu_torch.utils.checkpoint import (is_orbax_checkpoint,
                                                 load_checkpoint,
                                                 save_checkpoint)
    from crct_tpu_torch.utils.convert import convert_torch_state_dict

    if is_orbax_checkpoint(args.src):
        sd, skipped = load_checkpoint(args.src)["model_state_dict"], []
    else:
        loaded = torch.load(args.src, map_location="cpu", weights_only=False)
        sd, skipped = convert_torch_state_dict(
            loaded.get("model_state_dict", loaded))
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    print(f"converted {len(sd)} tensors; skipped {len(skipped)} "
          f"legacy/unused keys")
    if args.report:
        for k in skipped:
            print(f"  skipped: {k}")
    save_checkpoint(args.dst, sd, iter_id=0)
    print(f"wrote {args.dst}")
    return args.dst


if __name__ == "__main__":
    main()
