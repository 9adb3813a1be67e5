"""CRCT in PyTorch and CUDA: the port of ``crct_tpu`` to an NVIDIA H100.

A second package beside the JAX reference. It imports torch and numpy and
nothing of the JAX package; it keeps its own copies of the host modules it
needs, under the same module names (``crct_tpu_torch/models/layers.py`` is
the counterpart of ``crct_tpu/models/layers.py``, and so on). Every TPU
kernel on a ported path becomes a hand-written Hopper kernel under
``csrc/``, built with nvcc at first use. Entry points run on the card unless
the caller asks for the CPU.

Ported so far: the serving path (``cli.serve`` -> ``serve.make_server`` ->
``QAScorer.score`` -> the eval step -> ``CRCTModel`` forward) with the
attention-forward kernel, and the training path (``cli.train`` ->
``train_loop.run_training`` -> ``Trainer.run_step`` -> forward, losses,
backward through the attention-backward kernel, 4-group AdamW).
"""

__version__ = "0.1.0"
