"""The lexical-retrieval recipe of tests/test_train.py::
test_training_learns_retrieval_task (the backbone of the port's
tools/shortlist_miss_rate.py) on the port's Trainer, against the JAX
Trainer from the same initial weights and on the same batches.

The recipe amplifies rounding-sized differences: whether and when a run
leaves the NSP plateau at ln 2, and where it ends, depends on them (the
second test shows it on the JAX Trainer alone), so no single run of either
package decides the other's. What the port must do is take the JAX
Trainer's steps while the two runs are still close, and leave the plateau
from the JAX Trainer's initial weights.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from crct_tpu.data.dataset import ChartQADataset, DataLoader
from crct_tpu.models.crct import CRCTModel as JaxCRCTModel
from crct_tpu.parallel.mesh import replicate
from crct_tpu.train.train_loop import Trainer as JaxTrainer
from crct_tpu_torch.models.crct import CRCTModel
from crct_tpu_torch.tools.shortlist_miss_rate import recipe_config
from crct_tpu_torch.train.train_loop import Trainer
from crct_tpu_torch.utils.convert import flax_to_state_dict
from tests.helpers import synthetic_params, tiny_model_config

STEPS = 100          # the plateau ends near step 60 from these weights
CLOSE_STEPS = 40     # steps over which the two runs stay within LOSS_TOL
LOSS_TOL = 2e-3      # observed at most 8.5e-4 over those steps
PLATEAU_LOSS = 0.45  # test_training_learns_retrieval_task's limit
JAX_CONFIG = tiny_model_config(v_feature_size=32, hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0,
                               v_hidden_dropout_prob=0.0,
                               v_attention_probs_dropout_prob=0.0)


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    """The recipe's params, its batches (six epochs of the JAX loader, as
    the JAX test cycles them), the JAX Trainer's initial weights and that
    Trainer's losses over STEPS steps from them."""
    params = synthetic_params(tmp_path_factory.mktemp("recipe"),
                              n_images=16, division=8, n_questions=4,
                              feat_dim=32, task="retrieval", batch_size=32,
                              eval_batch_size=64, max_seq_len=96, lr=2e-3,
                              image_lr=2e-3, min_lr=5e-4, warmup=60,
                              num_workers=0)
    ds = ChartQADataset(params, ["train", "val"])
    ds.split = "train"
    loader = DataLoader(ds, batch_size=32, shuffle=True, drop_last=True,
                        num_workers=0)
    batches = [b for _ in range(6) for b in loader]
    trainer = JaxTrainer(params, JaxCRCTModel(
        config=JAX_CONFIG, categories=params["categories"]), batches[0],
        iters_per_epoch=30)
    init = jax.device_get(trainer.params)
    return params, batches, init, jax_losses(trainer, batches)


def jax_losses(trainer, batches):
    return np.asarray([float(np.asarray(trainer.run_step(
        batches[i % len(batches)]))[0]) for i in range(STEPS)])


def test_port_takes_the_jax_trainers_steps_on_the_retrieval_recipe(recipe):
    """From the JAX Trainer's initial weights and on its batches, the
    port's Trainer stays within LOSS_TOL of its losses over the first
    CLOSE_STEPS steps, and leaves the plateau by STEPS steps (the mean loss
    of the last 50 under the JAX test's limit). The tool's model is the
    JAX test's."""
    params, batches, init, want = recipe
    mine = dataclasses.asdict(recipe_config())
    theirs = dataclasses.asdict(JAX_CONFIG)
    assert {k: mine[k] for k in mine if k in theirs} == \
        {k: theirs[k] for k in mine if k in theirs}
    model = CRCTModel(recipe_config(), categories=params["categories"])
    model.load_state_dict(flax_to_state_dict(init), strict=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)        # a fixed thread count: one sum order
    try:
        trainer = Trainer(dict(params), model, iters_per_epoch=30,
                          device="cpu")
        got = np.asarray([float(trainer.run_step(
            batches[i % len(batches)])[0]) for i in range(STEPS)])
    finally:
        torch.set_num_threads(threads)
    gap = np.abs(got - want)
    print(f"first {CLOSE_STEPS} steps' largest loss gap "
          f"{gap[:CLOSE_STEPS].max():.3g}; mean loss of the last 50 steps: "
          f"port {got[-50:].mean():.4f}, JAX {want[-50:].mean():.4f}")
    assert gap[:CLOSE_STEPS].max() <= LOSS_TOL, gap[:CLOSE_STEPS]
    assert got[-50:].mean() < PLATEAU_LOSS, got[-50:]


def test_the_recipe_amplifies_a_millionth_in_the_jax_trainer(recipe):
    """The JAX Trainer alone, from its initial weights changed by a
    relative 1e-6 (normal, seed 1): its first 10 losses stay within 1e-4
    of the unchanged run's, and a later one moves by more than 0.05 (the
    recipe amplifies rounding-sized differences into another run)."""
    params, batches, init, want = recipe
    rng = np.random.default_rng(1)
    nudged = jax.tree.map(lambda x: (np.asarray(x) * (
        1 + 1e-6 * rng.standard_normal(np.shape(x)))).astype(x.dtype), init)
    trainer = JaxTrainer(params, JaxCRCTModel(
        config=JAX_CONFIG, categories=params["categories"]), batches[0],
        iters_per_epoch=30)
    trainer.params = replicate(jax.tree.map(jax.numpy.asarray, nudged),
                               trainer.mesh)
    got = jax_losses(trainer, batches)
    gap = np.abs(got - want)
    print(f"first 10 steps' largest loss gap {gap[:10].max():.3g}, then "
          f"{gap[10:].max():.3g}; mean loss of the last 50 steps "
          f"{got[-50:].mean():.4f} against {want[-50:].mean():.4f}")
    assert gap[:10].max() <= 1e-4, gap[:10]
    assert gap[10:].max() > 0.05, gap[10:]
