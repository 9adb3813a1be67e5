"""The port's ``remat`` against the JAX package's and against itself.

With ``CRCTModelConfig.remat`` each encoder block (text, vision and
co-attention) runs in a ``torch.utils.checkpoint``, the counterpart of the
JAX encoder's ``nn.remat`` (crct_tpu/models/vilbert.py:122-127):

  * against the JAX model with ``remat=True`` (its plain attention path,
    dropout off: the tiny config's probabilities are 0 and the port's fixed
    pooled dropout is patched off): the loss within 1e-5 relative and every
    gradient within 1e-4 of its largest magnitude, the tolerances of
    tests/test_torch_train.py;
  * against the port without remat, dropout on (0.1 everywhere): the same
    loss, gradients and generator state bit for bit, in fp32, under bf16
    autocast and with a frozen text prefix; the recompute replays each
    block's dropout draws from a snapshot of the DropoutRNG and leaves the
    trainer's generator where the forward left it;
  * a model config JSON with ``"remat": true`` reaches the port's model,
    whose backward then runs every attention a second time.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from crct_tpu.models.crct import CRCTModel as JaxCRCTModel
from crct_tpu_torch.config import default_params
from crct_tpu_torch.models import layers
from crct_tpu_torch.models.crct import build_model
from crct_tpu_torch.utils.convert import flax_to_state_dict
from tests.helpers import tiny_model_config
from tests.test_torch_model import random_params
from tests.test_torch_train import (NO_DROPOUT, port_model, tb, train_batch)

DROPOUT = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
               v_hidden_dropout_prob=0.1, v_attention_probs_dropout_prob=0.1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_remat_matches_jax_remat(monkeypatch):
    """Loss, nsp_loss and every gradient of a remat training forward
    against jax.value_and_grad of the JAX model with remat=True."""
    monkeypatch.setattr(layers.DropoutRNG, "dropout", lambda self, x, p: x)
    jcfg = tiny_model_config(remat=True, **NO_DROPOUT)
    jmodel = JaxCRCTModel(config=jcfg, categories=10)
    batch = train_batch(41)
    params = random_params(jmodel, batch, 41)

    def loss_fn(p):
        out = jmodel.apply({"params": p}, batch, train=True,
                           deterministic=True)
        return out.loss, out.nsp_loss

    (jloss, jnsp), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    model = port_model(jcfg, params)
    assert model.bert.encoder.config.remat
    out = model(tb(batch), torch.Generator().manual_seed(0))
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(out.nsp_loss.item(), float(jnsp), rtol=1e-5)
    want = flax_to_state_dict(jax.device_get(jgrads))
    for name, p in model.named_parameters():
        w = want[name].numpy()
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        scale = max(np.abs(w).max(), 1e-6)
        np.testing.assert_allclose(g, w, atol=1e-4 * scale, rtol=0,
                                   err_msg=name)


def _dropout_step(remat, seed, **cfg_kw):
    """Loss, gradients and the generator's state after one training
    forward and backward of the tiny model with dropout 0.1."""
    jcfg = tiny_model_config(remat=remat, **DROPOUT, **cfg_kw)
    jmodel = JaxCRCTModel(config=jcfg, categories=10)
    batch = train_batch(seed)
    model = port_model(jcfg, random_params(jmodel, batch, seed))
    gen = torch.Generator().manual_seed(seed)
    out = model(tb(batch), gen)
    out.loss.backward()
    return (out.loss.detach(),
            {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None},
            gen.get_state())


@pytest.mark.parametrize("variant", [{}, {"dtype": "bfloat16"},
                                     {"fixed_t_layer": 2}],
                         ids=["fp32", "bf16_autocast", "frozen_prefix"])
def test_remat_is_bit_equal_to_no_remat_with_dropout(variant):
    loss, grads, state = _dropout_step(False, 43, **variant)
    rloss, rgrads, rstate = _dropout_step(True, 43, **variant)
    assert torch.equal(loss, rloss), (loss, rloss)
    assert set(grads) == set(rgrads)
    for name, g in grads.items():
        assert torch.equal(g, rgrads[name]), name
    # the recompute draws from copies: the trainer's generator stands where
    # the forward left it
    assert torch.equal(state, rstate)
    if variant.get("fixed_t_layer"):
        assert "bert.encoder.layer.0.attention.self.query.weight" not in grads


def test_remat_from_the_json_config_runs_each_attention_twice(tmp_path,
                                                              monkeypatch):
    """"remat": true in a model config JSON reaches the port's model (the
    field was dropped by from_dict before), and a training step then runs
    every attention twice: in the forward and in the recompute."""
    cfg = dataclasses.asdict(tiny_model_config(**DROPOUT))
    counts = []
    real = layers.fused_attention
    monkeypatch.setattr(layers, "fused_attention",
                        lambda *a, **k: counts.append(1) or real(*a, **k))
    per_forward = 4 + 2 + 2 * 2          # text, vision, bi both ways
    for remat in (False, True):
        path = tmp_path / f"model_{remat}.json"
        path.write_text(json.dumps(dict(cfg, remat=remat)))
        model = build_model(default_params(model_config=str(path),
                                           categories=10),
                            device="cpu", train=True)
        assert model.bert.encoder.config.remat is remat
        counts.clear()
        out = model(tb(train_batch(44)), torch.Generator().manual_seed(1))
        assert len(counts) == per_forward
        out.loss.backward()
        assert len(counts) == per_forward * (2 if remat else 1)
