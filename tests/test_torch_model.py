"""The port's model against the JAX model, module by module.

JAX parameters go through crct_tpu_torch.utils.convert.flax_to_state_dict
and load into the port with strict=True; the same numpy inputs then go
through the JAX module and its port counterpart: each module that holds the
attention kernel (SelfAttention, BiAttention, ConnectionLayer,
TwoStreamEncoder) and the whole CRCTModel eval forward.

Tolerances: fp32 at atol 1e-5, rtol 1e-4. Flax's LayerNorm takes the
variance as E[x^2] - E[x]^2, torch's as E[(x - E[x])^2]; with eps 1e-12
that moves normalized activations by a few fp32 ulps per layer. The bf16
cases compare the port in -pallas mode against the JAX model on its Pallas
path (interpret mode), whose probabilities stay fp32 as the port's do, at
atol 5e-2 on logits of magnitude ~1, and the port's default mode against
the JAX model's default XLA path, which rounds them to bf16 as the port
does: the eval forward within 2e-3 + 2e-2 relative (bf16 rounds at other
places in the two frameworks too: LayerNorm scale, matmul outputs; read
2.4e-4 on NSP logits of ~0.02), and a training step's loss within 1e-3
relative and each gradient's relative L2 difference within 0.25, key biases
apart (zero in exact arithmetic): the port trains under bf16 autocast over
fp32 parameters, the JAX model in bf16 throughout (read 4.2e-5 and 0.18,
the regressor's; the median leaf 0.03).
"""

import dataclasses
import json
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crct_tpu.models import layers as jax_layers
from crct_tpu.models.crct import CRCTModel as JaxCRCTModel
from crct_tpu.models.vilbert import TwoStreamEncoder as JaxEncoder
from crct_tpu_torch.config import CRCTModelConfig
from crct_tpu_torch.models.crct import CRCTModel
from crct_tpu_torch.utils.convert import flax_to_state_dict
from tests.helpers import tiny_model_config

FP32 = dict(atol=1e-5, rtol=1e-4)


def make_batch(seed, B=6, L=16, R=6, vocab=600, vdim=32, cats=10,
               ce_reg=False):
    g = np.random.default_rng(seed)
    sep = np.zeros((B, 50), np.int32)
    sep[:, 0] = g.integers(L // 2, L - 1, B)
    reg_row = [3.0 if ce_reg else 5.0, 1, 0.01, 10.0]
    return {
        "tokens": g.integers(0, vocab, (B, L)).astype(np.int32),
        "segments": g.integers(-1, 5, (B, L)).astype(np.int32),
        "loc": np.where(g.random((B, L, 1)) < 0.3, 0.0,
                        g.random((B, L, 4))).astype(np.float32),
        "sep_indices": sep,
        "hist_len": np.zeros((B, 1), np.int32),
        "image_feat": g.random((B, R, vdim)).astype(np.float32),
        "image_loc": g.random((B, R, 4)).astype(np.float32),
        "image_target": g.integers(0, cats, (B, R)).astype(np.int32),
        "image_mask": (g.random((B, R)) < 0.8).astype(np.float32),
        "R": np.asarray([reg_row] * (B // 2) + [[0, 0, 0, 0]] * (B - B // 2),
                        np.float32),
    }


def fill_params(tree, seed, scale=0.05):
    """A JAX parameter tree of the same shapes filled from a numpy seed:
    normal(0, scale) everywhere, LayerNorm scales around 1."""
    g = np.random.default_rng(seed)

    def fill(path, leaf):
        one = 1.0 if path[-1].key == "scale" else 0.0
        return (one + scale * g.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def random_params(jmodel, batch, seed):
    """The JAX model's parameters from a numpy seed (shapes from abstract
    evaluation, so nothing is initialized on the JAX side)."""
    return fill_params(jax.eval_shape(
        lambda r, b: jmodel.init(r, b, train=False),
        {"params": jax.random.key(0)}, batch)["params"], seed)


def jax_apply(module, params, *args):
    return jax.jit(lambda p, *a: module.apply({"params": p}, *a))(
        params, *map(jnp.asarray, args))


def jax_forward(jmodel, params, batch):
    return jax.jit(lambda p, b: jmodel.apply({"params": p}, b, train=False))(
        params, batch)


def port_config(jax_cfg) -> CRCTModelConfig:
    return CRCTModelConfig.from_dict(dataclasses.asdict(jax_cfg))


def build_pair(seed=0, **model_kw):
    """A JAX model with initialized params and the port model holding the
    same weights."""
    jcfg = tiny_model_config()
    jmodel = JaxCRCTModel(config=jcfg, categories=10, **model_kw)
    batch = make_batch(seed, ce_reg=model_kw.get("ce_reg", False))
    params = random_params(jmodel, batch, seed)
    model = CRCTModel(port_config(jcfg), categories=10, **model_kw)
    model.load_state_dict(
        flax_to_state_dict(params, ce_reg=model_kw.get("ce_reg", False)),
        strict=True)
    return jmodel, params, model.eval(), batch


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def t(x):
    return torch.from_numpy(np.array(x))


def hidden(seed, B, L, d):
    return np.random.default_rng(seed).normal(size=(B, L, d)).astype(
        np.float32)


def key_mask(seed, B, L):
    m = (np.random.default_rng(seed).random((B, L)) < 0.8).astype(np.float32)
    return np.asarray(jax_layers.extended_attention_mask(jnp.asarray(m)))


def test_state_dict_round_trip_is_complete(pair):
    _, params, model, _ = pair
    sd = flax_to_state_dict(params)
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k


def test_reference_checkpoint_loads_strict(pair, tmp_path):
    """A checkpoint in the reference torch layout (``bert_pretrained.``
    prefix, ``model_state_dict`` wrapper, heads the forward never uses)
    loads strict and gives the weights flax_to_state_dict gives."""
    from crct_tpu.utils.convert import inverse_convert
    from crct_tpu_torch.utils.convert import load_torch_checkpoint
    _, params, model, _ = pair
    ref = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in inverse_convert(params).items()}
    for key, shape in (("cls.predictions.bias", (600,)),
                       ("bert.encoder.c_layer.0.biOutput.q_dense1.weight",
                        (32, 32)),
                       ("bert.v_embeddings.type_embeddings.weight", (13, 32))):
        ref[f"bert_pretrained.{key}"] = torch.zeros(shape)
    path = tmp_path / "crct.ckpt"
    torch.save({"model_state_dict": ref}, path)
    fresh = CRCTModel(port_config(tiny_model_config()), categories=10)
    fresh.load_state_dict(load_torch_checkpoint(str(path)), strict=True)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, atol=0, rtol=0)


def test_build_model_init_is_seeded_like_flax(tmp_path):
    """build_model draws its weights from a torch.Generator seeded by
    params['seed']: flax's truncated_normal(0.02), cut at +-0.04."""
    import json

    from crct_tpu_torch.models.crct import build_model
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(dataclasses.asdict(tiny_model_config())))
    models = [build_model({"model_config": str(path), "seed": s,
                           "categories": 10}, device="cpu")
              for s in (1, 1, 2)]
    w = [m.bert.embeddings.word_embeddings.weight for m in models]
    torch.testing.assert_close(w[0], w[1], atol=0, rtol=0)
    assert not torch.equal(w[0], w[2])
    assert w[0].abs().max() <= 0.04
    assert abs(w[0].std().item() - 0.02 * 0.8796) < 0.0005
    assert not models[0].training


def test_self_attention(pair):
    _, params, model, _ = pair
    cfg = tiny_model_config()
    x, m = hidden(1, 3, 12, cfg.hidden_size), key_mask(2, 3, 12)
    want = jax_apply(
        jax_layers.SelfAttention(cfg.hidden_size, cfg.num_attention_heads,
                                 0.1, 0.1),
        params["bert"]["encoder"]["t_layer_1"]["attention"], x, m)
    with torch.no_grad():
        got = model.bert.encoder.layer[1].attention(t(x), t(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def test_bi_attention(pair):
    _, params, model, _ = pair
    cfg = tiny_model_config()
    v, vm = hidden(3, 3, 6, cfg.v_hidden_size), key_mask(4, 3, 6)
    x, tm = hidden(5, 3, 12, cfg.hidden_size), key_mask(6, 3, 12)
    want = jax_apply(
        jax_layers.BiAttention(cfg.bi_hidden_size,
                               cfg.bi_num_attention_heads, 0.1, 0.1),
        params["bert"]["encoder"]["c_layer_0"]["biattention"], v, vm, x, tm)
    with torch.no_grad():
        got = model.bert.encoder.c_layer[0].biattention(
            t(v), t(vm), t(x), t(tm))
    for g_, w in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w), **FP32)


def test_connection_layer(pair):
    _, params, model, _ = pair
    cfg = tiny_model_config()
    v, vm = hidden(7, 3, 6, cfg.v_hidden_size), key_mask(8, 3, 6)
    x, tm = hidden(9, 3, 12, cfg.hidden_size), key_mask(10, 3, 12)
    want = jax_apply(
        jax_layers.ConnectionLayer(
            cfg.v_hidden_size, cfg.hidden_size, cfg.bi_hidden_size,
            cfg.bi_num_attention_heads, cfg.v_intermediate_size,
            cfg.intermediate_size, "gelu", "gelu", 0.1, 0.1, 0.1, 0.1),
        params["bert"]["encoder"]["c_layer_1"], v, vm, x, tm)
    with torch.no_grad():
        got = model.bert.encoder.c_layer[1](t(v), t(vm), t(x), t(tm))
    for g_, w in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w), **FP32)


@pytest.mark.parametrize("mode", ["default", "fast_mode", "in_batch_pairs",
                                  "no_coattention"])
def test_two_stream_encoder(pair, mode):
    _, params, model, _ = pair
    kw = {} if mode == "default" else {mode: mode != "no_coattention"}
    if mode == "no_coattention":
        kw = {"with_coattention": False}
    cfg = tiny_model_config(**kw)
    B = 1 if mode == "fast_mode" else 3
    x, tm = hidden(11, B, 12, cfg.hidden_size), key_mask(12, B, 12)
    v, vm = hidden(13, 3, 6, cfg.v_hidden_size), key_mask(14, 3, 6)
    want = jax_apply(JaxEncoder(cfg), params["bert"]["encoder"],
                     x, v, tm, vm)
    encoder = model.bert.encoder
    encoder.config = port_config(cfg)
    try:
        with torch.no_grad():
            got = encoder(t(x), t(v), t(tm), t(vm))
    finally:
        encoder.config = model.config
    for g_, w in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w), **FP32)


def _compare_outputs(got, want, tol):
    for name in ("nsp_logits", "reg_output", "reg_l1", "reg_5_dist",
                 "reg_loss"):
        np.testing.assert_allclose(getattr(got, name).float().numpy(),
                                   np.asarray(getattr(want, name)),
                                   err_msg=name, **tol)
    for name in ("needs_reg", "correct_regs", "correct_t_regs"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("variant", ["plotqa", "ce_reg", "dvqa"])
def test_crct_model_eval_forward(variant):
    kw = {"plotqa": {}, "ce_reg": {"ce_reg": True},
          "dvqa": {"dataset": "dvqa"}}[variant]
    jmodel, params, model, batch = build_pair(seed=3, **kw)
    want = jax_forward(jmodel, params, batch)
    with torch.no_grad():
        got = model({k: t(v) for k, v in batch.items()})
    _compare_outputs(got, want, FP32)
    if variant == "dvqa":
        from crct_tpu_torch.config import DVQA_FLOATS
        needs = got.needs_reg.numpy()
        assert np.isin(got.reg_output.numpy()[needs], DVQA_FLOATS).all()


def test_crct_model_bf16_default_path_matches_jax_xla_path():
    """The eval forward in bf16, attention in the default mode, against the
    JAX model's default (XLA) attention path."""
    jcfg = tiny_model_config(dtype="bfloat16")
    jmodel = JaxCRCTModel(config=jcfg, categories=10)
    batch = make_batch(4)
    params = random_params(jmodel, batch, 4)
    want = jax_forward(jmodel, params, batch)
    model = CRCTModel(port_config(jcfg), categories=10)
    assert not model.bert.encoder.config.use_pallas_attention
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    model.set_compute_dtype().eval()
    with torch.no_grad():
        got = model({k: t(v) for k, v in batch.items()})
    for name in ("nsp_logits", "reg_output"):
        np.testing.assert_allclose(getattr(got, name).float().numpy(),
                                   np.asarray(getattr(want, name), np.float32),
                                   atol=2e-3, rtol=2e-2, err_msg=name)


def test_bf16_train_gradients_match_jax_xla_path(monkeypatch):
    """One bf16 training forward and backward, dropout off (the config's
    rates 0, the pooled fusion's fixed 0.1 patched out), the port in its
    default attention mode against jax.value_and_grad of the JAX model on
    its default XLA path."""
    from crct_tpu_torch.models import layers
    monkeypatch.setattr(layers.DropoutRNG, "dropout", lambda self, x, p: x)
    jcfg = tiny_model_config(
        dtype="bfloat16", hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, v_hidden_dropout_prob=0.0,
        v_attention_probs_dropout_prob=0.0)
    jmodel = JaxCRCTModel(config=jcfg, categories=10)
    batch = make_batch(21)
    batch["next_sentence_labels"] = np.asarray([0, 1, 1, 0, 1, 0], np.int32)
    params = random_params(jmodel, batch, 21)

    def loss_fn(p):
        return jmodel.apply({"params": p}, batch, train=True,
                            deterministic=True).loss

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = flax_to_state_dict(jax.device_get(jgrads))
    model = CRCTModel(port_config(jcfg), categories=10)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    model.train()
    out = model({k: t(v) for k, v in batch.items()},
                torch.Generator().manual_seed(0))
    out.loss.backward()
    assert abs(out.loss.item() - float(jloss)) <= 1e-3 * abs(float(jloss))
    for name, p in model.named_parameters():
        if name.endswith(("key.bias", "key1.bias", "key2.bias")):
            continue
        w = want[name].float()
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        assert p.dtype == torch.float32
        rel = ((g - w).norm() / w.norm().clamp(min=1e-12)).item()
        assert rel <= 0.25, (name, rel)


def test_crct_model_bf16_against_pallas_path(monkeypatch):
    from crct_tpu.ops import attention as A
    monkeypatch.setattr(A, "fused_attention",
                        functools.partial(A.fused_attention, interpret=True))
    jcfg = tiny_model_config(dtype="bfloat16", use_pallas_attention=True)
    jmodel = JaxCRCTModel(config=jcfg, categories=10)
    batch = make_batch(4)
    params = random_params(jmodel, batch, 4)
    want = jax_forward(jmodel, params, batch)
    model = CRCTModel(port_config(jcfg), categories=10)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    model.set_compute_dtype().eval()
    assert model.bert.embeddings.word_embeddings.weight.dtype == torch.bfloat16
    with torch.no_grad():
        got = model({k: t(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.nsp_logits.numpy(),
                               np.asarray(want.nsp_logits), atol=5e-2,
                               rtol=5e-2)
    np.testing.assert_allclose(got.reg_output.numpy(),
                               np.asarray(want.reg_output), atol=5e-2 * 10,
                               rtol=5e-2)


@pytest.mark.parametrize("argv", [[], ["-pallas"]], ids=["default", "pallas"])
def test_pallas_flag_reaches_every_attention_call(argv, tmp_path,
                                                  monkeypatch):
    """-pallas on the CLIs' command line (cli.train, cli.serve,
    cli.evaluate share it) builds the model with the Pallas path's
    attention numerics, as crct_tpu/models/crct.py:224 does; without it
    every attention call takes the default path's. The CLIs refuse it no
    more."""
    from crct_tpu_torch.config import read_command_line
    from crct_tpu_torch.models import layers
    from crct_tpu_torch.models.crct import build_model
    from crct_tpu_torch.ops import attention
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(dataclasses.asdict(tiny_model_config())))
    params = read_command_line(["-qa_file", "qa.npy", "-save_name", "x",
                                "-model_config", str(path), "-device", "cpu",
                                *argv])
    assert params["pallas"] is bool(argv)
    modes = []
    real = layers.fused_attention
    monkeypatch.setattr(layers, "fused_attention",
                        lambda *a, mode, **k: modes.append(mode)
                        or real(*a, mode=mode, **k))
    model = build_model(dict(params, categories=10), device="cpu")
    with torch.no_grad():
        model({k: t(v) for k, v in make_batch(5).items()})
    assert modes and set(modes) == {attention.PALLAS if argv
                                    else attention.ROUND_PROBS}
