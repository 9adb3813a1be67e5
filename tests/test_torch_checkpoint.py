"""The port reads the JAX package's checkpoints, and its weight tools.

JAX checkpoints are written in the test by the JAX package itself
(``crct_tpu.utils.checkpoint.save_checkpoint``: Orbax OCDBT directories)
and read by ``crct_tpu_torch.utils.checkpoint.load_checkpoint`` through
tensorstore:

  (a) a QA checkpoint with a regressor and a fast-scorer head loads into
      the port's model with strict=True, and its forward equals JAX's;
  (b) ``-continue``: a JAX Trainer takes 2 steps (3 mini-steps under
      ``-batch_multiply 2``, so that it saves mid-accumulation) and saves;
      it reloads itself from that checkpoint through its ``-continue``
      path and a port Trainer starts from it with ``-continue``, and each
      takes one step, under the default optimizer, ``-opt_bf16_m`` and
      ``-batch_multiply 2`` (``restore_opt_state`` also takes the optax
      state serialized in memory);
  (c) a detector checkpoint with ``detector_meta``: the same meta as JAX's
      ``detector_file_meta``, and the params of ``detector_flax_to_state_dict``;
  (d) ``cli.convert_checkpoint`` against the JAX CLI on a reference-layout
      ``crct.ckpt`` with legacy keys;
  (e) ``cli.import_bert`` against the JAX CLI from a local torch state
      dict, a TensorFlow checkpoint and a ``save_pretrained`` directory;
  (f) ``-start_checkpoint`` in transfer mode: a text-stream-only checkpoint
      into both packages' ``cli.evaluate``.

Tolerances: forwards and parameters after a continued step within 1e-5 of
max(1, |x|) (fp32 in both; Adam turns a last-bit gradient difference into
~1e-8 of a parameter); restored tensors and tool outputs exactly equal.
"""

import dataclasses
import functools
import io
import json
import re
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from crct_tpu.models.crct import CRCTModel as JaxCRCTModel
from crct_tpu.models.fast_scorer import FastScorer as JaxFastScorer
from crct_tpu.utils import checkpoint as jax_ckpt
from crct_tpu_torch.config import CRCTModelConfig
from crct_tpu_torch.models import layers
from crct_tpu_torch.models.crct import CRCTModel
from crct_tpu_torch.utils import checkpoint as ckpt
from crct_tpu_torch.utils.convert import flax_to_state_dict
from tests.helpers import tiny_model_config
from tests.test_torch_model import fill_params, jax_forward, make_batch
from tests.test_torch_train import NO_DROPOUT, OPT, train_batch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models: torch's thread pool only waits on the other test
    processes' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close(got, want, tol=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max(initial=0.0) <= tol, (what, err.max())


def port_config(jcfg):
    return CRCTModelConfig.from_dict(dataclasses.asdict(jcfg))


def shapes_of(jmodel, batch):
    return jax.eval_shape(lambda r, b: jmodel.init(r, b, train=False),
                          {"params": jax.random.key(0)}, batch)["params"]


def printed(fn, *args):
    out = io.StringIO()
    with redirect_stdout(out):
        result = fn(*args)
    return result, out.getvalue()


def counts_line(text, word):
    return next(ln for ln in text.splitlines() if ln.startswith(word))


# ---------------------------------------------------------------------------
# (a) strict load of a JAX QA checkpoint
# ---------------------------------------------------------------------------

def test_jax_checkpoint_loads_strict_and_forwards_as_jax(tmp_path):
    jcfg = tiny_model_config()
    jmodel = JaxCRCTModel(config=jcfg, categories=10)
    batch = make_batch(3)
    params = fill_params(shapes_of(jmodel, batch), 3)
    head = JaxFastScorer(jcfg.vocab_size, emb_dim=jcfg.hidden_size,
                         hidden=jcfg.bi_hidden_size)
    g = np.random.default_rng(4)
    fused = g.normal(size=(2, jcfg.bi_hidden_size)).astype(np.float32)
    tokens = g.integers(1, jcfg.vocab_size, (2, 5, 3))
    valid = np.ones((2, 5), np.float32)
    head_params = fill_params(jax.eval_shape(
        head.init, jax.random.key(0), fused, tokens, valid)["params"], 4,
        scale=0.3)
    path = str(tmp_path / "plotqa_encoder_0_7.ckpt")
    jax_ckpt.save_checkpoint(path, dict(params, fast_scorer=head_params),
                             iter_id=7)
    assert ckpt.is_orbax_checkpoint(path)

    loaded = ckpt.load_checkpoint(path)
    assert loaded["iter_id"] == 7 and "optimizer_state_dict" not in loaded
    model = CRCTModel(port_config(jcfg), categories=10, fast_scorer=True)
    model.load_state_dict(loaded["model_state_dict"], strict=True)
    model.eval()
    want = jax_forward(jmodel, params, batch)
    with torch.no_grad():
        got = model({k: torch.from_numpy(np.asarray(v))
                     for k, v in batch.items()})
    for name in ("nsp_logits", "reg_output", "reg_loss"):
        assert_close(getattr(got, name).numpy(), getattr(want, name), what=name)
    want_head = head.apply({"params": head_params}, fused, tokens, valid)
    with torch.no_grad():
        got_head = model.fast_scorer(torch.from_numpy(fused),
                                     torch.from_numpy(tokens),
                                     torch.from_numpy(valid))
    assert_close(got_head.numpy(), want_head, what="fast_scorer")


def test_transfer_crosses_regressor_heads_as_jax_does(tmp_path):
    """The JAX tree names both regressor heads' MLP ``fusion_hidden``, so a
    CE-regressor checkpoint transfers its hidden layers (not its 65-bin
    output) into a model with the scalar head: the port counts and copies
    what the JAX package's transfer_params does."""
    jcfg = tiny_model_config()
    batch = make_batch(2, ce_reg=True)
    ce = fill_params(shapes_of(JaxCRCTModel(config=jcfg, categories=10,
                                            ce_reg=True), batch), 2)
    plain = fill_params(shapes_of(JaxCRCTModel(config=jcfg, categories=10),
                                  make_batch(2)), 5)
    path = str(tmp_path / "ce.ckpt")
    jax_ckpt.save_checkpoint(path, ce)
    merged, n = jax_ckpt.transfer_params(plain, ce, verbose=False)
    model = CRCTModel(port_config(jcfg), categories=10)
    loaded = ckpt.load_checkpoint(path)["model_state_dict"]
    assert "regressor.ce_fusion.6.weight" in loaded
    assert ckpt.transfer_params(model, loaded, verbose=False) == n
    for k, v in flax_to_state_dict(jax.device_get(merged)).items():
        if not k.startswith("regressor.fusion.6."):
            torch.testing.assert_close(model.state_dict()[k], v, atol=0,
                                       rtol=0, msg=k)


# ---------------------------------------------------------------------------
# (b) -continue from a JAX Trainer's checkpoint
# ---------------------------------------------------------------------------

class _Deterministic:
    """The JAX model with its fixed pooled dropout off, for the JAX
    Trainer (which calls init, and apply with train=True and rngs)."""

    def __init__(self, model):
        self.model = model

    def init(self, *args, **kw):
        return self.model.init(*args, **kw)

    def apply(self, variables, batch, train, rngs):
        return self.model.apply(variables, batch, train=train,
                                deterministic=True)


CONTINUE = {"default": {}, "bf16_m": {"opt_bf16_m": True},
            "batch_multiply_2": {"batch_multiply": 2}, "no_coattention": {}}
# a variant's model config fields (the others take the tiny config's)
CONTINUE_MODEL = {"no_coattention": {"with_coattention": False}}


@pytest.fixture(scope="module")
def continue_case():
    """variant -> (JAX config, JAX model, batches), one a model config."""
    cases = {}

    def case(variant):
        fields = CONTINUE_MODEL.get(variant, {})
        key = tuple(sorted(fields.items()))
        if key not in cases:
            jcfg = tiny_model_config(**NO_DROPOUT, **fields)
            cases[key] = (jcfg, _Deterministic(JaxCRCTModel(config=jcfg,
                                                            categories=10)),
                          [train_batch(40 + i) for i in range(4)])
        return cases[key]
    return case


@pytest.mark.parametrize("variant", list(CONTINUE))
def test_continue_from_a_jax_trainer_checkpoint(variant, continue_case,
                                                tmp_path, monkeypatch):
    from crct_tpu.parallel.mesh import replicate
    from crct_tpu.train.train_loop import Trainer as JaxTrainer
    from crct_tpu_torch.train.train_loop import Trainer
    monkeypatch.setattr(layers.DropoutRNG, "dropout", lambda self, x, p: x)
    jcfg, jmodel, batches = continue_case(variant)
    pd = dict(OPT, seed=0, mesh_shape=1, save_path=str(tmp_path),
              **CONTINUE[variant])
    before = 3 if pd["batch_multiply"] > 1 else 2
    first = JaxTrainer(pd, jmodel, batches[0], iters_per_epoch=5)
    for b in batches[:before]:
        first.run_step(b)
    path = first.save(epoch=1)
    assert ckpt.is_orbax_checkpoint(path)

    cont = dict(pd, start_checkpoint=path, **{"continue": True})
    port_next = Trainer(cont, CRCTModel(port_config(jcfg), categories=10),
                        5, device="cpu")
    # the same optax state serialized in memory, through restore_opt_state
    from flax import serialization

    from crct_tpu_torch.train.optimizer import AdamW
    fresh = AdamW(list(port_next.model.named_parameters()), pd, 5,
                  every_k=pd["batch_multiply"])
    ckpt.restore_opt_state(fresh, serialization.to_state_dict(
        jax.device_get(first.opt_state)))
    assert (fresh.count, fresh.mini_step) == (port_next.optimizer.count,
                                              port_next.optimizer.mini_step)
    for name, slots in port_next.optimizer.state.items():
        for slot, t in slots.items():
            if t is not None:
                assert torch.equal(fresh.state[name][slot], t), (name, slot)
    # JAX continues: the trainer reloads itself through its own -continue
    # path (params, optimizer state, step and epoch from the checkpoint),
    # which spares building a second one and compiling its step again
    first.params_dict = cont
    first._maybe_load_checkpoint()
    first.params, first.opt_state = replicate(
        (first.params, first.opt_state), first.mesh)
    assert (port_next.step, port_next.start_epoch) == \
        (first.step, first.start_epoch) == (before, 2)
    saved = ckpt.load_checkpoint(path)["optimizer_state_dict"]
    assert port_next.optimizer.count == saved["count"] == \
        before // pd["batch_multiply"]
    assert port_next.optimizer.mini_step == saved["mini_step"] == \
        before % pd["batch_multiply"]
    mu = {s["mu"].dtype for s in port_next.optimizer.state.values()}
    assert mu == {torch.bfloat16 if pd.get("opt_bf16_m") else torch.float32}
    start = flax_to_state_dict(jax.device_get(first.params))
    # the JAX tree is the port model's (without co-attention: no c_layer)
    plain = CRCTModel(port_config(jcfg), categories=10)
    plain.load_state_dict(start, strict=True)
    if variant == "no_coattention":
        # a reference-layout state dict, co-attention layers and all, still
        # fills every tensor of the model in transfer mode
        full = CRCTModel(port_config(dataclasses.replace(
            jcfg, with_coattention=True)), categories=10).state_dict()
        assert any(".c_layer." in k for k in full)
        assert ckpt.transfer_params(plain, full, verbose=False) == \
            len(plain.state_dict())

    first.run_step(batches[before])
    port_next.run_step(batches[before])
    want = flax_to_state_dict(jax.device_get(first.params))
    got = port_next.model.state_dict()
    assert set(want) <= set(got)
    for k, v in want.items():
        assert_close(got[k].numpy(), v.numpy(), what=k)
    # the continued step updated the parameters
    assert sum(not torch.equal(v, start[k]) for k, v in want.items()) > 100


# ---------------------------------------------------------------------------
# (c) a JAX detector checkpoint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_depth", [True, False], ids=["meta", "no_depth"])
def test_jax_detector_checkpoint(with_depth, tmp_path):
    from crct_tpu.detector.convert import detector_file_meta as jax_meta
    from crct_tpu.detector.mask_rcnn import MaskRCNN as JaxMaskRCNN
    from crct_tpu_torch.detector.convert import (detector_file_meta,
                                                 detector_flax_to_state_dict,
                                                 restore_detector_params)
    from crct_tpu_torch.detector.mask_rcnn import MaskRCNN
    kw = dict(num_classes=5, depth=14, with_mask=True)
    image = np.zeros((64, 64, 3), np.float32)
    boxes = np.asarray([[4, 4, 30, 30]], np.float32)
    params = fill_params(jax.eval_shape(
        functools.partial(JaxMaskRCNN(**kw).init, train=True),
        jax.random.key(0), image, gt_boxes=boxes,
        gt_classes=np.ones(1, np.int32), gt_valid=np.ones(1, bool),
        gt_masks28=np.ones((1, 28, 28), np.float32),
        rng=jax.random.key(1))["params"], 6)
    meta = {"stride_in_1x1": np.asarray(1),
            "pixel_mean": np.asarray([103.5, 116.2, 123.6], np.float32),
            "pixel_std": np.asarray([1.0, 2.0, 3.0], np.float32)}
    if with_depth:
        meta["depth"] = np.asarray(14)
    path = str(tmp_path / "detector_5.ckpt")
    jax_ckpt.save_checkpoint(path, params, iter_id=5,
                             extra={"detector_meta": meta})

    got = detector_file_meta(path)
    assert got == jax_meta(path)
    assert got["depth"] == (14 if with_depth else None)
    model = MaskRCNN(**kw)
    assert restore_detector_params(model, path, verbose=False) == got
    want = detector_flax_to_state_dict(params)
    own = model.state_dict()
    for k, v in want.items():
        torch.testing.assert_close(own[k], v, atol=0, rtol=0, msg=k)


# ---------------------------------------------------------------------------
# (d) cli.convert_checkpoint
# ---------------------------------------------------------------------------

def test_convert_checkpoint_matches_the_jax_cli(tmp_path):
    from crct_tpu.cli.convert_checkpoint import main as jax_main
    from crct_tpu.utils.convert import inverse_convert
    from crct_tpu_torch.cli.convert_checkpoint import main
    jcfg = tiny_model_config()
    jmodel = JaxCRCTModel(config=jcfg, categories=10)
    params = fill_params(shapes_of(jmodel, make_batch(0)), 8)
    ref = dict(inverse_convert(params))
    ln = "bert_pretrained.bert.encoder.layer.1.output.LayerNorm"
    ref[f"{ln}.gamma"] = ref.pop(f"{ln}.weight")
    ref[f"{ln}.beta"] = ref.pop(f"{ln}.bias")
    ref["bert_pretrained.cls.predictions.bias"] = np.zeros(600, np.float32)
    ref["bert_pretrained.bert.encoder.c_layer.0.biOutput.q_dense1.weight"] = \
        np.zeros((32, 32), np.float32)
    ref["bert_pretrained.bert.v_embeddings.type_embeddings.weight"] = \
        np.zeros((13, 32), np.float32)
    ref["bert_pretrained.extra_head.dense.weight"] = np.zeros(3, np.float32)
    src = str(tmp_path / "crct.ckpt")
    torch.save({"model_state_dict": {k: torch.from_numpy(
        np.ascontiguousarray(v)) for k, v in ref.items()}}, src)

    _, jtext = printed(jax_main, [src, str(tmp_path / "jax"), "--report"])
    _, text = printed(main, [src, str(tmp_path / "port.ckpt"), "--report"])
    assert counts_line(text, "converted") == counts_line(jtext, "converted")
    assert "converted 204 tensors; skipped 4 " in text
    assert [ln for ln in text.splitlines() if "skipped:" in ln] == \
        [ln for ln in jtext.splitlines() if "skipped:" in ln]

    want = ckpt.load_checkpoint(str(tmp_path / "jax"))["model_state_dict"]
    got = ckpt.load_checkpoint(str(tmp_path / "port.ckpt"))
    assert got["iter_id"] == 0
    assert set(got["model_state_dict"]) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got["model_state_dict"][k], v, atol=0,
                                   rtol=0, msg=k)
    # the hand-off: the JAX CLI's Orbax output into a port torch file,
    # which loads strict
    _, text = printed(main, [str(tmp_path / "jax"), str(tmp_path / "h.ckpt")])
    assert "converted 204 tensors; skipped 0 " in text
    model = CRCTModel(port_config(jcfg), categories=10)
    model.load_state_dict(
        ckpt.load_checkpoint(str(tmp_path / "h.ckpt"))["model_state_dict"],
        strict=True)
    for k, v in want.items():
        torch.testing.assert_close(model.state_dict()[k], v, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# (e) cli.import_bert
# ---------------------------------------------------------------------------

BERT = dict(vocab_size=600, hidden_size=64, num_hidden_layers=4,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=128)
TEXT_STREAM = 4 + 16 * BERT["num_hidden_layers"]


def write_bert_source(kind, tmp_path):
    """A BERT of the tiny model's text-stream widths in one of the three
    forms import_bert takes; returns the CLI's source argument."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    bert = transformers.BertModel(transformers.BertConfig(**BERT))
    if kind == "hf":
        bert.save_pretrained(str(tmp_path / "hf"))
        return f"hf:{tmp_path / 'hf'}"
    sd = {f"bert.{k}": v.detach().clone() for k, v in
          bert.state_dict().items()}
    if kind == "local":                # TF-era names, and the BERT heads
        for k in [k for k in sd if "LayerNorm" in k]:
            sd[k.replace(".weight", ".gamma").replace(".bias", ".beta")] = \
                sd.pop(k)
        sd["cls.predictions.bias"] = torch.zeros(BERT["vocab_size"])
        sd["cls.seq_relationship.weight"] = torch.zeros(2, 64)
        torch.save(sd, tmp_path / "pytorch_model.bin")
        return str(tmp_path / "pytorch_model.bin")
    # a TensorFlow checkpoint with Google's names (kernels [in, out])
    tf = pytest.importorskip("tensorflow")
    tf1 = tf.compat.v1
    variables = {}
    for k, v in sd.items():
        if k.endswith("position_ids"):
            continue
        name, arr = k.replace(".", "/"), v.numpy()
        name = re.sub(r"layer/(\d+)", r"layer_\1", name)
        if name.endswith("_embeddings/weight"):
            name = name[:-len("/weight")]
        elif "LayerNorm" in name:
            name = name.replace("/weight", "/gamma").replace("/bias", "/beta")
        elif name.endswith("/weight"):
            name, arr = name[:-len("/weight")] + "/kernel", arr.T
        variables[name] = np.ascontiguousarray(arr)
    variables["bert/encoder/layer_0/attention/self/query/kernel/adam_m"] = \
        np.zeros((64, 64), np.float32)
    prefix = str(tmp_path / "bert_model.ckpt")
    graph = tf1.Graph()
    with graph.as_default():
        for name, arr in variables.items():
            tf1.get_variable(name, initializer=tf.constant(arr))
        saver = tf1.train.Saver()
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            saver.save(sess, prefix)
    return f"tf:{prefix}"


@pytest.mark.parametrize("kind", ["local", "tf", "hf"])
def test_import_bert_matches_the_jax_cli(kind, tmp_path):
    from crct_tpu.cli import import_bert as jax_tool
    from crct_tpu.utils.convert import load_torch_checkpoint
    from crct_tpu_torch.cli import import_bert as tool
    src = write_bert_source(kind, tmp_path)
    want_src = {"local": lambda: load_torch_checkpoint(src),
                "tf": lambda: jax_tool.tf_state_dict(src[3:]),
                "hf": lambda: jax_tool.hf_state_dict(src[3:])}[kind]()
    got_src = tool.source_state_dict(src)
    assert set(got_src) == set(want_src)
    for k, v in want_src.items():
        np.testing.assert_array_equal(np.asarray(got_src[k]), v, err_msg=k)

    _, jtext = printed(jax_tool.main, [src, str(tmp_path / "jax")])
    out, text = printed(tool.main, [src, str(tmp_path / "bert.ckpt")])
    assert counts_line(text, "imported") == counts_line(jtext, "imported")
    assert f"imported {TEXT_STREAM} BERT tensors" in text
    want = ckpt.load_checkpoint(str(tmp_path / "jax"))["model_state_dict"]
    got = ckpt.load_checkpoint(out)["model_state_dict"]
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k].float(), v, atol=0, rtol=0, msg=k)
    if kind != "local":
        return
    # cli.train -start_checkpoint: the text stream is BERT's, the rest
    # keeps the seeded init
    from crct_tpu_torch.config import default_params
    from crct_tpu_torch.train.train_loop import Trainer
    (tmp_path / "tiny.json").write_text(json.dumps(
        dataclasses.asdict(tiny_model_config())))
    pd = default_params(model_config=str(tmp_path / "tiny.json"),
                        categories=10, save_path=str(tmp_path), **OPT)
    fresh = Trainer(pd, None, 5, device="cpu").model.state_dict()
    trainer, text = printed(lambda: Trainer(
        dict(pd, start_checkpoint=out), None, 5, device="cpu"))
    assert f"number of keys transferred: {TEXT_STREAM}" in text
    for k, v in trainer.model.state_dict().items():
        torch.testing.assert_close(v, got[k] if k in got else fresh[k],
                                   atol=0, rtol=0, msg=k)


# ---------------------------------------------------------------------------
# (f) -start_checkpoint in transfer mode, as the JAX entry points load it
# ---------------------------------------------------------------------------

class _Init:
    """A JAX model whose init gives fixed parameters (the JAX CLI's model
    keeps its init wherever the checkpoint has no leaf)."""

    def __init__(self, model, params):
        self.model, self.params = model, params

    def init(self, *args, **kw):
        return {"params": self.params}

    def __getattr__(self, name):
        return getattr(self.model, name)


def test_text_stream_checkpoint_into_both_evaluate_clis(tmp_path,
                                                        monkeypatch):
    """A checkpoint holding only the text stream goes into both packages'
    cli.evaluate: the same transferred count, and the same tables. Both
    models start from the same parameters, drawn at scale 0.3 (at the
    init's 0.02 the candidates' NSP probabilities tie within fp32 noise,
    see tests/test_torch_eval.py; seed 1 leaves no question's two best
    within 1e-5, which the test asserts first), and the checkpoint's text
    stream from another seed replaces theirs."""
    import crct_tpu.cli.evaluate as jax_eval
    import crct_tpu_torch.cli.evaluate as port_eval
    from crct_tpu.data.synthetic import generate_dataset
    from tests.test_torch_eval import record_gaps
    cfg = generate_dataset(str(tmp_path / "data"), n_images=4, division=4,
                           n_questions=3, feat_dim=32)
    ds = dict(cfg, main_folder="", save_path=str(tmp_path), max_seq_len=124,
              max_vis_features=44, categories=228)
    (tmp_path / "ds.json").write_text(json.dumps(ds))
    jcfg = tiny_model_config(vocab_size=30522, v_feature_size=32)
    (tmp_path / "tiny.json").write_text(json.dumps(dataclasses.asdict(jcfg)))
    jmodel = JaxCRCTModel(config=jcfg, categories=228)
    shapes = shapes_of(jmodel, make_batch(0, vocab=30522))
    init, full = (fill_params(shapes, seed, scale=0.3) for seed in (1, 11))
    text = {"bert": {"embeddings": {
        k: v for k, v in full["bert"]["embeddings"].items()
        if k in ("word_embeddings", "position_embeddings", "LayerNorm")},
        "encoder": {k: v for k, v in full["bert"]["encoder"].items()
                    if k.startswith("t_layer_")}}}
    path = str(tmp_path / "text_stream.ckpt")
    jax_ckpt.save_checkpoint(path, text)
    argv = ["-qa_file", "qa_pairs.npy", "-dataset_config",
            str(tmp_path / "ds.json"), "-model_config",
            str(tmp_path / "tiny.json"), "-num_workers", "1", "-eval_set",
            "test", "-eval_batch_size", "16", "-start_checkpoint", path]

    real_build = jax_eval.build_model
    monkeypatch.setattr(jax_eval, "build_model",
                        lambda params: _Init(real_build(params), init))
    (want, gap), jtext = printed(lambda: record_gaps(
        lambda: jax_eval.main(argv + ["-save_name", "jax"])))
    assert gap > 1e-5

    def port_init(params, device):
        model = CRCTModel(port_config(jcfg), categories=228)
        model.load_state_dict(flax_to_state_dict(init), strict=True)
        return model.to(device).eval()

    monkeypatch.setattr(port_eval, "build_model", port_init)
    got, ptext = printed(port_eval.main,
                         argv + ["-save_name", "port", "-device", "cpu"])
    assert f"number of keys transferred: {TEXT_STREAM}\n" in jtext
    assert f"number of keys transferred: {TEXT_STREAM}\n" in ptext
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert want[0][4, 1] == 12       # every question scored
