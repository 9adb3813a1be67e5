"""The port's training path against the JAX package's.

The same numpy weights (carried across by flax_to_state_dict) and the same
numpy batches go through the JAX training code and the port's:

  * the tiny CRCTModel's training forward (loss, nsp_loss) and every
    parameter's gradient, against jax.value_and_grad of the JAX model on
    its Pallas path in interpret mode (the kernels' VJP);
  * the optimizer: the four group labels, the schedule, and whole train
    steps (forward, backward, 4-group AdamW, the 9-slot metrics) against
    crct_tpu.train.train_loop.make_train_step, also with -opt_bf16_m and
    with batch_multiply = 2 against optax.MultiSteps;
  * the DataLoader's batches over two epochs;
  * the Trainer on synthetic data on the CPU: checkpoints, transfer and
    continue, the NaN guard, -max_checkpoints, and the CLI's refusals.

Dropout is off where the port meets JAX: the tiny config's dropout
probabilities are 0, the JAX forward runs with deterministic=True, and the
port's fixed 0.1 dropout on the pooled fusion is switched off by patching
DropoutRNG.dropout (the two frameworks cannot draw the same hidden masks;
the attention kernels' masks are held seed for seed in
tests/test_torch_attention_bwd.py).

Tolerances: the loss within 1e-5 relative; each gradient within 1e-4 of
its largest magnitude, or of 1e-6 where it is smaller (fp32 in both, the
LayerNorm variance taken in two ways, see tests/test_torch_model.py);
parameters after AdamW updates of ~1e-3 within 2e-6 absolute (Adam divides
by sqrt(nu), which turns a 1e-5 relative gradient difference into ~1e-5 of
an update); with bf16 first moments the same after one step and 2e-4 (a
tenth of an update of the image group's 2e-3) after three: a gradient that
differs in its last bits can round a moment to the neighbouring bf16 value,
0.4 % of the moment, and a parameter whose gradient changes sign between
steps turns that into a larger share of its update. The optimizer alone,
fed the same gradients as optax, gives the same parameters within 1e-7 in
both precisions. Metrics within 1e-5 relative.
"""

import dataclasses
import functools
import glob
import json
import os
import signal

import jax
import numpy as np
import optax
import pytest
import torch

from crct_tpu.data.dataset import ChartQADataset as JaxDataset
from crct_tpu.data.dataset import DataLoader as JaxLoader
from crct_tpu.models.crct import CRCTModel as JaxCRCTModel
from crct_tpu.train import optimizer as jax_opt
from crct_tpu.train.train_loop import make_train_step as jax_make_train_step
from crct_tpu_torch.config import CRCTModelConfig, default_params
from crct_tpu_torch.data.dataset import ChartQADataset, DataLoader
from crct_tpu_torch.models import layers
from crct_tpu_torch.models.crct import CRCTModel
from crct_tpu_torch.train import optimizer as port_opt
from crct_tpu_torch.train.train_loop import (Trainer, make_train_step,
                                             run_training)
from crct_tpu_torch.utils import checkpoint as ckpt
from crct_tpu_torch.utils.convert import flax_to_state_dict
from tests.helpers import synthetic_params, tiny_model_config
from tests.test_torch_model import make_batch, random_params

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  v_hidden_dropout_prob=0.0,
                  v_attention_probs_dropout_prob=0.0)
OPT = dict(lr=1e-3, image_lr=2e-3, min_lr=1e-5, warmup=2, wd=0.01,
           batch_multiply=1)


def train_batch(seed, ce_reg=False):
    """make_batch plus NSP labels, with regression rows whose targets lie
    inside and outside [-1, 1] (SmoothL1 zeroes the latter)."""
    b = make_batch(seed, B=6, ce_reg=ce_reg)
    b["next_sentence_labels"] = np.asarray([0, 1, 1, 0, 1, 0], np.int32)
    if not ce_reg:
        b["R"][:3] = [[5.0, 1, 0.01, 10.0], [-2.5, 1, 0.01, 10.0],
                      [30.0, 1, 0.01, 10.0]]
    return b


@pytest.fixture
def no_pooled_dropout(monkeypatch):
    monkeypatch.setattr(layers.DropoutRNG, "dropout", lambda self, x, p: x)


def port_model(jcfg, params, **kw):
    cfg = CRCTModelConfig.from_dict(dataclasses.asdict(jcfg))
    model = CRCTModel(cfg, categories=10, **kw)
    model.load_state_dict(flax_to_state_dict(params,
                                             ce_reg=kw.get("ce_reg", False)),
                          strict=True)
    return model.train()


def tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the model's training forward and gradients
# ---------------------------------------------------------------------------

VARIANTS = {"default": {}, "L1": {"use_l1": True}, "CE_REG": {"ce_reg": True}}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_forward_and_gradients_match_jax_pallas(variant, monkeypatch):
    """Loss, nsp_loss and every parameter's gradient, through the Pallas
    kernels in interpret mode on the JAX side and the kernels' plain
    versions (the autograd Function) on the port's."""
    from crct_tpu.ops import attention as A
    monkeypatch.setattr(A, "fused_attention",
                        functools.partial(A.fused_attention, interpret=True))
    monkeypatch.setattr(layers.DropoutRNG, "dropout", lambda self, x, p: x)
    kw = VARIANTS[variant]
    jcfg = tiny_model_config(use_pallas_attention=True, **NO_DROPOUT)
    jmodel = JaxCRCTModel(config=jcfg, categories=10, **kw)
    batch = train_batch(21, ce_reg=kw.get("ce_reg", False))
    params = random_params(jmodel, batch, 21)

    def loss_fn(p):
        out = jmodel.apply({"params": p}, batch, train=True,
                           deterministic=True)
        return out.loss, out.nsp_loss

    (jloss, jnsp), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    model = port_model(jcfg, params, **kw)
    out = model(tb(batch), torch.Generator().manual_seed(0))
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(out.nsp_loss.item(), float(jnsp), rtol=1e-5)
    want = flax_to_state_dict(jax.device_get(jgrads),
                              ce_reg=kw.get("ce_reg", False))
    for name, p in model.named_parameters():
        w = want[name].numpy()
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        # gradients that are zero up to rounding (the key biases: softmax
        # ignores a shift shared by a row) are held at 1e-10
        scale = max(np.abs(w).max(), 1e-6)
        np.testing.assert_allclose(g, w, atol=1e-4 * scale, rtol=0,
                                   err_msg=name)


def test_training_mode_draws_dropout_and_eval_mode_does_not():
    """With the flagship's dropout rates, a training forward depends on the
    generator's state and repeats for the same state; the eval forward is
    unchanged by any of it."""
    jcfg = tiny_model_config()
    batch = train_batch(5)
    params = random_params(JaxCRCTModel(config=jcfg, categories=10), batch, 5)
    model = port_model(jcfg, params, mask_prob_img=0.2)
    losses = [model(tb(batch), torch.Generator().manual_seed(s)).loss.item()
              for s in (1, 1, 2)]
    assert losses[0] == losses[1] != losses[2]
    model.eval()
    with torch.no_grad():
        a = model(tb(batch), torch.Generator().manual_seed(1)).nsp_logits
        b = model(tb(batch), torch.Generator().manual_seed(2)).nsp_logits
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_bf16_training_keeps_fp32_masters(tmp_path):
    """A bf16 config trains fp32 parameters under bf16 autocast: finite
    fp32 gradients, and the attention runs on bf16 activations."""
    from crct_tpu_torch.models.crct import build_model
    from crct_tpu_torch.ops import attention
    seen = []
    real = attention._Attention.apply

    def spy(q, *a):
        seen.append(q.dtype)
        return real(q, *a)

    path = tmp_path / "model.json"
    path.write_text(json.dumps(dataclasses.asdict(tiny_model_config())))
    model = build_model({"model_config": str(path), "categories": 10,
                         "bf16": True}, device="cpu", train=True)
    assert model.training
    assert all(p.dtype == torch.float32 for p in model.parameters())
    attention._Attention.apply = spy
    try:
        out = model(tb(train_batch(6)), torch.Generator().manual_seed(0))
    finally:
        attention._Attention.apply = real
    out.loss.backward()
    assert set(seen) == {torch.bfloat16}
    assert out.loss.dtype == torch.float32 and torch.isfinite(out.loss)
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert grads and all(g.dtype == torch.float32 and torch.isfinite(g).all()
                         for g in grads)


# ---------------------------------------------------------------------------
# the optimizer and whole train steps
# ---------------------------------------------------------------------------

def test_group_labels_match_jax_label_fn():
    """Every parameter falls in the group JAX's label_fn gives its flax
    path (the torch key of each path found by carrying leaf ids through
    flax_to_state_dict)."""
    jmodel = JaxCRCTModel(config=tiny_model_config(), categories=10)
    params = random_params(jmodel, train_batch(0), 0)
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    ids = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [np.full(np.shape(x), i, np.float32) for i, (_, x) in
         enumerate(leaves)])
    key_of = {int(v.reshape(-1)[0]): k
              for k, v in flax_to_state_dict(ids).items()}
    seen = set()
    for i, (path, _) in enumerate(leaves):
        want = (("lang" if jax_opt._is_language_param(path) else "image")
                + ("_decay" if jax_opt._needs_decay(path) else "_nodecay"))
        assert port_opt.group_label(key_of[i]) == want, key_of[i]
        seen.add(want)
    assert seen == set(port_opt.GROUPS)
    assert len(port_opt.language_weight_keys()) == 196


def test_schedule_matches_jax():
    pd = dict(lr=2e-5, warmup=4, min_lr=1.3e-5)
    sched = jax_opt.warmup_linear_min_schedule(2e-5, 4, 7 * 20.0, 1.3e-5)
    for step in range(11):
        assert port_opt.current_lr(pd, 7, step) == pytest.approx(
            float(sched(step)), rel=1e-6)
        assert port_opt.current_lr(pd, 7, step) == pytest.approx(
            jax_opt.current_lr(pd, 7, step), rel=1e-6)


class _Deterministic:
    """The JAX model with its fixed pooled dropout off: make_train_step
    calls model.apply(..., train=True, rngs=...)."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, batch, train, rngs):
        return self.model.apply(variables, batch, train=train,
                                deterministic=True)


@pytest.fixture(scope="module")
def step_case():
    """A tiny model's weights and three batches, shared by the step tests
    (the JAX side on its plain attention path: dropout is off, so it
    computes what the Pallas path computes, and compiles faster)."""
    jcfg = tiny_model_config(**NO_DROPOUT)
    jmodel = JaxCRCTModel(config=jcfg, categories=10)
    batches = [train_batch(30 + i) for i in range(4)]
    params = random_params(jmodel, batches[0], 30)
    return jcfg, jmodel, params, batches


def run_jax_steps(step_case, opt_params, n, every_k=1):
    jcfg, jmodel, params, batches = step_case
    tx = jax_opt.make_optimizer(opt_params, params, iters_per_epoch=5)
    if every_k > 1:
        tx = optax.MultiSteps(tx, every_k)
    step = jax.jit(jax_make_train_step(_Deterministic(jmodel), tx))
    state = tx.init(params)
    history = []
    for i in range(n):
        params, state, metrics = step(params, state, batches[i],
                                      jax.random.key(i))
        history.append((jax.device_get(params), np.asarray(metrics)))
    return history, state


def run_port_steps(step_case, opt_params, n, every_k=1):
    jcfg, _, params, batches = step_case
    model = port_model(jcfg, params)
    opt = port_opt.AdamW(list(model.named_parameters()), opt_params, 5,
                         every_k=every_k)
    step = make_train_step(model, opt)
    gen = torch.Generator().manual_seed(0)
    history = []
    for i in range(n):
        metrics = step(tb(batches[i]), gen)
        history.append(({k: v.detach().clone()
                         for k, v in model.state_dict().items()},
                        metrics.numpy()))
    return history, opt


def assert_same_params(port_sd, jax_params, atol):
    want = flax_to_state_dict(jax_params)
    assert set(want) == set(port_sd)
    for k, v in port_sd.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=atol,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("bf16_m", [False, True], ids=["fp32_m", "bf16_m"])
def test_one_and_three_steps_match_make_train_step(step_case, bf16_m,
                                                   no_pooled_dropout):
    opt_params = dict(OPT, opt_bf16_m=bf16_m)
    want, _ = run_jax_steps(step_case, opt_params, 3)
    got, opt = run_port_steps(step_case, opt_params, 3)
    for n, atol in ((0, 2e-6), (2, 2e-4 if bf16_m else 2e-6)):
        # after 1 and after 3 steps
        assert_same_params(got[n][0], want[n][0], atol)
        np.testing.assert_allclose(got[n][1], want[n][1], rtol=1e-5,
                                   atol=1e-6)
    mu_dtypes = {s["mu"].dtype for s in opt.state.values()}
    assert mu_dtypes == {torch.bfloat16 if bf16_m else torch.float32}
    assert {s["nu"].dtype for s in opt.state.values()} == {torch.float32}
    assert opt.count == 3


@pytest.mark.parametrize("bf16_m", [False, True], ids=["fp32_m", "bf16_m"])
def test_adamw_matches_optax_on_the_same_gradients(bf16_m):
    """Four groups (distinct lr and image_lr, decay and no decay), three
    updates from the same gradients: optax's chain and the port's AdamW
    give the same parameters and moments."""
    g = np.random.default_rng(1)
    shapes = {"bert/encoder/t_layer_0/ffn/inter/kernel": (8, 6),
              "bert/encoder/t_layer_0/ffn/inter/bias": (6,),
              "bert/encoder/v_layer_0/ffn/inter/kernel": (8, 6),
              "bert/encoder/v_layer_0/ffn/out_ln/scale": (8,)}
    from crct_tpu_torch.utils.convert import torch_key
    flat = {k: g.normal(size=s).astype(np.float32) for k, s in shapes.items()}

    def nest(d):
        out = {}
        for k, v in d.items():
            node = out
            *mods, leaf = k.split("/")
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = v
        return out

    opt_params = dict(OPT, opt_bf16_m=bf16_m)
    jparams = nest(flat)
    tx = jax_opt.make_optimizer(opt_params, jparams, iters_per_epoch=5)
    state = tx.init(jparams)
    named = [(torch_key(k), torch.nn.Parameter(torch.from_numpy(v.copy())))
             for k, v in flat.items()]
    opt = port_opt.AdamW(named, opt_params, 5)
    assert {port_opt.group_label(n) for n, _ in named} == set(port_opt.GROUPS)
    for _ in range(3):
        grads = {k: (g.normal(size=v.shape) * 1e-2).astype(np.float32)
                 for k, v in flat.items()}
        updates, state = tx.update(nest(grads), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for (_, p), k in zip(named, flat):
            p.grad = torch.from_numpy(grads[k])
        opt.step()
    for (name, p), k in zip(named, flat):
        node = jparams
        for m in k.split("/"):
            node = node[m]
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(node),
                                   atol=1e-7, rtol=0, err_msg=name)


def test_batch_multiply_matches_optax_multisteps(step_case,
                                                 no_pooled_dropout):
    """batch_multiply = 2: the mean of two mini-step gradients feeds one
    update; parameters stand still on the first mini-step; the schedule
    counts updates."""
    want, _ = run_jax_steps(step_case, OPT, 4, every_k=2)
    got, opt = run_port_steps(step_case, OPT, 4, every_k=2)
    initial = flax_to_state_dict(step_case[2])
    for k, v in got[0][0].items():
        torch.testing.assert_close(v, initial[k], atol=0, rtol=0)
    for n in (1, 3):
        assert_same_params(got[n][0], want[n][0], 2e-6)
    for n in range(4):
        np.testing.assert_allclose(got[n][1], want[n][1], rtol=1e-5,
                                   atol=1e-6)
    assert opt.count == 2 and opt.mini_step == 0


# ---------------------------------------------------------------------------
# data loading and the Trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train")
    jparams = synthetic_params(root, n_images=8, division=4, n_questions=4,
                               feat_dim=32)
    keys = ("figure_feat_path", "qa_parent_dir", "dataset_config",
            "max_seq_len", "max_vis_features", "categories", "save_path")
    params = default_params(**{k: jparams[k] for k in keys})
    return root, jparams, params


@pytest.mark.parametrize("num_workers", [1, 2], ids=["thread", "process"])
def test_loader_batches_equal_jax_over_two_epochs(data_env, num_workers):
    _, jparams, params = data_env
    jds, ds = JaxDataset(jparams, ["train"]), ChartQADataset(params, ["train"])
    jl = JaxLoader(jds, 8, shuffle=True, seed=3, num_workers=1,
                   drop_last=True)
    pl = DataLoader(ds, 8, shuffle=True, seed=3, num_workers=num_workers,
                    drop_last=True)
    try:
        assert len(pl) == len(jl) == len(ds) // 8
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            n = 0
            for jb, pb in zip(jl, pl):
                assert set(jb) == set(pb)
                for k in jb:
                    if isinstance(jb[k], list):
                        assert jb[k] == pb[k], k
                    else:
                        np.testing.assert_array_equal(pb[k], jb[k],
                                                      err_msg=k)
                n += 1
            assert n == len(jl)
        # the process workers, and only they, built the batches
        assert (pl._pool is not None) == (num_workers > 1)
    finally:
        pl.close()


def trainer_params(root, tiny, **kw):
    """Port params for a CPU Trainer on the synthetic split."""
    _, jparams, params = root
    path = os.path.join(str(root[0]), "tiny.json")
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(tiny), f)
    out = dict(params, model_config=path, batch_size=8, num_workers=1,
               num_epochs=1, no_eval=True, device="cpu", **OPT)
    out.update(kw)
    return out


def test_trainer_checkpoint_transfer_and_continue(data_env, tmp_path):
    tiny = tiny_model_config(v_feature_size=32)
    params = trainer_params(data_env, tiny, save_path=str(tmp_path))
    ds = ChartQADataset(params, ["train"])
    ds.split = "train"
    loader = DataLoader(ds, 8, shuffle=True, num_workers=1)
    trainer = Trainer(params, None, len(loader), device="cpu")
    for batch in list(loader)[:2]:
        m = trainer.run_step(batch).numpy()
        assert m.shape == (9,) and np.isfinite(m).all()
    path = trainer.save(epoch=3)
    assert os.path.basename(path) == ckpt.checkpoint_name(3, 2) \
        == "plotqa_encoder_3_2.ckpt"
    assert ckpt.epoch_from_name(path) == 3

    # the file holds the reference layout, which the port's reader takes
    from crct_tpu_torch.utils.convert import load_torch_checkpoint
    raw = torch.load(path, map_location="cpu", weights_only=False)
    assert all(k.startswith("bert_pretrained.")
               for k in raw["model_state_dict"])
    sd = load_torch_checkpoint(path)
    want = trainer.model.state_dict()
    assert set(sd) == set(want)

    # transfer: parameters only, a fresh optimizer and step
    moved = Trainer(dict(params, start_checkpoint=path), None, len(loader),
                    device="cpu")
    cont = Trainer(dict(params, start_checkpoint=path, **{"continue": True}),
                   None, len(loader), device="cpu")
    for k, v in want.items():
        torch.testing.assert_close(moved.model.state_dict()[k], v, atol=0,
                                   rtol=0)
        torch.testing.assert_close(cont.model.state_dict()[k], v, atol=0,
                                   rtol=0)
    assert (moved.step, moved.start_epoch, moved.optimizer.count) == (0, 0, 0)
    # continue: the optimizer's moments and counts, the step, the epoch
    assert (cont.step, cont.start_epoch, cont.optimizer.count) == (2, 4, 2)
    for name, slots in trainer.optimizer.state.items():
        for slot in ("mu", "nu"):
            torch.testing.assert_close(cont.optimizer.state[name][slot],
                                       slots[slot], atol=0, rtol=0)
    # the same next step from the original and the continued trainer
    cont.generator.set_state(trainer.generator.get_state())
    batch = next(iter(loader))
    torch.testing.assert_close(cont.run_step(batch), trainer.run_step(batch),
                               atol=0, rtol=0)


def test_run_training_nan_guard(data_env, tmp_path):
    """A non-finite loss halts training with a diagnostic checkpoint and
    leaves the SIGTERM handler as it was; -no_nan_guard trains on."""
    import shutil
    root = tmp_path / "poisoned"
    shutil.copytree(data_env[2]["figure_feat_path"], root / "feats")
    tiny = tiny_model_config(v_feature_size=32)
    params = trainer_params(data_env, tiny, save_path=str(tmp_path / "out"),
                            figure_feat_path=str(root / "feats") + "/")
    for fpath in glob.glob(str(root / "feats" / "train" / "*.npy")):
        shard = np.load(fpath, allow_pickle=True)
        for rec in shard:
            rec["vis_feat"] = np.full_like(rec["vis_feat"], np.nan)
        np.save(fpath, shard, allow_pickle=True)
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(RuntimeError, match="NaN guard"):
        run_training(params, ChartQADataset(params, ["train"]), device="cpu")
    assert signal.getsignal(signal.SIGTERM) is before
    diags = glob.glob(str(tmp_path / "out" / "NANDIAG_step*.ckpt"))
    assert len(diags) == 1
    assert "model_state_dict" in ckpt.load_checkpoint(diags[0])
    params["no_nan_guard"] = True
    trainer = run_training(params, ChartQADataset(params, ["train"]),
                           device="cpu")
    assert trainer.step == len(ChartQADataset(params, ["train"])) // 8


def test_max_checkpoints_keeps_the_newest(data_env, tmp_path):
    tiny = tiny_model_config(v_feature_size=32)
    params = trainer_params(data_env, tiny, save_path=str(tmp_path),
                            max_checkpoints=2)
    trainer = Trainer(params, None, 4, device="cpu")
    for epoch in range(3):
        trainer.step += 1
        trainer.save(epoch)
    kept = sorted(ckpt.epoch_from_name(c) for c in
                  glob.glob(str(tmp_path / "plotqa_encoder_*.ckpt")))
    assert kept == [1, 2]
    names = ["plotqa_encoder_2_10.ckpt", "plotqa_encoder_2_37.ckpt",
             "plotqa_encoder_1_99.ckpt"]
    assert sorted(names, key=ckpt.epoch_iter_from_name) == [
        "plotqa_encoder_1_99.ckpt", "plotqa_encoder_2_10.ckpt",
        "plotqa_encoder_2_37.ckpt"]


def test_cli_train_refuses_what_is_not_ported(data_env):
    from crct_tpu_torch.cli.train import main
    with pytest.raises(SystemExit, match="in-train evaluation"):
        main(["-qa_file", "qa_pairs.npy", "-save_name", "x", "-device",
              "cpu"])
    with pytest.raises(SystemExit, match="-ddp"):
        main(["-qa_file", "qa_pairs.npy", "-save_name", "x", "-no_eval",
              "-ddp", "-dist_url", "tcp://x_1"])


def test_cli_train_runs_on_the_cpu_when_asked(data_env, tmp_path):
    from crct_tpu_torch.cli.train import main
    root, _, params = data_env
    cfg = dict(params["dataset_config"], main_folder="",
               figure_feat_path=params["figure_feat_path"],
               qa_parent_dir=params["qa_parent_dir"],
               save_path=str(tmp_path), max_seq_len=124,
               max_vis_features=44, categories=228)
    (tmp_path / "ds.json").write_text(json.dumps(cfg))
    tiny = tiny_model_config(v_feature_size=32)
    (tmp_path / "tiny.json").write_text(json.dumps(dataclasses.asdict(tiny)))
    trainer = main(["-qa_file", "qa_pairs.npy", "-dataset_config",
                    str(tmp_path / "ds.json"), "-model_config",
                    str(tmp_path / "tiny.json"), "-batch_size", "8",
                    "-num_epochs", "1", "-num_workers", "1", "-no_eval",
                    "-save_name", "run", "-device", "cpu"])
    assert trainer.step == len(ChartQADataset(params, ["train"])) // 8
    assert glob.glob(str(tmp_path / "run" / "plotqa_encoder_0_*.ckpt"))


def test_run_training_profiles_logs_and_stops_on_sigterm(data_env, tmp_path,
                                                         monkeypatch):
    """-profile writes a torch.profiler trace of steps 10-15, -tensorboard
    gets the scalars, and a SIGTERM stops the loop at the next step with a
    checkpoint that -continue resumes at the interrupted epoch."""
    tiny = tiny_model_config(v_feature_size=32)
    params = trainer_params(data_env, tiny, save_path=str(tmp_path / "out"),
                            num_epochs=3, profile=True,
                            tensorboard=str(tmp_path / "tb"), save_name="run")
    real_step = Trainer.run_step
    before = signal.getsignal(signal.SIGTERM)

    def step(self, batch):
        if self.step == 18:     # in the third epoch (8 steps an epoch)
            # only with run_training's handler in place: the default one
            # would end the test process
            assert signal.getsignal(signal.SIGTERM) is not before
            os.kill(os.getpid(), signal.SIGTERM)
        return real_step(self, batch)

    monkeypatch.setattr(Trainer, "run_step", step)
    trainer = run_training(params, ChartQADataset(params, ["train"]),
                           device="cpu")
    assert trainer.step == 19
    assert os.path.isfile(tmp_path / "out" / "profile" /
                          "train_steps_10_15.json")
    assert glob.glob(str(tmp_path / "tb" / "run" / "events.*"))
    saved = ckpt.checkpoint_name(1, 19)
    assert os.path.isfile(tmp_path / "out" / saved)
    resumed = Trainer(dict(params, start_checkpoint=str(tmp_path / "out" /
                                                       saved),
                           **{"continue": True}), None, 8, device="cpu")
    assert (resumed.step, resumed.start_epoch) == (19, 2)
