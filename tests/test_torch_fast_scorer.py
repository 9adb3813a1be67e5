"""The port's fast scorer against the JAX package's.

The same data and weights as tests/test_torch_eval.py (a JAX tree drawn
from a numpy seed at scale 0.3, carried across with strict=True). The fast
rows and the top-k rescore rows equal the JAX package's exactly; the head
and the fast step's outputs agree within 1e-5; evaluate()'s fast and top-k
tables and records equal the JAX package's (top-k with K covering every
candidate also equals the full protocol); the serving pred dicts equal the
JAX QAScorer's; five head-training steps match optax's adam (loss within
1e-5 relative, head parameters within 1e-6). Before comparing answers the
fixtures assert that no two of a question's JAX fast logits lie within 1e-5,
so neither an answer nor a shortlist can flip on a last-bit difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import crct_tpu.train.eval_loop as jel
from crct_tpu.data.dataset import DataLoader as JaxLoader
from crct_tpu.models.fast_scorer import FastScorer as JaxFastScorer
from crct_tpu.serve import QAScorer as JaxQAScorer
from crct_tpu.train.fast_scorer_train import \
    make_head_train_step as jax_head_step
from crct_tpu_torch.data.dataset import DataLoader
from crct_tpu_torch.models.fast_scorer import FastScorer
from crct_tpu_torch.serve import QAScorer
from crct_tpu_torch.train import eval_loop as el
from crct_tpu_torch.train.fast_scorer_train import make_head_train_step
from crct_tpu_torch.utils.convert import fast_scorer_state_dict
from tests.test_torch_eval import (QUIET, _cli_files, assert_same_records,
                                   assert_same_tables, env, jax_eval,
                                   jax_full, one_torch_thread, port_eval,
                                   port_model)

__all__ = ["env", "jax_full", "one_torch_thread"]        # module-scoped fixtures, used here


def batches(ds, loader_cls, bs=4):
    return list(loader_cls(ds, batch_size=bs, shuffle=False,
                           drop_last=False, num_workers=1))


@pytest.fixture(scope="module")
def jax_fast(env):
    """The JAX fast step's outputs on every 4-question batch, after
    asserting that no two valid logits of a question lie within 1e-5."""
    step = jax.jit(lambda p, r: env["jmodel"].apply(
        {"params": p}, r, train=False))
    outs = []
    for b in batches(env["jds"], JaxLoader):
        rows = jel.build_fast_rows(b)
        out = step(env["weights"], {k: jnp.asarray(v)
                                    for k, v in rows.items()})
        logits = np.asarray(out.cand_logits)
        for q, n in enumerate(np.asarray(b["num_ans"]).reshape(-1)):
            gaps = np.diff(np.sort(logits[q, :n]))
            assert n < 2 or gaps.min() > 1e-5, gaps.min()
        outs.append((rows, logits, np.asarray(out.reg_output)))
    return outs


def test_fast_rows_and_shortlist_rows_match_exactly(env):
    for jb, b in zip(batches(env["jds"], JaxLoader),
                     batches(env["ds"], DataLoader)):
        want, got = jel.build_fast_rows(jb), el.build_fast_rows(b)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        P = np.asarray(b["tokens"]).shape[1]
        top = np.random.default_rng(0).integers(0, P, (len(b["id"]), 5))
        for keys in (el.ROW_KEYS, el.EVAL_TEXT_KEYS):
            want = jel.shortlist_rescore_rows(jb, top, keys=keys)
            got = el.shortlist_rescore_rows(b, top, keys=keys)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_fast_scorer_head_matches_jax():
    g = np.random.default_rng(0)
    B, C, A, V, E, H = 3, 7, 8, 50, 16, 12
    fused = g.normal(size=(B, H)).astype(np.float32)
    tokens = g.integers(0, V, (B, C, A))
    tokens[g.random((B, C, A)) < 0.4] = 0
    tokens[0, 0] = 0                     # a candidate with no tokens
    valid = (g.random((B, C)) < 0.8).astype(np.float32)
    jhead = JaxFastScorer(V, emb_dim=E, hidden=H)
    params = jax.tree.map(
        lambda x: g.normal(size=x.shape).astype(np.float32) * 0.5,
        jax.eval_shape(jhead.init, jax.random.key(0), fused, tokens,
                       valid)["params"])
    want = np.asarray(jhead.apply({"params": params}, fused, tokens, valid))
    head = FastScorer(V, emb_dim=E, hidden=H)
    sd = {k[len("fast_scorer."):]: v
          for k, v in fast_scorer_state_dict(params).items()}
    head.load_state_dict(sd, strict=True)
    got = head(torch.from_numpy(fused), torch.from_numpy(tokens),
               torch.from_numpy(valid)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[valid == 0] == -1e9).all()


def test_fast_step_matches_jax(env, jax_fast):
    """make_fast_eval_step{,_dedup} on the same fast rows: candidate logits
    and regression outputs within 1e-5 of max(1, |want|)."""
    step = el.make_fast_eval_step(env["model"])
    dstep = el.make_fast_eval_step_dedup(env["model"])
    for rows, logits, reg in jax_fast:
        got = [o.numpy() for o in step(rows)]
        text = {k: v for k, v in rows.items() if k not in el.EVAL_VIS_KEYS}
        vis = {k: torch.from_numpy(rows[k]) for k in el.EVAL_VIS_KEYS}
        dgot = [o.numpy() for o in dstep(text, vis,
                                         np.arange(len(rows["tokens"])))]
        for out in (got, dgot):
            valid = rows["cand_valid"] > 0
            np.testing.assert_allclose(out[0][valid], logits[valid],
                                       rtol=1e-5, atol=1e-5)
            assert (out[0][~valid] == -1e9).all()
            np.testing.assert_allclose(out[1], reg, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", [{}, {"fast_scorer_topk": 3},
                                  {"fast_scorer_topk": 4,
                                   "eval_dedup": False}],
                         ids=["fast", "topk3", "topk4_no_dedup"])
def test_fast_and_topk_eval_match_jax(env, jax_fast, mode):
    extra = dict(mode, fast_scorer=True)
    want, jrecs = jax_eval(env, extra, csv=False)
    got, recs = port_eval(env, extra, csv=False)
    assert_same_tables(got, want)
    assert_same_records(recs, jrecs)
    assert want[0][0, 1] == len(env["ds"])


def test_topk_covering_every_candidate_is_the_full_protocol(env, jax_full):
    want, jrecs = jax_full
    got, recs = port_eval(env, {"fast_scorer": True,
                                "fast_scorer_topk": 120}, csv=False)
    assert_same_tables(got, want)
    assert_same_records(recs, jrecs)


def test_fast_serving_matches_jax_scorer(env, jax_fast):
    """QAScorer -fast_scorer and -fast_scorer_topk: the pred dicts (with
    their ``top`` lists) of the JAX QAScorer holding the same weights."""
    qas = list(env["ds"].qa["test"][:7])
    for extra in ({}, {"fast_scorer_topk": 4}, {"fast_scorer_topk": 120}):
        p = dict(env["params"], fast_scorer=True, serve_max_batch=4,
                 **extra)
        jp = dict(env["jparams"], fast_scorer=True, serve_max_batch=4,
                  **extra)
        jscorer = JaxQAScorer(jp, env["jds"], model=env["jmodel"])
        jscorer.model_params = env["weights"]
        jrecs = jscorer.score(qas, top=3)
        recs = QAScorer(p, env["ds"], model=env["model"],
                        device="cpu").score(qas, top=3)
        for r, jr in zip(recs, jrecs):
            assert r["cls_output"] == jr["cls_output"]
            assert r["is_reg"] == jr["is_reg"]
            assert r["confidence"] == pytest.approx(jr["confidence"],
                                                    abs=1e-5)
            if jr["is_reg"]:
                assert r["reg_output"] == pytest.approx(jr["reg_output"],
                                                        rel=1e-4)
            assert [t["answer"] for t in r["top"]] == \
                [t["answer"] for t in jr["top"]]
            for t, jt in zip(r["top"], jr["top"]):
                assert t["confidence"] == pytest.approx(jt["confidence"],
                                                        abs=1e-5)


# cand_proj2's bias adds q . b to every candidate's score alike, which the
# listwise softmax cancels: its gradient is zero in exact arithmetic, so
# both frameworks hand Adam rounding noise (~1e-8, below eps), whose update
# has the noise's sign. It is held to moving by at most lr a step instead.
SHIFT_ONLY = "cand_proj2.bias"


def test_head_training_steps_match_optax(env):
    """Five steps of make_head_train_step against the JAX step with
    optax.adam(1e-3) from the same head: the CE within 1e-5 relative, the
    head's parameters after each step within 1e-6 (SHIFT_ONLY: within lr a
    step of where it started, in both)."""
    lr = 1e-3
    model = port_model(env["jcfg"], env["weights"], fast_scorer=True,
                       categories=env["params"]["categories"])
    for p in model.parameters():
        p.requires_grad_(False)
    for p in model.fast_scorer.parameters():
        p.requires_grad_(True)
    opt = torch.optim.Adam(model.fast_scorer.parameters(), lr=lr,
                           betas=(0.9, 0.999), eps=1e-8)
    step = make_head_train_step(model, opt)
    tx = optax.adam(lr)
    jstep = jax_head_step(env["jmodel"], tx)
    head = jax.tree.map(jnp.array, env["weights"]["fast_scorer"])
    start = model.fast_scorer.state_dict()[SHIFT_ONLY].clone().numpy()
    frozen = {k: v for k, v in env["weights"].items() if k != "fast_scorer"}
    state = tx.init(head)
    for n, b in enumerate(batches(env["ds"], DataLoader)[:5], start=1):
        rows = el.build_fast_rows(b)
        gt = np.asarray(b["gt_id"]).reshape(-1)
        loss = float(step(rows, gt))
        head, state, jloss = jstep(head, state, frozen,
                                   {k: jnp.asarray(v)
                                    for k, v in rows.items()},
                                   jnp.asarray(gt))
        assert loss == pytest.approx(float(jloss), rel=1e-5)
        want = fast_scorer_state_dict(jax.device_get(head))
        for k, v in model.fast_scorer.state_dict().items():
            w = want["fast_scorer." + k].numpy()
            if k == SHIFT_ONLY:
                for x in (v.numpy(), w):
                    assert np.abs(x - start).max() <= n * lr * (1 + 1e-3)
                continue
            np.testing.assert_allclose(v.numpy(), w, rtol=0, atol=1e-6,
                                       err_msg=k)


def test_cli_train_fast_scorer_then_fast_eval(env, tmp_path, capsys):
    """cli.train_fast_scorer on the CPU from a backbone-only checkpoint
    (exactly the head's keys missing): the backbone saved as loaded, a
    trained head; then cli.evaluate -fast_scorer -fast_scorer_topk on its
    output."""
    from crct_tpu_torch.cli.evaluate import main as eval_main
    from crct_tpu_torch.cli.train_fast_scorer import main
    from crct_tpu_torch.utils.checkpoint import save_checkpoint
    from crct_tpu_torch.utils.convert import load_torch_checkpoint
    backbone = {k: v for k, v in env["model"].state_dict().items()
                if not k.startswith("fast_scorer.")}
    save_checkpoint(str(tmp_path / "backbone.ckpt"), backbone)
    argv = _cli_files(env, tmp_path)
    out = main(argv + ["-start_checkpoint", str(tmp_path / "backbone.ckpt"),
                       "-fs_steps", "3", "-batch_size", "16",
                       "-save_name", "fs"])
    text = capsys.readouterr().out
    assert "final CE:" in text and "warm-started" in text
    saved = load_torch_checkpoint(out)
    assert set(saved) == set(env["model"].state_dict())
    for k, v in backbone.items():
        assert torch.equal(saved[k], v), k
    head = {k: v for k, v in saved.items() if k.startswith("fast_scorer.")}
    assert len(head) == 7
    assert all(v.dtype == torch.float32 for v in head.values())
    total, _ = eval_main(argv + [
        "-eval_set", "test", "-eval_batch_size", "16", "-save_name", "ev",
        "-fast_scorer", "-fast_scorer_topk", "4", "-start_checkpoint", out])
    assert total[0, 1] == len(env["ds"])
    assert "RANDOM" not in capsys.readouterr().out
