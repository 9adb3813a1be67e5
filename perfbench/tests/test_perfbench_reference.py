"""The benchmark's plain reference against the port on the CPU, at tiny
widths: parameter layout, train steps with AdamW, eval scores."""

import numpy as np
import pytest
import torch

from perfbench import gen, program, reference, run
from perfbench.tests import tiny


@pytest.mark.parametrize("config", ["crct-plotqa", "crct-figureqa"])
def test_param_spec_is_the_programs_state_dict(config):
    from crct_tpu_torch.config import CRCTModelConfig
    from crct_tpu_torch.models.crct import CRCTModel
    cfg = run.load_json(run.HERE, "configs", f"{config}.json")
    d = cfg["dataset"]
    with torch.device("meta"):
        m = CRCTModel(CRCTModelConfig.from_dict(dict(cfg["model"])),
                      categories=d["categories"], dataset=d["dataset"],
                      binary_answers=d["binary_answers"])
    ours = {n: tuple(s) for n, s, _ in reference.param_spec(cfg)}
    theirs = {n: tuple(t.shape) for n, t in m.state_dict().items()}
    assert ours == theirs


@pytest.mark.parametrize("cell", ["plotqa-train", "figureqa-train"])
def test_fp32_train_steps_match_the_program(cell):
    """Three AdamW steps with dropout: the port in fp32 and the reference
    draw the same masks and agree to fp32 rounding."""
    from perfbench.traffic import train
    ctx = tiny.context(cell, dtype="float32")
    feed = train.Feed(ctx.cfg, ctx.mix, 3, ctx.device)
    prog = train.Program(ctx, 3).first_steps(feed)
    ref = train.reference_steps(ctx, 3, feed)
    np.testing.assert_allclose(prog["losses"], ref["losses"], rtol=1e-5)
    numbers = dict(train.gaps(prog, ref,
                              train.reference_steps(ctx, 3, feed, "bf16")))
    assert numbers["grad_gap"] < 1e-3 and numbers["change_gap"] < 1e-3, \
        numbers


def test_adamw_update_matches_the_programs():
    from crct_tpu_torch.train.optimizer import AdamW
    g = torch.Generator().manual_seed(0)
    p = torch.nn.Parameter(torch.randn(64, 8, generator=g))
    b = torch.nn.Parameter(torch.randn(8, generator=g))
    hp = dict(lr=2e-5, image_lr=2e-5, min_lr=1.3e-5, warmup=3000, wd=0.01)
    opt = AdamW([("w.weight", p), ("w.bias", b)], hp, 1000)
    W = {"w.weight": p.detach().clone(), "w.bias": b.detach().clone()}
    for step in range(3):
        grads = [torch.randn(t.shape, generator=g) for t in (p, b)]
        p.grad, b.grad = grads
        opt.step()
        lr = reference.lr_at(dict(hp, t_total=20000.0), step)
        if step == 0:
            mu = {k: torch.zeros_like(v) for k, v in W.items()}
            nu = {k: torch.zeros_like(v) for k, v in W.items()}
        for (k, v), gr in zip(W.items(), grads):
            mu[k] = 0.1 * gr + 0.9 * mu[k]
            nu[k] = 0.999 * nu[k] + 0.001 * gr * gr
            c1 = 1 - 0.9 ** (step + 1)
            c2 = 1 - 0.999 ** (step + 1)
            upd = mu[k] / c1 / ((nu[k] / c2).sqrt() + 1e-8)
            if reference.needs_decay(k):
                upd = upd + 0.01 * v
            v -= lr * upd
    torch.testing.assert_close(p.detach(), W["w.weight"], rtol=1e-6, atol=1e-8)
    torch.testing.assert_close(b.detach(), W["w.bias"], rtol=1e-6, atol=1e-8)


def test_eval_scores_match_the_program():
    """The reference's per-row NSP probability and regression output equal
    the port's eval model's, in fp32, on the pool's candidate rows."""
    ctx = tiny.context("plotqa-eval")
    W = gen.make_weights(ctx.cfg, 5, "cpu")
    model = program.model(ctx.cfg, W, "cpu", "float32", train=False)
    qs = gen.EvalQuestions(ctx.cfg, 5, 8, 4,
                           {"fixed": 3, "uniform": [[0, 6]]})
    rows = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in qs.rows(2).items()}
    with torch.inference_mode():
        out = model(rows)
    ref = reference.score_rows(ctx.cfg, W, rows)
    torch.testing.assert_close(torch.softmax(out.nsp_logits, -1)[:, 0],
                               ref["nsp_prob"], rtol=0, atol=1e-6)
    torch.testing.assert_close(out.reg_output, ref["reg_output"], rtol=1e-5,
                               atol=1e-6)


def test_precisions_of_the_controls_round_as_stated():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -10 + 2 ** -12, 3.0])
    assert reference._tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 3.0]
    y = torch.tensor([448.0, 1.0625, 0.0])
    assert reference._fp8(y).tolist() == [448.0, 1.0, 0.0]
