"""Whole runs: a run with no card prints no result; on the CPU at tiny
widths the rest of a run, with its timed path broken underneath, comes out
not correct; the controls fail the cells' limits. Tests that need the card
take the ``card`` fixture and skip without one; on the card:
``python -m pytest perfbench/tests -q``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import common, run
from perfbench.tests import tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest perfbench/tests "
                    "on a machine with one")
    return torch.device("cuda", 0)


def outcome(ctx, result):
    """``correct`` as run.main decides it."""
    return bool(result["correct"]) and all(
        v == v and v <= lim for _, v, lim in result["checks"])


def test_a_run_with_no_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    proc = subprocess.run(
        [sys.executable, os.path.join(run.HERE, "run.py"), "--workload",
         "plotqa-train", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=run.ROOT)
    assert proc.returncode != 0
    assert '"correct": true' not in proc.stdout
    assert proc.stdout.strip() == ""


def test_a_run_that_loaded_jax_is_refused(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run.common.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setitem(sys.modules, "crct_tpu_torch_x", sys)
    assert run.common.forbidden_modules() == []


# The tiny train runs hold the port in fp32: at hidden 32 the bf16 NSP
# logits of all rows of a batch round alike, so with as many positive as
# negative labels the NSP bias's gradient cancels to exactly 0 in bf16 and
# not in the fp32 reference (a gap of 1 on that leaf). At the cells' widths
# the logits differ from row to row and the chip runs read 0.5-3 % there.
@pytest.mark.parametrize("cell", ["plotqa-train", "figureqa-train"])
def test_a_sound_tiny_train_run_is_correct(cell):
    ctx = tiny.context(cell, dtype="float32")
    result = run.load_module("traffic", "train").run(ctx)
    assert outcome(ctx, result), result["checks"]


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    from crct_tpu_torch.train import optimizer
    monkeypatch.setattr(optimizer.AdamW, "_update",
                        lambda self, g, names, grads: None)
    ctx = tiny.context("plotqa-train", dtype="float32")
    result = run.load_module("traffic", "train").run(ctx)
    assert not outcome(ctx, result)
    assert dict((k, v) for k, v, _ in result["checks"])["change_gap"] \
        == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    from crct_tpu_torch.train import train_loop
    real = train_loop.make_train_step

    def halved(model, opt):
        step = real(model, opt)
        return lambda batch, g: step(
            {k: v[:len(v) // 2] for k, v in batch.items()}, g)

    monkeypatch.setattr(train_loop, "make_train_step", halved)
    ctx = tiny.context("plotqa-train", dtype="float32")
    result = run.load_module("traffic", "train").run(ctx)
    assert not outcome(ctx, result), result["checks"]


def test_a_sound_tiny_eval_run_is_correct():
    ctx = tiny.context("plotqa-eval")
    result = run.load_module("traffic", "eval").run(ctx)
    assert outcome(ctx, result), result["checks"]
    assert result["attempted"] > 0


def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
    """One candidate's NSP logit moved in the program's output: its
    probability and the question's answer come out wrong."""
    from crct_tpu_torch.models import crct
    real = crct.CRCTModel._heads

    def altered(self, batch, hw_0, hv_0, nsp_logits):
        out = real(self, batch, hw_0, hv_0, nsp_logits)
        out.nsp_logits = out.nsp_logits.clone()
        out.nsp_logits[0, 0] += 1.0
        return out

    monkeypatch.setattr(crct.CRCTModel, "_heads", altered)
    ctx = tiny.context("plotqa-eval")
    result = run.load_module("traffic", "eval").run(ctx)
    assert not outcome(ctx, result), result["checks"]


def test_the_fp8_control_fails_a_tiny_train_cell():
    """The reference in fp8 in the program's place, at tiny widths, fails
    one of plotqa-train's numbers; the card reads it at the cell's size
    (``test_controls_fail_at_the_cells_size``)."""
    ctx = tiny.context("plotqa-train")
    readings, = run.load_module("traffic", "train").calibrate(ctx, [21])
    assert any(readings["control_fp8"][k] > lim
               for k, lim in ctx.limits.items()), readings


@pytest.mark.parametrize("cell,control", [("plotqa-train", "control_fp8"),
                                          ("figureqa-train", "control_fp8"),
                                          ("plotqa-eval", "control_tf32")])
def test_controls_fail_at_the_cells_size(card, cell, control):
    """The control at the cell's own size on three seeds: each reading
    fails one of the cell's numbers, and the program's passes."""
    import argparse
    b = tiny.bench()
    c = next(x for x in b["workloads"] if x["name"] == cell)
    ctx = run.Context(b, c, argparse.Namespace(seed=0, seconds=1, trace=0),
                      card)
    drv = run.load_module("traffic", ctx.mix["driver"])
    for r in drv.calibrate(ctx, [31, 32, 33]):
        assert any(r[control][k] > lim for k, lim in ctx.limits.items()), r
        assert all(r["program"][k] <= lim for k, lim in ctx.limits.items()), r
        print(json.dumps(r))
        assert np.isfinite(list(r["program"].values())).all()


def test_queued_seconds_reads_a_sleep_kernel(card):
    """A call that holds the card ~1 ms, timed as the rooflines time the
    attention entry, reads the length of the same sleep alone; a call that
    waits for the card gives no reading."""
    cycles = 2_000_000
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda._sleep(cycles)
    marks[0].record()
    torch.cuda._sleep(cycles)
    marks[1].record()
    torch.cuda.synchronize(card)
    alone = 1e-3 * marks[0].elapsed_time(marks[1])
    got = common.queued_seconds(lambda: torch.cuda._sleep(cycles), card)
    assert got == pytest.approx(alone, rel=0.05)

    def waits():
        torch.cuda._sleep(cycles)
        torch.cuda.synchronize(card)
    assert common.queued_seconds(waits, card, tries=2) is None
