"""BENCHMARK.json against the contract's characters, and every name in it
found as a file of the harness; the analytic work against hand counts."""

import json
import os
import re

import pytest

from perfbench import flops, gen, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_and_units_use_the_allowed_characters(bench):
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[key]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((key, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in entry:
                    assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k]
    for cell in bench["workloads"]:
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
        assert cell["chips"] in (1, 4)
    assert len(names) == len(set(names))


def test_every_name_is_a_file_the_harness_finds(bench):
    configs = {c["name"] for c in bench["configs"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for cell in bench["workloads"]:
        assert cell["config"] in configs
        mix = run.load_json(run.HERE, "mixes", f"{cell['traffic']}.json")
        assert os.path.exists(os.path.join(run.HERE, "traffic",
                                           f"{mix['driver']}.py"))
        assert os.path.exists(os.path.join(run.HERE, "limits",
                                           f"{cell['name']}.json"))
        reported = {m["name"] for m in run.for_cell(bench["end_to_end"],
                                                    cell["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        layer = run.for_cell(bench["per_layer"], cell["name"], reported)
        assert layer
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(run.ROOT, c["file"]))
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert hasattr(run.load_module("metrics", m["name"]), "read")


def test_train_flops_equal_the_ports_bench_count():
    """9.695 TFLOP a PlotQA step at batch 80, the port's
    ``bench.analytic_train_flops``."""
    from crct_tpu_torch.bench import analytic_train_flops
    cfg = run.load_json(run.HERE, "configs", "crct-plotqa.json")
    assert flops.train_step_flops(cfg, 80) == pytest.approx(
        analytic_train_flops(), rel=1e-12)
    assert flops.train_step_flops(cfg, 80) == pytest.approx(9.695e12,
                                                            rel=1e-4)


def test_attention_work_by_hand():
    cfg = run.load_json(run.HERE, "configs", "crct-plotqa.json")
    calls = dict(flops.attention_calls(cfg, 80))
    assert calls == {(80, 16, 124, 124, 48): 12, (80, 16, 44, 44, 64): 6,
                     (80, 32, 124, 44, 32): 6, (80, 32, 44, 124, 32): 6}
    # text self-attention forward: q k^T and P v, 2 * 80*16*124*124*48 each
    f, b = flops.attention_work((80, 16, 124, 124, 48), 2, False)
    assert f == 4 * 80 * 16 * 124 * 124 * 48
    assert b == 4 * 80 * 16 * 124 * 48 * 2 + 4 * 80 * 124
    f, b = flops.attention_work((80, 32, 44, 124, 32), 2, True)
    assert f == 10 * 80 * 32 * 44 * 124 * 32
    assert b == (2 * 80 * 32 * 44 * 32 + 2 * 80 * 32 * 124 * 32) * 4 \
        + 4 * 80 * 124
    fq = run.load_json(run.HERE, "configs", "crct-figureqa.json")
    assert dict(flops.attention_calls(fq, 80)) == {
        (80, 16, 64, 64, 48): 12, (80, 16, 70, 70, 64): 6,
        (80, 32, 64, 70, 32): 6, (80, 32, 70, 64, 32): 6}


def test_eval_candidates_are_those_of_the_ports_synthetic_charts():
    """The eval mix's candidates a question against what the port's
    synthetic PlotQA charts give through its candidate rule
    (``get_possible_answers``), counted over 900 charts; and each loader
    batch's counts against the distribution."""
    import collections

    import numpy as np

    from crct_tpu_torch.config import default_params
    from crct_tpu_torch.data.example_builder import ExampleBuilder
    from crct_tpu_torch.data.synthetic import make_fig_feat
    from crct_tpu_torch.data.tokenizer import WordPieceTokenizer
    mix = run.load_json(run.HERE, "mixes", "eval-full.json")
    dist = gen.fanout_distribution(mix["candidates"])
    builder = ExampleBuilder(default_params(), WordPieceTokenizer.synthetic())
    rng = np.random.default_rng(0)
    n = 900
    seen = collections.Counter(
        len(builder.get_possible_answers(make_fig_feat(i, rng, feat_dim=8)))
        for i in range(n))
    assert set(seen) == set(dist)
    for k, p in dist.items():
        assert abs(seen[k] / n - p) < 0.04, (k, seen[k] / n, p)
    per = gen.fanouts(mix["candidates"], mix["question_batch"])
    assert sorted(per) == [41] * 2 + [42] * 5 + [43] * 6 + [44] * 5 + [45] * 2
    assert sum(per) / len(per) == 43


@pytest.mark.parametrize("name, state, value", [
    ("device_idle_pct.train",
     {"steps": 300, "window_s": 40.5, "trace_steps": 10}, 51.1111111),
    ("device_busy_ms.train",
     {"steps": 300, "window_s": 40.5, "trace_steps": 10}, 66.0),
    ("device_idle_pct.eval",
     {"batches": 40, "window_s": 40.0, "trace_batches": 3}, 78.0),
])
def test_device_readers_take_busy_time_against_the_untraced_window(
        name, state, value):
    """Busy time from the traced stretch (0.66 s over its steps or
    batches), the time a step or batch from the untraced window."""
    state = dict(state, trace={"busy_s": 0.66, "window_s": 2.0})
    assert run.load_module("metrics", name).read(state) == pytest.approx(
        value)


def test_figureqa_train_reports_the_cards_busy_time_end_to_end(bench):
    """The host's rate and tail spread past any bound in figureqa-train:
    there the card's busy time a step is the end-to-end metric, every
    per-layer metric moves it, and the host's two numbers are read per
    layer from the window."""
    e2e = {m["name"] for m in run.for_cell(bench["end_to_end"],
                                           "figureqa-train")}
    assert e2e == {"setup_s", "train_busy_ms_per_step"}
    layer = run.for_cell(bench["per_layer"], "figureqa-train", e2e)
    assert {m["moves"] for m in layer} == {"train_busy_ms_per_step"}
    state = {"steps": 300, "window_s": 40.5, "batch": 80,
             "step_ms_p95": 151.25}
    read = {m["name"]: run.load_module("metrics", m["name"]).read
            for m in layer}
    assert read["train_qa_pairs_per_s.host"](state) == pytest.approx(
        300 * 80 / 40.5)
    assert read["train_step_ms_p95.host"](state) == 151.25
