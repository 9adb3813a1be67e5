"""The port's tracer (``crct_tpu_torch/utils/tracing.py``) on the CPU: off
it records nothing, on it leaves the train step and ``evaluate()`` bit for
bit as they were, its spans nest as the layers do, its counters count the
eval rows, and its stamps land on torch.profiler's clock."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from crct_tpu_torch import bench
from crct_tpu_torch.train import eval_loop as el
from crct_tpu_torch.utils import tracing
from tests.helpers import tiny_model_config

STEP_CHILDREN = ["train.forward", "train.backward", "train.allreduce",
                 "train.optimizer", "train.metrics"]
EVAL_PHASES = ["eval.flatten", "eval.put_vis", "eval.pack", "eval.put",
               "eval.dispatch", "eval.fetch", "eval.account"]


@pytest.fixture(autouse=True)
def quiet_tracer():
    """Each test starts and ends with the tracer off and empty; tiny
    models take two of torch's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()
    torch.set_num_threads(n)


def train_steps(traced: bool, steps: int = 2):
    """``steps`` tiny train steps on the CPU: the metric vectors, the last
    gradients, the parameters after them and what the tracer recorded."""
    model, _, step, batch, generator = bench.train_state(
        tiny_model_config(), "cpu", batch=4)
    if traced:
        tracing.enable()
    metrics = [step(batch, generator) for _ in range(steps)]
    tracing.disable()
    return (metrics, {n: p.grad for n, p in model.named_parameters()},
            {n: p.detach() for n, p in model.named_parameters()},
            tracing.drain())


def test_the_tracer_off_records_nothing():
    assert tracing.span("a") is tracing.span("b", layer=1, trace=3)
    tracing.count("eval.rows_valid", 7)
    *_, recorded = train_steps(traced=False, steps=1)
    assert recorded == {"spans": [], "counters": {}, "dropped": 0}


def test_the_buffer_is_bounded_and_counts_what_it_turns_away(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    tracing.enable()
    for i in range(5):
        with tracing.span("s", trace=i):
            pass
    recorded = tracing.drain()
    assert [s["trace"] for s in recorded["spans"]] == [0, 1, 2]
    assert recorded["dropped"] == 2
    assert tracing.drain()["spans"] == []


def test_train_step_spans_nest_and_leave_the_step_bit_equal():
    m0, g0, p0, _ = train_steps(traced=False)
    m1, g1, p1, recorded = train_steps(traced=True)
    for a, b in zip(m0, m1):
        assert torch.equal(a, b)
    for name in p0:
        assert torch.equal(p0[name], p1[name]), name
        assert (g0[name] is None) == (g1[name] is None), name
        if g0[name] is not None:
            assert torch.equal(g0[name], g1[name]), name
    spans = recorded["spans"]
    by_id = {s["id"]: s for s in spans}
    roots = [s for s in spans if s["parent"] is None]
    assert [(s["name"], s["trace"]) for s in roots] == [("train.step", 0),
                                                        ("train.step", 1)]
    cfg = tiny_model_config()
    for root in roots:
        children = [s for s in spans if s["parent"] == root["id"]]
        assert [s["name"] for s in children] == STEP_CHILDREN
        for a, b in zip(children, children[1:]):
            assert a["end_ns"] <= b["start_ns"]
        forward = children[0]
        inside = [s for s in spans if s["trace"] == root["trace"]
                  and s["name"].startswith("fwd.")]
        assert all(by_id[s["parent"]] is forward for s in inside)
        names = [s["name"] for s in inside]
        assert names[0] == "fwd.embed" and names[-1] == "fwd.loss"
        layers = {k: sorted(s["attrs"]["layer"] for s in inside
                            if s["name"] == k)
                  for k in ("fwd.text_layer", "fwd.vision_layer",
                            "fwd.coattn")}
        assert layers == {
            "fwd.text_layer": list(range(cfg.num_hidden_layers)),
            "fwd.vision_layer": list(range(cfg.v_num_hidden_layers)),
            "fwd.coattn": list(range(len(cfg.v_biattention_id)))}
        assert names.count("fwd.heads") == 3
        assert all(root["start_ns"] <= s["start_ns"] <= s["end_ns"]
                   <= root["end_ns"] for s in inside)


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    cfg = tiny_model_config()
    params, ds = bench.synthetic_eval_setup(
        str(tmp_path_factory.mktemp("eval")), cfg, 6, 24)
    batches = bench.materialize(ds, 2)[:3]      # ~40 candidates a question
    return params, ds, batches, bench.eval_model(cfg, "cpu", seed=4)


def run_eval(eval_setup, traced: bool):
    params, ds, batches, model = eval_setup
    preds = []
    if traced:
        tracing.enable()
    tables = el.evaluate(batches, ds, dict(params), model, csv=False,
                         log_print=lambda m: None,
                         on_predictions=preds.extend)
    tracing.disable()
    return tables, preds, tracing.drain()


def test_evaluate_spans_every_phase_by_batch_and_counts_its_rows(
        eval_setup):
    _, _, batches, _ = eval_setup
    tables0, preds0, _ = run_eval(eval_setup, traced=False)
    tables1, preds1, recorded = run_eval(eval_setup, traced=True)
    for a, b in zip(tables0, tables1):
        assert np.array_equal(a, b)
    assert preds0 == preds1
    spans = recorded["spans"]
    for phase in EVAL_PHASES:
        assert {s["trace"] for s in spans if s["name"] == phase} == \
            set(range(len(batches))), phase
    by_id = {s["id"]: s for s in spans}
    assert all(by_id[s["parent"]]["name"] == "eval.dispatch"
               for s in spans if s["name"] == "fwd.embed")
    chunks = sum(s["name"] == "eval.dispatch" for s in spans)
    rows = sum(int(np.asarray(b["num_ans"]).sum()) for b in batches)
    assert recorded["counters"] == {"eval.rows_valid": rows,
                                    "eval.rows_launched": chunks * 24}
    assert rows < chunks * 24


def test_a_span_lands_on_the_profilers_clock(tmp_path):
    """Spans around ``record_function`` ranges hold the profiler's records
    of them, on the trace's clock; the best of 15 lies within 20 us of
    its span on each side (the first range of a profile takes tens of us
    to open, and the machine's other processes may preempt any one)."""
    slack = []
    for i in range(5):
        tracing.enable()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                with tracing.span("probe"):
                    with record_function("probe_range"):
                        torch.ones(8).sum()
        tracing.disable()
        path = tmp_path / f"trace{i}.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
        ranges = [e for e in trace["traceEvents"]
                  if e.get("name") == "probe_range"
                  and e.get("cat") == "user_annotation"]
        spans = tracing.chrome_events(tracing.drain()["spans"],
                                      int(trace["baseTimeNanoseconds"]))
        assert len(ranges) == len(spans) == 3
        for ev, sp in zip(sorted(ranges, key=lambda e: e["ts"]), spans):
            before = ev["ts"] - sp["ts"]
            after = sp["ts"] + sp["dur"] - (ev["ts"] + ev["dur"])
            assert before >= 0 and after >= 0, (before, after)
            slack.append(max(before, after))
    assert min(slack) < 20.0, slack
