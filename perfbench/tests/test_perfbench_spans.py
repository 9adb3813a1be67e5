"""The by-span table (``perfbench/spans.py``) and the readers of the span
metrics, on hand-made spans, trace events and states."""

import pytest

from perfbench import run, spans

BASE = 1_700_000_000_000_000_000          # the trace's baseTimeNanoseconds
STEP, AUTOGRAD = 11, 12                   # the step's and autograd's threads


def span(i, name, start_us, end_us, parent=None, thread=STEP):
    return {"name": name, "start_ns": BASE + int(start_us * 1000),
            "end_ns": BASE + int(end_us * 1000), "id": i, "parent": parent,
            "thread": thread, "trace": 0, "attrs": {}}


SPANS = [span(1, "train.step", 0, 100), span(2, "train.forward", 10, 40, 1),
         span(3, "fwd.text_layer", 15, 30, 2),
         span(4, "train.backward", 40, 80, 1),
         # another thread's span owns nothing
         span(5, "elsewhere", 0, 200, thread=AUTOGRAD)]


def launch(corr, ts, tid=STEP):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1.0, "tid": tid, "args": {"correlation": corr}}


def kernel(corr, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts,
            "dur": dur, "args": {"correlation": corr}}


EVENTS = [launch(1, 20), kernel(1, 25, 10),            # in fwd.text_layer
          launch(2, 50, tid=AUTOGRAD), kernel(2, 55, 15),  # backward's
          launch(5, 45, tid=AUTOGRAD), kernel(5, 65, 10),  # overlaps k2
          launch(3, 90), kernel(3, 90, 5),             # train.step's own
          launch(4, 120), kernel(4, 120, 5)]           # outside any span


def test_operations_and_gaps_go_to_the_span_open_at_their_launch():
    got = spans.attribute(SPANS, EVENTS, BASE, STEP)
    rows = got["by_span"]
    # k5 adds only the 5 us it runs past k2
    assert got["busy_us"] == pytest.approx(40.0)
    assert got["window_us"] == pytest.approx(105.0)
    assert got["unmatched"] == 0
    want = {  # device, self device, idle, self idle, launches
        "fwd.text_layer": (10, 10, 5, 5, 1),
        "train.forward": (10, 0, 25, 20, 1),
        "train.backward": (20, 20, 15, 15, 2),
        "train.step": (35, 5, 65, 25, 4),
        spans.OUTSIDE: (5, 5, 0, 0, 1)}
    assert set(rows) == set(want)
    for name, (d, sd, i, si, n) in want.items():
        r = rows[name]
        assert (r["device_us"], r["self_device_us"], r["idle_us"],
                r["self_idle_us"], r["launches"]) == pytest.approx(
                    (d, sd, i, si, n)), name
    # the self parts account for the whole trace
    assert sum(r["self_device_us"] for r in rows.values()) == \
        pytest.approx(got["busy_us"])
    assert sum(r["self_idle_us"] for r in rows.values()) == \
        pytest.approx(got["window_us"] - got["busy_us"])


def test_an_operation_with_no_launch_record_is_counted_unmatched():
    events = [kernel(9, 50, 5), launch(1, 20), kernel(1, 25, 10)]
    got = spans.attribute(SPANS, events, BASE, STEP)
    assert got["unmatched"] == 1
    assert got["by_span"]["train.backward"]["device_us"] == pytest.approx(5)


def test_host_times_take_the_spans_inside_out_of_self_time():
    got = spans.host_times(SPANS, STEP)
    assert got["train.step"] == {"calls": 1, "us": 100.0, "self_us": 30.0}
    assert got["train.forward"]["self_us"] == pytest.approx(15.0)
    assert "elsewhere" not in got


TABLE = {"by_span": {
    "train.forward": {"host_ms": 61.0, "device_ms": 20.5},
    "train.backward": {"host_ms": 70.0, "device_ms": 21.0},
    "train.optimizer": {"host_ms": 9.0, "device_ms": 12.4},
    "eval.flatten": {"host_ms": 2.0}, "eval.put_vis": {"host_ms": 1.0},
    "eval.pack": {"host_ms": 3.0}, "eval.put": {"host_ms": 4.0},
    "eval.dispatch": {"host_ms": 40.0}, "eval.fetch": {"host_ms": 900.0},
    "eval.account": {"host_ms": 5.0}},
    "counters": {"eval.rows_valid": 860, "eval.rows_launched": 960}}


@pytest.mark.parametrize("name, value", [
    ("forward_host_ms.train", 61.0), ("backward_host_ms.train", 70.0),
    ("optimizer_host_ms.train", 9.0), ("forward_device_ms.busy", 20.5),
    ("backward_device_ms.busy", 21.0), ("optimizer_device_ms.busy", 12.4),
    ("eval_row_fill_pct", 100.0 * 860 / 960), ("eval_host_ms", 55.0)])
def test_span_readers_read_the_table(name, value):
    read = run.load_module("metrics", name).read
    assert read({"spans": TABLE}) == pytest.approx(value)
    # a program without the tracer gives no table and no number
    assert read({"spans": None}) is None
