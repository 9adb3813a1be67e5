"""The host's ms a loader batch of evaluation in the ``eval.*`` spans but
``eval.fetch``, the outputs' copy back (flatten, the visual arrays' and
the chunks' transfers, packing, the model's launches and the accounting),
with the tracer on and the profiler off (``perfbench/spans.py``, stretch
(a)). A blocking copy inside the model's forward makes the host wait for
the card within ``eval.dispatch``, and that wait counts here."""

from perfbench import spans

PHASES = ("eval.flatten", "eval.put_vis", "eval.pack", "eval.put",
          "eval.dispatch", "eval.account")


def read(state):
    t = spans.table(state)
    if not t or not any(p in t["by_span"] for p in PHASES):
        return None
    return sum(t["by_span"].get(p, {}).get("host_ms", 0.0) for p in PHASES)
