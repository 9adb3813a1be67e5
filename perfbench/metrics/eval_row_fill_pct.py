"""The share of the candidate rows that the model scores in evaluation
that are a question's candidates, not the zero padding of a chunk: the
program's counters ``eval.rows_valid`` over ``eval.rows_launched``, counted
at each chunk (``perfbench/spans.py``, stretch (a))."""

from perfbench import spans


def read(state):
    t = spans.table(state)
    counts = t["counters"] if t else {}
    if not counts.get("eval.rows_launched"):
        return None
    return 100.0 * counts.get("eval.rows_valid", 0) \
        / counts["eval.rows_launched"]
