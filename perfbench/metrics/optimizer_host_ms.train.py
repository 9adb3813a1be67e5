"""The host's ms a training step in AdamW's step (the program's
``train.optimizer`` span: its ``_foreach`` chains over the parameter
groups), with the tracer on and the profiler off (``perfbench/spans.py``,
stretch (a))."""

from perfbench import spans


def read(state):
    return spans.by_span(state, "train.optimizer", "host_ms")
