"""The host's ms a training step in the model's forward (the program's
``train.forward`` span: the forward's operations dispatched, its kernels
launched, its dropout drawn), with the tracer on and the profiler off
(``perfbench/spans.py``, stretch (a)); the spans inside it included."""

from perfbench import spans


def read(state):
    return spans.by_span(state, "train.forward", "host_ms")
