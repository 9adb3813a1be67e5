"""The host's ms a training step in autograd's backward (the program's
``train.backward`` span: the step's thread waits in ``loss.backward()``
while autograd's thread launches the gradients' kernels), with the tracer
on and the profiler off (``perfbench/spans.py``, stretch (a))."""

from perfbench import spans


def read(state):
    return spans.by_span(state, "train.backward", "host_ms")
