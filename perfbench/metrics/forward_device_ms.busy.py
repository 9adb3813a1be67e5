"""The card's busy ms a training step in the operations launched while
the program's ``train.forward`` span was open on the step's thread
(``perfbench/spans.py``, stretch (b): the profiler's trace, CUDA activity
only, each operation matched to its launch call by correlation id, from
whichever host thread); the spans inside it included."""

from perfbench import spans


def read(state):
    return spans.by_span(state, "train.forward", "device_ms")
