"""The share of an untraced loader batch of evaluation in which no
operation ran on the card (rank 0's card where there are several): one
less the card's busy time a batch, from the profiler's trace of the
batches after the window, over the window's own time a batch."""


def read(state):
    t = state["trace"]
    if t["busy_s"] <= 0 or not state["batches"]:
        return None
    busy = t["busy_s"] / state["trace_batches"]
    batch = state["window_s"] / state["batches"]
    return 100.0 * (1.0 - busy / batch)
