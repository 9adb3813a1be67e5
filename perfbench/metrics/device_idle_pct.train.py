"""The share of an untraced training step in which no operation ran on the
card (rank 0's card where there are several): one less the card's busy
time a step, from the profiler's trace of the stretch after the window,
over the window's own time a step. The profiler slows the host's dispatch,
so the traced stretch's own length would read the idle share too high."""


def read(state):
    t = state["trace"]
    if t["busy_s"] <= 0 or not state["steps"]:
        return None
    busy = t["busy_s"] / state["trace_steps"]
    step = state["window_s"] / state["steps"]
    return 100.0 * (1.0 - busy / step)
