"""The card's busy time a training step, in ms: the seconds in which an
operation ran on the card in the profiler's trace of the stretch after the
window, over its steps. The device's side of the step, which the host's
speed moves far less than the window's rate."""


def read(state):
    t = state["trace"]
    if t["busy_s"] <= 0:
        return None
    return 1e3 * t["busy_s"] / state["trace_steps"]
