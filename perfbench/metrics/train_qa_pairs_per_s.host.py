"""QA pairs trained a second over the window, on the host's clock: the
end-to-end rate where its spread between runs fits a bound, read here as a
per-layer number beside the card's busy time a step."""


def read(state):
    if not state["steps"]:
        return None
    return state["steps"] * state["batch"] / state["window_s"]
