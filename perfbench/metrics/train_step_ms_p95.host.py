"""The 95th percentile of the window's step times (CUDA events at the step
boundaries, so a step whose dispatch ran late counts its gap): the
end-to-end tail where its spread between runs fits a bound, read here as a
per-layer number beside the card's busy time a step."""


def read(state):
    if not state["steps"]:
        return None
    return state["step_ms_p95"]
