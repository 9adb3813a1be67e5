"""Candidate rows of the questions completed in the window, a second."""


def read(state):
    return state["rows"] / state["window_s"]
