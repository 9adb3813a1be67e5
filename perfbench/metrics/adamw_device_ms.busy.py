"""The card's time for one ``AdamW.step()`` of the program's optimizer on
the last step's gradients, called alone after the window; the part of the
card's busy time a step that the optimizer takes."""

from perfbench import common


def read(state):
    prog = state["program"]
    return 1e3 * common.device_seconds(prog.optimizer.step,
                                       state["ctx"].device, calls=3)
