"""Reads denoised a second: the reads of every dada() step of the window
over the time from the window's start to the end of its last step."""


def read(run):
    w0, w1 = run.window
    return sum(s["units"] for s in run.steps) / (w1 - w0)
