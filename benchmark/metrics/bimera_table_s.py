"""Seconds a sequence table takes to clean of chimeras: the window's
time, to the end of its last step, over the tables cleaned."""


def read(run):
    w0, w1 = run.window
    return (w1 - w0) / len(run.steps)
