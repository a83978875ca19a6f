"""Set-up seconds: from the harness's start (after the interpreter's)
through input generation, the program's import, build and load, and the
warm-up step, to the window's start."""


def read(run):
    return run.setup_s
