"""Share of the traced window (one step) in which no operation ran on
the card (torch.profiler's device events), in percent."""


def read(run):
    if run.dev is None:
        return None
    return 100.0 * (1.0 - run.dev["busy_s"] / run.dev["window_s"])
