"""Host seconds of the compare backend's exact lambdas a sample: the
program's phase be.lambdas, summed over threads, over the samples of
the traced window (one step)."""


def read(run):
    if run.rec is None or "be.lambdas" not in run.rec.total_s:
        return None
    n = sum(len(names) for names, _ in run.ctx.results[:run.traced_steps])
    return run.rec.total_s["be.lambdas"] / n if n else None
