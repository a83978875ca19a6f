"""Host seconds of the DADA2 engine and output assembly a sample: the
self time of the program's phases named engine.* and finalize(.*), less
the spans of the compare backend inside them, summed over the dada()
threads, over the samples of the traced window (one step)."""


def read(run):
    if run.rec is None:
        return None
    s = sum(v for k, v in run.rec.self_s.items()
            if k.startswith("engine.") or k == "finalize"
            or k.startswith("finalize."))
    n = sum(len(names) for names, _ in run.ctx.results[:run.traced_steps])
    return s / n if n and s else None
