"""Host seconds of the chimera driver a table: the self time of the
program's phases chimera.pairs (the union parent matrix) and
chimera.vote (the per-sample vote), over the tables of the traced window
(one step)."""


def read(run):
    if run.rec is None:
        return None
    s = run.rec.self_s.get("chimera.pairs", 0.0) + run.rec.self_s.get(
        "chimera.vote", 0.0)
    return s / run.traced_steps if s else None
