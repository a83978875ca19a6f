"""Host seconds of pooling a step: the self time of the program's spans
dada.pool (the samples' uniques pooled, combine_dereps) and dada.split
(each sample's result split back out of the pooled one) in the traced
window (one step). None where the program records no such span."""
import program_spans

NAMES = ("dada.pool", "dada.split")


def read(run):
    spans = program_spans.recorded()
    if not spans:
        return None
    w0, w1 = (int(t * 1e9) for t in run.window)
    mine = {s.id: s for s in spans
            if s.name in NAMES and w0 <= s.start_ns <= w1}
    if not mine:
        return None
    ns = sum(s.end_ns - s.start_ns for s in mine.values())
    ns -= sum(s.end_ns - s.start_ns for s in spans if s.parent in mine)
    return ns * 1e-9 / run.traced_steps
