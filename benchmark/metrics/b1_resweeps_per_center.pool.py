"""Kernel B1 sweeps made again a center, over the traced window (one
step): the program's counter align_resweeps (sweeps of a center whose
sweep the alignment cache had held and evicted) over its other sweeps,
align_sweeps less align_resweeps. None where the program keeps no such
counters or made no sweep."""


def read(run):
    if run.rec is None:
        return None
    c0, now = run.ctx.counters0, run.ctx.counters1
    if "align_resweeps" not in now:
        return None
    again = now["align_resweeps"] - c0["align_resweeps"]
    first = now["align_sweeps"] - c0["align_sweeps"] - again
    return again / first if first else None
