"""Bytes fetched from the card a compare: the program's counters
fetch_bytes over compares, over the traced window (one step)."""


def read(run):
    if run.rec is None:
        return None
    c0, now = run.ctx.counters0, run.ctx.counters1
    n = now["compares"] - c0["compares"]
    return (now["fetch_bytes"] - c0["fetch_bytes"]) / n if n else None
