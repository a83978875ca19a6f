"""Blocking host-device crossings a compare: the program's per-sample
counters syncs over compares, each summed over the sample spans of the
traced window (one step). A count that repeats from run to run."""
import program_spans


def read(run):
    return program_spans.counter_ratio(run, "syncs", "compares")
