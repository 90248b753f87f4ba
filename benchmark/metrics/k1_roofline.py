"""K1's share of its roofline in the profiled stretch (%)."""

from harness import readers


def read(run):
    return readers.roofline_pct(run, "k1")
