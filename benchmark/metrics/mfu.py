"""The whole step's share of the card's peak: model FLOPs (D and G forward
and backward passes, from shapes) over the window, the profiled stretch
left out, against the peak of the configuration's precision (%)."""

from harness import readers


def read(run):
    return readers.mfu_pct(run)
