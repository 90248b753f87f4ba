"""The window's wall time not covered by the runner's own per-epoch CUDA
events, the profiled stretch left out (%): the Trainer's work between
runner calls (accountant, log flush, privacy log, grids) and the host time
before each epoch's first device work."""


def read(run):
    if run.window_s <= 0 or run.epoch_s <= 0:
        return None
    return 100.0 * (1.0 - run.epoch_s / run.window_s)
