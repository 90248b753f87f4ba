"""CPU time of the thread that drives the runner (time.thread_time) per D
step over the window, the profiled stretch left out (ms). A launch into a
full queue can spin on the CPU, so a host that waits on the device reads
high too."""


def read(run):
    if run.k1 or run.d_steps <= 0:
        return None
    return 1e3 * run.cpu_s / run.d_steps
