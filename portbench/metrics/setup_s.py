"""Seconds from the process's start to the window's: weights made on
the device, the engine and its plans, the scheduler's graphs, every
shape of the cell's traffic run once, and the driver's warm-up of its
loop (a closed loop's slots filled and past their prefill)."""


def read(run, name):
    return run.setup_s
