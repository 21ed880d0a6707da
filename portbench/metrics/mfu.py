"""The model's operations in the window over the window at the bf16 peak, in %."""

from portbench import readers


def read(run):
    return readers.mfu(run)
