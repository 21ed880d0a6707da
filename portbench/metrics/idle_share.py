"""Share of the traced window with nothing running on the device, in %."""

from portbench import readers


def read(run):
    return readers.idle_share(run)
