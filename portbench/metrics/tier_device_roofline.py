"""The tier's least device time over the kernel time launched inside its spans, in %."""

from portbench import readers


def read(run):
    return readers.tier_device_roofline(run)
