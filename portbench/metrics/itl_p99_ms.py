"""99th percentile of the gaps between consecutive served tokens (host clock)."""

from portbench import readers


def read(run):
    return readers.itl_p99_ms(run)
