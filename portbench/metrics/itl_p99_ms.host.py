"""Token-gap tail in a cell where the host paces the card: as ``itl_p99_ms``."""

from portbench import readers


def read(run):
    return readers.itl_p99_ms(run)
