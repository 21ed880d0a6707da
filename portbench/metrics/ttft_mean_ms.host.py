"""Time to first token in a cell where the host paces the card: as ``ttft_mean_ms``."""

from portbench import readers


def read(run):
    return readers.ttft_mean_ms(run)
