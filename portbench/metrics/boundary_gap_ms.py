"""Mean gap of the decode steps that committed a window of KV to the page pool."""

from portbench import readers


def read(run):
    return readers.boundary_gap_ms(run)
