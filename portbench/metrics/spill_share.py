"""Pages spilled to the tier over pages committed, in % (program counters)."""

from portbench import readers


def read(run):
    return readers.spill_share(run)
