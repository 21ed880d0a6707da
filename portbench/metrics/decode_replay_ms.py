"""Kernel time a replay of the captured decode step, from the device trace."""

from portbench import readers


def read(run):
    return readers.decode_replay_ms(run)
