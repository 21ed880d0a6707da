"""Host ms of the tier's reads a MiB of KV read back."""

from portbench import readers


def read(run):
    return readers.tier_read_ms_per_mib(run)
