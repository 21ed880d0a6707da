"""Host ms of the tier's encode and commit a MiB of raw KV written."""

from portbench import readers


def read(run):
    return readers.tier_write_ms_per_mib(run)
