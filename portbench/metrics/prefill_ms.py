"""Mean host wall of a request's prefill call, ended by its logits on the host."""

from portbench import readers


def read(run):
    return readers.prefill_ms(run)
