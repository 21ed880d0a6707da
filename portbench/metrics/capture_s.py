"""Mean host wall of a request's DecodeGraph construction (warm-up step and capture)."""

from portbench import readers


def read(run):
    return readers.capture_s(run)
