"""Tokens served inside the window over every sequence, a second (host clock)."""

from portbench import readers


def read(run):
    return readers.out_tok_s(run)
