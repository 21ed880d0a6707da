"""Mean time to first token: from a request's due time to its prefill's logits on the host (host clock)."""

from portbench import readers


def read(run):
    return readers.ttft_mean_ms(run)
