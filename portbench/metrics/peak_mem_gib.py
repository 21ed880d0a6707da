"""Peak device memory allocated over the window, in GiB."""


def read(run):
    return run.peak_bytes / float(1 << 30) if run.peak_bytes else None
