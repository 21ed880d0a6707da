"""The window's decode steps' least bytes at the HBM rate over the graph
replays' kernel time, in %."""

from portbench import counts, step_bytes


def read(run):
    t = run.trace
    if t is None or not t.replays or t.replay_kernel_s <= 0:
        return None
    end = run.window[1]
    nbytes = 0
    for r in run.requests:
        for s in range(1, len(r.times)):
            if r.times[s] <= end:
                nbytes += step_bytes.decode_step_bytes(
                    run.conf, r.batch, r.prompt_len + s - 1)
    least = nbytes / counts.HBM_BYTES_S
    return 100.0 * least / t.replay_kernel_s if nbytes else None
