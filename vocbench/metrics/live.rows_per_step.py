"""live.rows_per_step: windows decoded a step over the server's
``max_streams``, the mean over steps, in percent."""


from vocbench.measure import steps


def read(record):
    done = steps(record)
    if not done:
        return None
    return 100.0 * sum(s.attrs["windows"] / s.attrs["max_streams"] for s in done) / len(done)
