"""train.loader_wait_ms: the mean ms a step waits in the loader iterator's
``next()``."""


def read(record):
    waits = record.named("vb.next")
    return 1e3 * sum(s.end - s.start for s in waits) / len(waits) if waits else None
