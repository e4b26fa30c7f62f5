"""train.loader_empty_pct: the share of ``loader.wait`` spans (the step's
wait for its batch in ``BucketedLoader``) that found the loader's queue
empty, in percent."""

from vocbench import program_spans as ps


def read(record):
    waits = ps.named(ps.spans(record), "loader.wait")
    if not waits:
        return None
    return 100.0 * sum(bool(s.attrs.get("empty")) for s in waits) / len(waits)
