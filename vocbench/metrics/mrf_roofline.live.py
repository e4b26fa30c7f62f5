"""mrf_roofline.live: as mrf_roofline.synth, on the decoded windows' lengths,
one launch a step."""

from vocbench.measure import mrf_roofline_pct, steps


def read(record):
    return mrf_roofline_pct(record, [s.attrs["lengths"] for s in steps(record)])
