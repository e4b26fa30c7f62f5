"""mrf_roofline.live: the roofline time of the decoder's stages 3-4 on the
work the server's step launches, ``max_streams`` rows of ``chunk`` frames
whatever number of them hold a ready window (one launch a step), over the
device time of ``mrf_stage_kernel`` and ``up_mrf_stage_kernel`` in the
trace. How full a step is, is ``live.rows_per_step``'s to say."""

from vocbench.measure import mrf_roofline_pct, steps


def read(record):
    return mrf_roofline_pct(record, [[s.attrs["chunk"]] * s.attrs["max_streams"]
                                     for s in steps(record)])
