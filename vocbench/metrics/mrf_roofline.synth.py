"""mrf_roofline.synth: the roofline time of the decoder's stages 3-4 on the
calls' true frames, over the device time of ``mrf_stage_kernel`` and
``up_mrf_stage_kernel`` in the trace."""

from vocbench.measure import mrf_roofline_pct, ok_calls


def read(record):
    return mrf_roofline_pct(record, [s.attrs["frames"] for s in ok_calls(record)])
