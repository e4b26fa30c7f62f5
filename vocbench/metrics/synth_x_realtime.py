"""synth_x_realtime: seconds of true-length audio that ``Vocoder.mel_to_wav``
returned in the window, over the seconds from the window's start to the end
of the last completed call."""

from vocbench.measure import busy_span_seconds, ok_calls


def read(record):
    calls = ok_calls(record)
    if not calls:
        return None
    return sum(s.attrs["audio_s"] for s in calls) / busy_span_seconds(record, calls)
