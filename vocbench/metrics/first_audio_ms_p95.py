"""first_audio_ms_p95: the 95th percentile, over the streams that arrived in
the window and emitted, of the ms from a stream's scheduled arrival to its
first waveform piece out of ``StreamServer.step()``."""

import numpy as np


def read(record):
    values = list(record.data.get("first_ms", {}).values())
    return float(np.percentile(values, 95)) if values else None
