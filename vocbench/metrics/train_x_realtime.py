"""train_x_realtime: seconds of audio in the training batches stepped in the
window (each row's true clip length), over the seconds from the window's
start to the end of the last step's work on the device."""


def read(record):
    done = record.named("vb.step")
    if not done:
        return None
    return sum(s.attrs["audio_s"] for s in done) / (record.t1 - record.t0)
