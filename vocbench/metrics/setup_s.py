"""setup_s: seconds from the process's start to the first timed call (the
kernel library's load or build, the weights, the inputs, the warm-up and any
capture)."""


def read(record):
    return record.setup_s
