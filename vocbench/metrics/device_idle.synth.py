"""device_idle.synth: the share of the traced window in which no operation ran
on the device."""

from vocbench.measure import device_idle_pct


def read(record):
    return device_idle_pct(record)
