"""aa_act.launches_per_call: the program's ``LAUNCHES["aa_snake"]`` counted
over the window, over the window's completed calls; ``None`` where the
program counts no such launches."""

from vocbench.measure import ok_calls


def read(record):
    n = record.counters.get("aa_snake_launches")
    calls = ok_calls(record)
    if n is None or not calls:
        return None
    return n / len(calls)
