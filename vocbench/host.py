"""What the host gives a run and what the run takes from it: torch's intra-op
threads, and the process's user and system CPU seconds and resident memory
over the measured window, read just before the window opens and just after
it closes.

``place`` applies a configuration's ``deployment`` settings to this process,
before the program is built. ``line`` gives one line for standard error,
``host: `` and a JSON object; ``parse`` reads it back.
"""

from __future__ import annotations

import json
import resource

PREFIX = "host: "


def place(deployment) -> int:
    """Set torch's intra-op thread count to the ``deployment`` object's
    ``torch_threads``, where it has one; the count the run goes on with."""
    import torch

    if isinstance(deployment, dict) and deployment.get("torch_threads"):
        torch.set_num_threads(int(deployment["torch_threads"]))
    return torch.get_num_threads()


def snapshot() -> dict:
    """The process's CPU seconds so far, its resident memory and its peak."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"user_s": ru.ru_utime, "sys_s": ru.ru_stime, "maxrss_kb": ru.ru_maxrss}
    try:
        with open("/proc/self/status", encoding="ascii") as f:
            for row in f:
                if row.startswith("VmRSS:"):
                    out["rss_kb"] = int(row.split()[1])
    except OSError:
        pass
    return out


def window_report(before: dict, after: dict) -> dict:
    """The window's CPU seconds (after − before) and the memory on both sides."""
    return {"d_user_s": round(after["user_s"] - before["user_s"], 6),
            "d_sys_s": round(after["sys_s"] - before["sys_s"], 6),
            "rss_kb_before": before.get("rss_kb"), "rss_kb": after.get("rss_kb"),
            "maxrss_kb": after["maxrss_kb"]}


def line(report: dict) -> str:
    return PREFIX + json.dumps(report, sort_keys=True)


def parse(text: str) -> dict:
    """The object of a ``host:`` line."""
    if not text.startswith(PREFIX):
        raise ValueError(f"not a host line: {text[:40]!r}")
    return json.loads(text[len(PREFIX):])
