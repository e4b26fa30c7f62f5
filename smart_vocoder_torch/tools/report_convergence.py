"""Summarize a training run's loss trajectory as a markdown table.

The port's counterpart of ``scripts/report_convergence.py``, with the same
table:

    python -m smart_vocoder_torch.tools.report_convergence MODEL_DIR OUT.md [SAMPLE_EVERY]

(``SAMPLE_EVERY`` is 100 by default.) ``OUT.md`` must be given: the
script's default, ``CONVERGENCE.md`` in the working directory, would
overwrite the JAX package's record when run from the repo's root.
``parse`` reads ``MODEL_DIR/train.log`` as ``training/loop.py`` writes it:
the loss list lines ``[d_total, g_total, g_fm, g_mel, g_kl, step, lr]`` (the
reference's scalar set, train.py:216-231) and the ``eval step N: mel_l1 X``
lines. The table samples a row every ``SAMPLE_EVERY`` steps, plus the last,
and then lists the eval trend. Runs on the host.
"""

from __future__ import annotations

import ast
import os
import re
import sys


def parse_line(line: str):
    """``("loss", [7 values])`` for a loss list line, ``("eval", (step,
    mel_l1))`` for an eval line, else None. A line that does not parse is
    None (a non-finite value does not parse, so it shows as a missing row)."""
    e = re.search(r"eval step (\d+): mel_l1 ([\d.]+)", line)
    if e:
        return "eval", (int(e.group(1)), float(e.group(2)))
    m = re.search(r"\tINFO\t(\[.*\])\s*$", line)
    if not m:
        return None
    try:
        vals = ast.literal_eval(m.group(1))
    except (ValueError, SyntaxError):
        return None
    return ("loss", vals) if len(vals) == 7 else None


def parse(log_path: str):
    """``(rows, evals)``: every 7-value loss list in the log, in order, and
    every ``(step, mel_l1)`` eval line (``parse_line``)."""
    rows, evals = [], []
    with open(log_path) as f:
        for line in f:
            got = parse_line(line)
            if got:
                (rows if got[0] == "loss" else evals).append(got[1])
    return rows, evals


def write_report(rows, evals, out: str, every: int = 100) -> None:
    """The markdown table of ``rows`` sampled every ``every`` steps (and the
    last), then the eval trend, into ``out``."""
    picked, last_step = [], -every
    for r in rows:
        if r[5] >= last_step + every or r is rows[-1]:
            picked.append(r)
            last_step = r[5]
    if picked[-1] is not rows[-1]:
        picked.append(rows[-1])

    with open(out, "w") as f:
        f.write("| step | loss/d/total | loss/g/total | loss/g/fm | loss/g/mel "
                "| loss/g/kl | lr |\n|---|---|---|---|---|---|---|\n")
        for d, g, fm, mel, kl, step, lr in picked:
            f.write(f"| {step} | {d:.3f} | {g:.3f} | {fm:.3f} | {mel:.3f} "
                    f"| {kl:.3f} | {lr:.6f} |\n")
        if evals:
            f.write("\nCopy-synthesis quality trend (eval/mel_l1, full-utterance"
                    " infer through the sampling path at eval_interval):\n\n"
                    "| step | eval/mel_l1 |\n|---|---|\n")
            for step, v in evals:
                f.write(f"| {step} | {v:.4f} |\n")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        sys.exit("usage: report_convergence MODEL_DIR OUT.md [SAMPLE_EVERY]")
    model_dir, out = argv[0], argv[1]
    every = int(argv[2]) if len(argv) > 2 else 100

    rows, evals = parse(os.path.join(model_dir, "train.log"))
    if not rows:
        sys.exit(f"no loss rows found in {model_dir}/train.log")
    write_report(rows, evals, out, every)
    first, last = rows[0], rows[-1]
    print(f"wrote {out}: steps {first[5]}..{last[5]}, "
          f"mel {first[3]:.2f} -> {last[3]:.2f}, "
          f"d {first[0]:.2f} -> {last[0]:.2f}")


if __name__ == "__main__":
    main()
