"""The GAN train step over the mesh's ``('data', 'model')`` axes: checks and
timing of each mesh, in one process or in every rank of a process group
(phase 13 of ``chip_smoke.py`` drives it on cards).

A leg is ``(name, model, rows, timed)``: a mesh of the process group's ranks
with a model axis of ``model`` ranks (``parallel.mesh.Mesh.build``), a
``TrainState`` from the seeded init (``SEED``) whose optimizers keep this
rank's share of the moments, and ``rows`` rows a rank of one global batch:
rank ``r`` trains rows ``[r * rows mod B, + rows)``, so at ``rows = B / world``
the ranks split the batch, and at ``rows = B`` every rank trains all of it.
The batch and the step's draws (``eps_q``, ``ids_slice``, ``perm``) come
from ``write_inputs``: ``tools/bench_train.py``'s synthetic batch and draws
from a seeded CPU generator, passed in at every step. The legs of a call run
in the same process(es), in two parts:

1. checks, with cuDNN's algorithm search off: ``CHECK_STEPS`` steps from
   the seeded init; each step's five losses averaged over the ranks; then
   each leg's parameters against every other leg's (bit-equal, and the
   largest difference). With ``deterministic``, ``cudnn.deterministic`` and
   ``torch.use_deterministic_algorithms`` (warning only) are on, and the
   ops that warned they have no deterministic implementation are listed.
2. timing of the legs marked ``timed``, with the search on, as
   ``tools/bench_train.py`` times: one warm-up step each, then ``rounds``
   interleaved rounds of ``iters`` steps (every other round in reverse
   order): host ms a step (each round ends in a synchronize), median and
   range; the card's kernel ms a step over ``iters`` more steps under
   torch.profiler, apart from NCCL's (which run on their own stream and
   wait for the other ranks inside the kernel), the first's share of the
   step (``busy_share``); the step's peak memory (bench_train's rule); and
   the five losses of the last step.

Each leg also reports its optimizer state in MB (both AdamW states' tensors
on this rank). ``run_legs`` runs the legs in this process; ``rank_main`` is
one rank of ``parallel.dist.start_ranks``: it joins the group (NCCL on
``cuda:<LOCAL_RANK>``, gloo on the CPU), runs them and writes
``rank<r>.json`` into the directory of the inputs. On the CPU the times are
the host's and there is no busy time or peak.
"""

from __future__ import annotations

import json
import os
import statistics
import time
import warnings
from typing import Dict, Optional, Sequence, Tuple

import torch

from smart_vocoder_torch.inference import set_precision_flags
from smart_vocoder_torch.parallel import dist as dist_lib
from smart_vocoder_torch.parallel.mesh import Mesh
from smart_vocoder_torch.tools.bench_train import LOSSES, state_bytes, synthetic_batch
from smart_vocoder_torch.training import Batch, init_train_state, make_train_step

SEED = 1234
CHECK_STEPS = 3
Leg = Tuple[str, int, int, bool]  # (name, model axis, rows a rank, timed)


def write_inputs(directory: str, hps, rows: int, frames: int) -> None:
    """Save the global batch (``rows`` x ``frames``) and the draws for it
    as ``directory/inputs.pt``."""
    batch = synthetic_batch(hps, rows, frames, torch.device("cpu"))
    gen = torch.Generator().manual_seed(SEED)
    seg = hps.train.segment_size // hps.data.hop_length
    draws = {"eps_q": torch.randn((rows, frames, hps.model.inter_channels), generator=gen),
             "ids_slice": (torch.rand((rows,), generator=gen) * (frames - seg + 1)).int(),
             "perm": torch.tensor([2, 0, 3, 1])}
    torch.save({"batch": batch, "draws": draws}, os.path.join(directory, "inputs.pt"))


def optimizer_mb(state) -> float:
    """MB (1e6 bytes) of both optimizers' state tensors on this rank."""
    return sum(v.numel() * v.element_size() for opt in (state.opt_g, state.opt_d)
               for st in opt.state.values() for v in st.values() if torch.is_tensor(v)) / 1e6


def param_diff(a, b) -> Tuple[bool, float]:
    """Whether two states' parameters are bit-equal, and their largest difference."""
    pairs = [(x, y) for na, nb in ((a.net_g, b.net_g), (a.net_d, b.net_d))
             for x, y in zip(na.parameters(), nb.parameters())]
    return (all(torch.equal(x, y) for x, y in pairs),
            max((x - y).abs().max().item() for x, y in pairs))


def profile_step_ms(fn, device: torch.device) -> Tuple[float, float]:
    """The card's busy ms over one ``fn()`` call and NCCL's kernels' share of
    it, under torch.profiler (``nan`` on the CPU)."""
    if device.type != "cuda":
        return float("nan"), float("nan")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    nccl = sum(e.self_device_time_total for e in events if "nccl" in e.key.lower()) / 1e3
    return busy, nccl


def check_legs(hps, batch, draws, legs: Sequence[Leg], device: torch.device,
               deterministic: bool) -> Tuple[dict, dict]:
    """Part 1: build each leg and take its ``CHECK_STEPS`` steps; ({leg name:
    its run}, {leg name: its readings}). Under ``deterministic`` every op
    that has a deterministic implementation uses it
    (``torch.use_deterministic_algorithms``, warning for those that lack
    one), and each leg reports those warnings."""
    total, rank = batch.spec.shape[0], dist_lib.rank()
    runs, out = {}, {}
    flags = torch.are_deterministic_algorithms_enabled(), \
        torch.is_deterministic_algorithms_warn_only_enabled()
    try:
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        for name, model, rows, timed in legs:
            sel = slice(rank * rows % total, rank * rows % total + rows)
            b = Batch(*(None if v is None else v[sel] for v in (
                batch.spec, batch.spec_lengths, batch.wav, batch.wav_lengths, batch.sid)))
            d = {k: (v if k == "perm" else v[sel]).to(device) for k, v in draws.items()}
            mesh = Mesh.build(model)
            run = {"state": init_train_state(hps, seed=SEED, device=device, mesh=mesh),
                   "step": make_train_step(hps, device), "batch": b.to(device), "draws": d,
                   "timed": timed}
            losses = []
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for _ in range(CHECK_STEPS):
                    run["state"], m = run["step"](run["state"], run["batch"], **d)
                    means = dist_lib.mean_scalars(m)
                    losses.append([means[k] for k in LOSSES])
            runs[name] = run
            out[name] = {"mesh": str(mesh), "rows": rows, "check_losses": losses,
                         "optimizer_mb": optimizer_mb(run["state"]),
                         "nondeterministic": sorted({str(w.message).splitlines()[0][:160]
                                                     for w in caught
                                                     if "determinis" in str(w.message)})}
    finally:
        torch.use_deterministic_algorithms(flags[0], warn_only=flags[1])
    for name, run in runs.items():
        out[name]["against"] = {other: param_diff(run["state"], o["state"])
                                for other, o in runs.items() if other != name}
    return runs, out


def run_legs(hps, directory: str, legs: Sequence[Leg], device, rounds: int = 5,
             iters: int = 2, deterministic: bool = False) -> Dict[str, dict]:
    """Check and time ``legs`` on this rank on ``directory``'s inputs (see
    the module's docstring); {leg name: its readings on this rank}."""
    device = torch.device(device)
    saved = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
    cudnn = torch.backends.cudnn
    flags = cudnn.benchmark, cudnn.deterministic
    try:
        cudnn.benchmark, cudnn.deterministic = False, deterministic
        runs, out = check_legs(hps, saved["batch"], saved["draws"], legs, device,
                               deterministic)
        cudnn.benchmark, cudnn.deterministic = True, False
        timed = [name for name, run in runs.items() if run["timed"]]

        def one(name):
            run = runs[name]
            run["state"], run["metrics"] = run["step"](run["state"], run["batch"],
                                                       **run["draws"])

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        for name in timed:
            one(name)
        sync()
        times = {name: [] for name in timed}
        peaks = {name: None for name in timed}
        for r in range(rounds):
            for name in (timed if r % 2 == 0 else timed[::-1]):
                if device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(device)
                    resident = torch.cuda.memory_allocated(device)
                t0 = time.perf_counter()
                for _ in range(iters):
                    one(name)
                sync()
                times[name].append((time.perf_counter() - t0) / iters * 1e3)
                if device.type == "cuda":
                    peak = (state_bytes(runs[name]["state"])
                            + torch.cuda.max_memory_allocated(device) - resident) / 2 ** 30
                    peaks[name] = max(peaks[name] or 0.0, peak)
        for name in timed:
            busy, nccl = profile_step_ms(lambda: [one(name) for _ in range(iters)], device)
            ms = statistics.median(times[name])
            means = dist_lib.mean_scalars(runs[name]["metrics"])
            out[name].update({
                "step_ms": ms, "step_ms_min": min(times[name]), "step_ms_max": max(times[name]),
                "rounds": rounds, "iters": iters, "busy_ms": busy / iters,
                "nccl_ms": nccl / iters, "busy_share": (busy - nccl) / iters / ms,
                "peak_mem_gib": peaks[name], "last_losses": [means[k] for k in LOSSES],
                "steps": CHECK_STEPS + 1 + (rounds + 1) * iters})
    finally:
        cudnn.benchmark, cudnn.deterministic = flags
    return out


def rank_main(directory: str, hps, legs: Sequence[Leg], device=None,
              options: Optional[dict] = None) -> None:
    """One rank of ``parallel.dist.start_ranks``: join the group, run the
    legs on ``directory``'s inputs (``options``: ``run_legs``' keywords),
    write ``rank<r>.json`` there."""
    device = dist_lib.init_from_env(device)
    set_precision_flags()
    out = run_legs(hps, directory, legs, device, **(options or {}))
    with open(os.path.join(directory, f"rank{dist_lib.rank()}.json"), "w") as f:
        json.dump({"device": str(device), "legs": out}, f)
    dist_lib.shutdown()  # after every rank's last step (a failed rank exits without it)
