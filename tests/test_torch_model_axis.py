"""The mesh's model axis (``tpu.model_parallel``) on the CPU, with gloo ranks.

Config: ``test_torch_distributed.py``'s tiny model with
``upsample_initial_channel: 128``, so that JAX's shard rule takes 14 of G's
225 tensors and 26 of D's 111 at M = 2 (at 64 it takes none of G's).

- The rule (``parallel.mesh.leaf_sharded``) against JAX's ``_leaf_spec`` on
  every parameter shape of G and D, at M = 2 and 4.
- One spawn of 4 gloo ranks trains the same rows a rank (one of
  ``global_batch``'s four) at D = 4 x M = 1 and then at D = 2 x M = 2, from
  the same seeded weights and draws: after 2 steps the parameters and
  AdamW's moments are bit-equal (the sharded run holds its block of each
  moment); each rank's AdamW state holds exactly 1/M of every tensor the
  rule shards and the whole of the rest; the two pairs saved after step 2
  are equal tensor for tensor, and the unsharded one restored on the model
  axis gives each rank its blocks. Against one process on the global batch, the
  sharded run's step-1 gradients are within ``GRAD_TOL`` of the norm and
  its metrics of steps 1-2 within ``METRIC_REL``; the pair resumes in one
  process, whose next step's losses are within ``METRIC_REL`` of the
  sharded run's step 3.
- The ranks rule (``ranks_to_start``) with ``model_parallel``; the sampler
  at D x M replicas of ``batch_size / M`` rows gives JAX's one replica of
  ``batch_size x D`` the same rows at every step; the train CLI at
  ``data_parallel: 2, model_parallel: 2`` (4 gloo ranks) trains, writes its
  pairs and resumes from them; what the mesh refuses.

The workers import no JAX (``spawn`` re-imports this module).
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from smart_vocoder_torch.config import HParams, validate
from smart_vocoder_torch.data import BucketSampler
from smart_vocoder_torch.models import build_discriminator, build_synthesizer
from smart_vocoder_torch.parallel import Mesh, leaf_sharded
from smart_vocoder_torch.parallel import dist as dist_lib
from smart_vocoder_torch.training import init_train_state, make_train_step
from smart_vocoder_torch.training.sharded import ShardedAdamW
from smart_vocoder_torch.utils.checkpoint import CheckpointManager
from smart_vocoder_torch.utils.torch_compat import load_torch_checkpoint
from test_torch_distributed import (CFG, GRAD_TOL, METRIC_REL, global_batch, grad_error, rows,
                                    write_run_config)

WORLD = 4
MESHES = {"d4m1": 1, "d2m2": 2}  # the leg's name: its model axis over the 4 ranks
LR = 2e-4


def tiny_cfg():
    cfg = copy.deepcopy(CFG)
    cfg["model"]["upsample_initial_channel"] = 128
    return cfg


def tiny_hps():
    return validate(HParams(**tiny_cfg()))


def nets(hps):
    return {"G": build_synthesizer(hps), "D": build_discriminator(hps)}


@pytest.mark.parametrize("model", [2, 4])
def test_leaf_sharded_matches_jax(model):
    from jax.sharding import PartitionSpec as P

    from smart_vocoder_tpu.parallel.mesh import _leaf_spec

    counts = {}
    for tag, net in nets(tiny_hps()).items():
        shapes = [tuple(p.shape) for p in net.parameters()]
        for shape in shapes:
            want = _leaf_spec(np.empty(shape, np.float32), model) == P("model")
            assert leaf_sharded(shape, model) == want, (tag, shape, model)
        counts[tag] = (sum(leaf_sharded(s, model) for s in shapes), len(shapes))
    assert all(n > 0 for n, _ in counts.values()), counts
    if model == 2:
        assert counts == {"G": (14, 225), "D": (26, 111)}


def moments(opt):
    """Each leaf's (exp_avg, exp_avg_sq), in the optimizer's order."""
    leaves = opt.param_groups[0]["params"]
    return [(opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"]) for p in leaves]


def run_leg(name, rank, out_dir, hps, batch, draws):
    """Three steps of this rank's row on the leg's mesh: the step-1
    gradients the optimizers were handed (full, averaged), each step's
    averaged metrics, the pair saved after step 2 (by the chief's model
    group), and the state after step 2."""
    mesh = Mesh.build(MESHES[name])
    state = init_train_state(hps, seed=3, device="cpu", mesh=mesh)
    step = make_train_step(hps, device="cpu")
    grads = {}
    for tag, opt in (("g", state.opt_g), ("d", state.opt_d)):
        if isinstance(opt, ShardedAdamW):
            original = opt.take_gradients

            def take(g, tag=tag, original=original):
                grads.setdefault(tag, [t.clone() for t in g])
                return original(g)
            opt.take_gradients = take
        else:
            original = opt.step

            def capture(*a, tag=tag, opt=opt, original=original, **k):
                grads.setdefault(tag, [p.grad.clone() for p in opt.param_groups[0]["params"]])
                return original(*a, **k)
            opt.step = capture
    metrics, after_two = [], None
    for s in range(3):
        state, m = step(state, batch, **draws)
        metrics.append(dist_lib.mean_scalars(m))
        if s == 1:
            if mesh.data_index == 0:
                CheckpointManager(os.path.join(out_dir, name)).save(
                    2, state, 1, LR, write=rank == 0)
            after_two = {
                "params": [p.detach().clone() for net in (state.net_g, state.net_d)
                           for p in net.parameters()],
                "moments": [(a.clone(), b.clone()) for opt in (state.opt_g, state.opt_d)
                            for a, b in moments(opt)],
                "mesh": mesh, "state": state}
    return {"grads": grads, "metrics": metrics, **after_two}


def _worker(rank, world, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        hps = tiny_hps()
        batch, draws = rows(*global_batch()[1:], slice(rank, rank + 1))
        legs = {name: run_leg(name, rank, out_dir, hps, batch, draws) for name in MESHES}
        one, two = legs["d4m1"], legs["d2m2"]
        mesh = two["mesh"]
        # the sharded run's state: its block of each moment the rule shards, the whole of the rest
        shares, full_shapes = [], []
        for opt in (two["state"].opt_g, two["state"].opt_d):
            for p, (a, b) in zip(opt.full, moments(opt)):
                shares.append(a.numel() / p.numel())
                full_shapes.append(tuple(p.shape))
        blocks = [tuple(mesh.block(a) if leaf_sharded(shape, 2) else a for a in pair)
                  for pair, shape in zip(one["moments"], full_shapes)]
        # the unsharded run's pair restored on the model axis: this rank's blocks
        fresh = init_train_state(hps, seed=99, device="cpu", mesh=mesh)
        CheckpointManager(os.path.join(out_dir, "d4m1")).restore(fresh)
        restored = [(a, b) for opt in (fresh.opt_g, fresh.opt_d) for a, b in moments(opt)]
        out = {
            "params_equal": all(torch.equal(a, b) for a, b in zip(one["params"], two["params"])),
            "params_max_diff": max((a - b).abs().max().item()
                                   for a, b in zip(one["params"], two["params"])),
            "moments_equal": all(torch.equal(x, y) for want, got in zip(blocks, two["moments"])
                                 for x, y in zip(want, got)),
            "restored_equal": all(torch.equal(x, y) for want, got in zip(blocks, restored)
                                  for x, y in zip(want, got)) and fresh.step == 2,
            "groups": [dist.get_process_group_ranks(g)
                       for g in (mesh.model_group, mesh.data_group)],
            "shares": shares, "full_shapes": full_shapes,
            "mesh": str(mesh), "grads": two["grads"],
            "metrics": {name: leg["metrics"] for name, leg in legs.items()}}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("model_axis")
    mp.start_processes(_worker, args=(WORLD, dist_lib.free_port(), str(out_dir)), nprocs=WORLD,
                       join=True, start_method="spawn")
    return out_dir, [torch.load(out_dir / f"rank{r}.pt") for r in range(WORLD)]


def test_sharded_run_is_bit_equal_to_the_unsharded_run(four_ranks):
    _, ranks = four_ranks
    assert [r["mesh"] for r in ranks] == [
        f"data 2 x model 2 (rank {r}: data index {r // 2}, model index {r % 2})"
        for r in range(WORLD)]
    for r, out in enumerate(ranks):
        # a model group is two neighbouring ranks; a data group the ranks of one model index
        assert out["groups"] == [[r - r % 2, r - r % 2 + 1], [r % 2, r % 2 + 2]], r
        assert out["params_equal"], (r, out["params_max_diff"])
        assert out["moments_equal"], r
        assert out["restored_equal"], r
        # exactly 1/M of every sharded tensor's moments, the whole of the rest
        want = [0.5 if leaf_sharded(s, 2) else 1.0 for s in out["full_shapes"]]
        assert out["shares"] == want, r
        assert want.count(0.5) == 14 + 26
        # both legs logged the same means at every step
        for s, (a, b) in enumerate(zip(out["metrics"]["d4m1"], out["metrics"]["d2m2"])):
            assert a == b, (r, s + 1)


def payload_tensors(payload, prefix=""):
    """Every tensor of a ``.pth`` payload by its path, and its other leaves."""
    tensors, other = {}, {}
    items = payload.items() if isinstance(payload, dict) else enumerate(payload)
    for k, v in items:
        path = f"{prefix}/{k}"
        if torch.is_tensor(v):
            tensors[path] = v
        elif isinstance(v, (dict, list, tuple)):
            t, o = payload_tensors(v, path)
            tensors.update(t)
            other.update(o)
        else:
            other[path] = v
    return tensors, other


def test_sharded_pair_equals_the_unsharded_pair(four_ranks):
    out_dir, _ = four_ranks
    for tag in ("G", "D"):
        got = payload_tensors(load_torch_checkpoint(str(out_dir / "d2m2" / f"{tag}_2.pth")))
        want = payload_tensors(load_torch_checkpoint(str(out_dir / "d4m1" / f"{tag}_2.pth")))
        assert got[1] == want[1] and want[1]["/iteration"] == 2
        assert set(got[0]) == set(want[0])
        assert any(k.endswith("/exp_avg") for k in got[0])
        for k, v in want[0].items():
            assert got[0][k].shape == v.shape and torch.equal(got[0][k], v), (tag, k)


def single_process(hps, batch, draws, state, steps):
    """``steps`` steps of the global batch in this process from ``state``: the
    step-1 gradients the optimizers saw and each step's metrics."""
    step = make_train_step(hps, device="cpu")
    grads = {}
    for tag, opt in (("g", state.opt_g), ("d", state.opt_d)):
        original = opt.step

        def capture(*a, tag=tag, opt=opt, original=original, **k):
            grads.setdefault(tag, [p.grad.clone() for p in opt.param_groups[0]["params"]])
            return original(*a, **k)
        opt.step = capture
    metrics = []
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for _ in range(steps):
            state, m = step(state, batch, **draws)
            metrics.append(dist_lib.mean_scalars(m))
    finally:
        torch.set_num_threads(n)
    return grads, metrics


def close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        assert abs(got[k] - w) <= METRIC_REL * abs(w), (k, got[k], w)


def test_sharded_run_matches_one_process_and_its_pair_resumes(four_ranks):
    out_dir, ranks = four_ranks
    hps = tiny_hps()
    _, batch, draws = global_batch()
    grads, metrics = single_process(hps, batch, draws,
                                    init_train_state(hps, seed=3, device="cpu"), 2)
    sharded = ranks[0]
    errors = {tag: grad_error(sharded["grads"][tag], grads[tag]) for tag in ("g", "d")}
    assert all(e <= GRAD_TOL for e in errors.values()), errors
    for got, want in zip(sharded["metrics"]["d2m2"][:2], metrics):
        close(got, want)

    # the pair the sharded run saved after step 2 resumes in one process
    state = init_train_state(hps, seed=99, device="cpu")
    state, epoch, step = CheckpointManager(str(out_dir / "d2m2")).restore(state)
    assert (state.step, epoch, step) == (2, 1, 2)
    _, resumed = single_process(hps, batch, draws, state, 1)
    close(resumed[0], sharded["metrics"]["d2m2"][2])


@pytest.mark.parametrize("data_parallel, cards, world, cpu, model_parallel, want", [
    (-1, 4, None, False, 2, 4),    # every card: 2 model groups of 2
    (-1, 4, None, False, 4, 4),
    (-1, 3, None, False, 2, "3 CUDA cards are visible: not a multiple"),
    (-1, 4, None, True, 2, 2),     # --device cpu: one data index, 2 gloo ranks
    (2, 0, None, True, 2, 4),      # 4 gloo ranks on the CPU
    (2, 4, None, False, 2, 4),
    (3, 4, None, False, 2, "3 x 2 = 6, and 4 CUDA cards"),
    (1, 4, None, False, 0, "model_parallel is 0"),
    (-1, 4, 4, False, 2, 1),       # under torchrun: its ranks
    (2, 4, 4, False, 2, 1),
    (4, 4, 4, False, 2, "set it to -1 or 2"),
    (-1, 3, 3, False, 2, "start a multiple of it"),
])
def test_ranks_to_start_with_a_model_axis(data_parallel, cards, world, cpu, model_parallel,
                                          want):
    args = (data_parallel, cards, world, cpu, model_parallel)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            dist_lib.ranks_to_start(*args)
    else:
        assert dist_lib.ranks_to_start(*args) == want


@pytest.mark.parametrize("data, model", [(2, 2), (1, 2), (2, 1)])
def test_sampler_matches_jax_over_the_mesh(data, model):
    """D x M replicas of ``batch_size / M`` rows: at every step of 3 epochs the
    ranks' batches together are JAX's one replica's batch of
    ``batch_size x D`` rows (its loop, ``loop.py:79-86``)."""
    from smart_vocoder_tpu.data import BucketSampler as JaxSampler
    from test_torch_data import BOUNDARIES, sampler_lengths

    lengths, batch_size = sampler_lengths(), 4
    ours = [BucketSampler(lengths, batch_size // model, BOUNDARIES, num_replicas=data * model,
                          rank=r) for r in range(data * model)]
    ref = JaxSampler(lengths, batch_size * data, list(BOUNDARIES))
    for epoch in range(3):
        for s in ours + [ref]:
            s.set_epoch(epoch)
        steps = list(zip(*ours))
        want = list(ref)
        assert len(steps) == len(want) > 0
        for j, (per_rank, whole) in enumerate(zip(steps, want)):
            assert all(len(b) == batch_size // model for b in per_rank)
            assert sorted(i for b in per_rank for i in b) == sorted(whole), (epoch, j)


def test_mesh_refuses():
    assert Mesh.build(1) == Mesh(1, 1, 0)
    with pytest.raises(ValueError, match="not a whole number of model groups"):
        Mesh.build(2)  # one process
    with pytest.raises(ValueError, match="batch_size 3 is not a multiple of tpu.model_parallel 2"):
        Mesh(2, 2, 1).rows_per_rank(3)
    assert Mesh(2, 2, 3).rows_per_rank(4) == 2
    t = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(Mesh(1, 2, 1).block(t), t[2:])
    assert Mesh(1, 2, 1).block(t).data_ptr() == t[2:].data_ptr()


def test_train_cli_on_a_model_axis(tmp_path):
    """``tpu.data_parallel: 2, model_parallel: 2`` with ``--device cpu``: the
    CLI starts 4 gloo ranks, the chief logs the mesh and writes the pairs,
    and a second call resumes from them."""
    write_run_config(tmp_path)
    cfg = json.loads((tmp_path / "cfg.json").read_text())
    cfg["model"]["upsample_initial_channel"] = 128
    cfg["tpu"].update(data_parallel=2, model_parallel=2)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
               OMP_NUM_THREADS="1")
    for steps in (2, 3):
        proc = subprocess.run(
            [sys.executable, "-m", "smart_vocoder_torch.train", "-c", "cfg.json", "-m", "mp",
             "--max-steps", str(steps), "--device", "cpu"], cwd=tmp_path, env=env,
            capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    model_dir = tmp_path / "logs" / "mp"
    log = (model_dir / "train.log").read_text()
    assert "torch.distributed gloo: rank 0 of 4 on cpu" in log
    assert ("mesh: data 2 x model 2 (rank 0: data index 0, model index 0); 1 of each step's "
            "4 rows a rank") in log
    assert "resumed from step 2" in log
    steps = [json.loads(ln.split("\t")[-1]) for ln in log.splitlines()
             if ln.split("\t")[-1].startswith("[")]
    assert [s[5] for s in steps] == [0, 1, 2]
    assert all(np.isfinite(s[:5]).all() for s in steps)
    assert sorted(p.name for p in model_dir.glob("*.pth")) == ["D_2.pth", "D_3.pth",
                                                                  "G_2.pth", "G_3.pth"]
    g = load_torch_checkpoint(str(model_dir / "G_3.pth"))
    shapes = [tuple(p.shape) for p in nets(tiny_hps())["G"].parameters()]
    assert [tuple(st["exp_avg"].shape) for _, st in sorted(g["optimizer"]["state"].items())] \
        == shapes


def test_bench_model_axis_at_a_tiny_size(tmp_path, monkeypatch):
    """``tools/bench_model_axis.py`` (phase 13 of ``chip_smoke.py`` on cards)
    in 2 gloo ranks: the model axis bit-equal to the data axis on the same
    row a rank, half the moments of every sharded tensor, every reading
    there."""
    from smart_vocoder_torch.tools import bench_model_axis as bma

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks' threads
    hps = tiny_hps()
    halved = sum(p.numel() // 2 for net in nets(hps).values() for p in net.parameters()
                 if leaf_sharded(p.shape, 2))
    bma.write_inputs(str(tmp_path), hps, 2, 32)
    legs = [("m1", 1, 1, True), ("m2", 2, 1, True), ("all rows", 1, 2, False)]
    dist_lib.start_ranks(2, bma.rank_main, (str(tmp_path), hps, legs, "cpu",
                                            dict(rounds=2, iters=1)))
    for r in range(2):
        out = json.loads((tmp_path / f"rank{r}.json").read_text())["legs"]
        assert out["m2"]["against"]["m1"] == [True, 0.0] == out["m1"]["against"]["m2"]
        assert out["m2"]["check_losses"] == out["m1"]["check_losses"]
        assert not out["all rows"]["against"]["m1"][0]
        assert out["m2"]["nondeterministic"] == []
        assert out["m2"]["mesh"] == f"data 1 x model 2 (rank {r}: data index 0, model index {r})"
        # two f32 moments of half of every sharded tensor fewer
        assert out["m2"]["optimizer_mb"] == pytest.approx(out["m1"]["optimizer_mb"]
                                                          - 2 * 4 * halved / 1e6, abs=1e-9)
        for name in ("m1", "m2"):
            leg = out[name]
            assert leg["steps"] == 3 + 1 + 3 and leg["rounds"] == 2
            assert 0 < leg["step_ms_min"] <= leg["step_ms"] <= leg["step_ms_max"]
            assert np.isfinite(leg["last_losses"]).all() and leg["peak_mem_gib"] is None
        assert "step_ms" not in out["all rows"]

