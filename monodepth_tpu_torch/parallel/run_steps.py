"""Run train steps and an eval step on a process mesh, and report per rank.

    # one process per rank, started here (CPU with gloo, or one card each)
    python -m monodepth_tpu_torch.parallel.run_steps --data 2 --spatial 2 \\
        --device cpu --spawn --out OUT [--steps 2] [--reference [--save-grads]] [--f64] \\
        [--threads N] \\
        [config flags, e.g. --height 32 --width 128 --batch 4]
    # or under torchrun, one process per card
    torchrun --nproc_per_node 4 -m monodepth_tpu_torch.parallel.run_steps \\
        --data 2 --spatial 2 --out OUT

Counterpart of the JAX package's multi-process worker
(tests/distributed_worker.py). Each rank joins the group
(`init_distributed`), builds the mesh, builds the model from `cfg.seed`,
broadcasts rank 0's state, and runs `--steps` train steps and one eval
step on `make_planar_scenes` batches (ground truth depth drawn from the
seed), each rank on its piece (`shard_batch`). It writes OUT/rank<r>.json:
the losses, the last train and the eval metrics, per-module gradient
norms after the first step, a parameter checksum, the launches of K1, K2,
both forms of K3 and K1-bwd (`grid_vjp`), and the spatial warps on slabs
and fallbacks.

With `--reference`, once every rank has left the process group, rank 0
runs the same steps on one device on the global batches, and the eval
step from the mesh's trained state, and adds the differences and the
seconds they took (`reference_seconds`) to its report: loss and
per-module gradient (rel-L2 after the first step), parameters and
batch-norm running statistics (max abs after the last step), eval loss
and depth metrics. `--f64` runs the model and the batches in float64
(the CPU tests), where those differences are rounding only. `--save-grads` keeps both runs' first-step gradients in
OUT/grads.pt, so that runs in two precisions can be compared.
"""

from __future__ import annotations

import argparse
import copy
import json
import multiprocessing
import os
import socket
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from monodepth_tpu_torch.config import Config, options
from monodepth_tpu_torch.data.synthetic import make_planar_scenes
from monodepth_tpu_torch.ops.cuda import warp_sample as ws
from monodepth_tpu_torch.parallel.mesh import (
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
    warm_collectives,
)
from monodepth_tpu_torch.training.state import (
    build_model,
    create_state,
    module_grads,
)
from monodepth_tpu_torch.training.step import (
    local_warp,
    make_eval_step,
    make_train_step,
    spatial_fallback,
)

STEPS_PER_EPOCH = 100  # the learning rate stays at its first value
KERNELS = {"warp_sample_fwd": ws.warp_sample,
           "warp_sample_fwd_grads": ws.warp_sample_grads,
           "warp_sample_fwd_shifted": ws.warp_sample_shifted,
           "warp_sample_fwd_grads_shifted": ws.warp_sample_grads_shifted,
           "warp_sample_bwd_grid": ws.grid_vjp}


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _child(target: Callable, rank: int, world: int, port: int, arg) -> None:
    os.environ.update({"RANK": str(rank), "LOCAL_RANK": str(rank),
                       "WORLD_SIZE": str(world), "MASTER_ADDR": "localhost",
                       "MASTER_PORT": str(port)})
    # the ranks share the host's cores (torchrun gives each one thread)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    target(arg)


def spawn(target: Callable, world: int, arg, deadline_s: float) -> List[int]:
    """Run target(arg) in `world` fresh processes, each with torchrun's
    environment for its rank on localhost. Waits at most `deadline_s`
    seconds; when a rank fails or time runs out, stops the others.
    Returns the exit codes (None for a rank that was stopped)."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_child, args=(target, r, world, port, arg))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    try:
        while time.monotonic() < end:
            codes = [p.exitcode for p in procs]
            if all(c is not None for c in codes) or any(c for c in codes):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    return [p.exitcode for p in procs]


def host_batches(cfg: Config, n: int, dtype) -> List[Dict[str, np.ndarray]]:
    """`n` global batches of `make_planar_scenes` from `cfg.seed`, with
    sparse ground truth depth [B, 375, 1242]; float fields in `dtype`."""
    B = cfg.batch
    scenes = make_planar_scenes(n * B, cfg.height, cfg.width, seed=cfg.seed)
    rng = np.random.default_rng(cfg.seed)
    out = []
    for i in range(n):
        items = slice(i * B, (i + 1) * B)
        gt = rng.uniform(0, 80, (B, 375, 1242))
        gt = (gt * (rng.random(gt.shape) < 0.05)).astype(np.float32)
        out.append({"frames": scenes["frames"][items],
                    "jitter": scenes["jitter"][items].astype(dtype),
                    "K": scenes["K"][items].astype(dtype),
                    "inv_K": scenes["inv_K"][items].astype(dtype),
                    "depth_gt": gt})
    return out


def _fresh_state(cfg: Config, device, f64: bool):
    model = build_model(cfg, device=device)
    if f64:
        model.double()
    return create_state(cfg, model, steps_per_epoch=STEPS_PER_EPOCH)


def _floats(metrics) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else abs(a - b)


def _reference(cfg: Config, args, batches, mesh_report: dict,
               mesh_grads: Dict[str, torch.Tensor], mesh_model, device,
               model):
    """The same steps on one device from `model` (a copy of the initial
    model) on the global batches -> (the one device's gradients after the
    first step by module, the differences from the mesh's run)."""
    state = create_state(cfg, model, steps_per_epoch=STEPS_PER_EPOCH)
    step = make_train_step(model, cfg, device=device)
    losses, grads = [], None
    for i in range(args.steps):
        losses.append(float(step(state, batches[i])["loss"]))
        if i == 0:
            grads = module_grads(model)
    mesh_sd, ref_sd = mesh_model.state_dict(), model.state_dict()
    params = max(float((p.detach() - ref_sd[n]).abs().max())
                 for n, p in mesh_model.named_parameters())
    stats = max(float((v - ref_sd[k]).abs().max()) for k, v in mesh_sd.items()
                if "running" in k)
    # the eval step from the mesh's trained state: only the step differs
    model.load_state_dict(mesh_sd)
    ev = _floats(make_eval_step(model, cfg, device=device)(state, batches[-1], 0))
    mesh_ev = mesh_report["eval"]
    return grads, {
        "losses": losses,
        "loss_rel": [_rel(a, b) for a, b in zip(mesh_report["losses"], losses)],
        "grad_rel_l2": {m: float((mesh_grads[m] - grads[m]).norm() / grads[m].norm())
                        for m in grads},
        "param_max_abs": params,
        "bn_stats_max_abs": stats,
        "eval": ev,
        "eval_rel": {k: _rel(mesh_ev[k], v) for k, v in ev.items()
                     if k != "warp_span"},
    }


def run_rank(args) -> None:
    """One rank's run (module docstring); writes OUT/rank<r>.json."""
    cfg = options(args.config)
    if args.threads:
        torch.set_num_threads(args.threads)
    init_distributed(args.device, args.timeout)
    mesh = make_mesh(args.data, args.spatial, args.device)
    world = warm_collectives(mesh)
    device = mesh.device
    dtype = np.float64 if args.f64 else np.float32
    state = _fresh_state(cfg, device, args.f64)
    model = state.model
    replicate(mesh, state)
    initial = copy.deepcopy(model) if args.reference and mesh.rank == 0 else None
    batches = host_batches(cfg, args.steps + 1, dtype)
    train_step = make_train_step(model, cfg, mesh=mesh)
    eval_step = make_eval_step(model, cfg, mesh=mesh)

    for fn in KERNELS.values():
        fn.launches = 0
    local_warp.calls = spatial_fallback.calls = 0
    t0 = time.perf_counter()
    losses, grads, train_metrics = [], None, {}
    for i in range(args.steps):
        train_metrics = _floats(train_step(state, shard_batch(mesh, batches[i])))
        losses.append(train_metrics["loss"])
        if i == 0:
            grads = module_grads(model)
    ev = _floats(eval_step(state, shard_batch(mesh, batches[-1]), 0))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    report = {
        "rank": mesh.rank, "mesh": mesh.shape, "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "world_on_device": world, "losses": losses,
        "train_metrics": train_metrics, "eval": ev,
        "grad_norms": {m: float(g.norm()) for m, g in grads.items()},
        "param_checksum": float(sum(p.detach().double().sum()
                                    for p in model.parameters())),
        "launches": {name: fn.launches for name, fn in KERNELS.items()},
        "slab_warps": local_warp.calls, "fallbacks": spatial_fallback.calls,
        "seconds": seconds,
    }
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    # every rank leaves the group before rank 0's reference, which takes no
    # collective: no rank waits on one while it runs
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    if args.reference and mesh.rank == 0:
        t0 = time.perf_counter()
        one_device, report["reference"] = _reference(
            cfg, args, batches, report, grads, model, device, initial)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        report["reference_seconds"] = time.perf_counter() - t0
        if args.save_grads:
            torch.save({k: {m: g.float().cpu() for m, g in v.items()}
                        for k, v in (("mesh", grads), ("one_device", one_device))},
                       out / "grads.pt")
    (out / f"rank{mesh.rank}.json").write_text(json.dumps(report, indent=1))


def parse(argv: Sequence[str] | None = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", type=int, default=0)
    p.add_argument("--spatial", type=int, default=1)
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--out", required=True)
    p.add_argument("--spawn", action="store_true",
                   help="start data x spatial processes here (else: torchrun's, "
                        "or one)")
    p.add_argument("--reference", action="store_true")
    p.add_argument("--f64", action="store_true")
    p.add_argument("--save-grads", action="store_true",
                   help="with --reference: rank 0 also writes OUT/grads.pt, the "
                        "mesh's and the one device's first-step gradients by "
                        "module (f32), to compare runs in other precisions")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds a collective may wait")
    p.add_argument("--deadline", type=float, default=1800.0,
                   help="seconds the spawned ranks may take in all")
    p.add_argument("--threads", type=int, default=0,
                   help="intra-op threads of each rank (0: cpu_count // ranks "
                        "under --spawn, torch's default otherwise)")
    args, config = p.parse_known_args(argv)
    args.config = config
    return args


def main(argv: Sequence[str] | None = None) -> int:
    args = parse(argv)
    if not args.spawn:
        run_rank(args)
        return 0
    if args.data < 1:
        raise SystemExit("--spawn needs --data >= 1")
    codes = spawn(run_rank, args.data * args.spatial, args, args.deadline)
    if any(c != 0 for c in codes):
        print(f"run_steps: rank exit codes {codes}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
