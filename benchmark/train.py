"""The `train` traffic: a closed loop over the port's captured train step.

Set-up builds one train step (the configuration's family's `port`: for
Monodepth2 `make_train_step(model, cfg)`, the step the Trainer calls, a
CUDA graph on a card) with its model and Adam state from the seed, and
the family's ring of distinct batches and per-step noises on the
device: the steady state of a run whose loader keeps the next batch on
the card. Its first three calls, on the first three batches of the ring,
are the warm-up, the capture and a replay; the state they leave is the
one the window trains on. The window dispatches step after step with no
host sync, then drains the device once: every step dispatched counts, and
the window lasts until the drain.

On several cards the ranks form a `{data: n}` mesh over NCCL (the port's
`init_distributed`, `make_mesh`, `replicate`), each rank holding `batch`
items of an n times larger global batch, and every rank runs the same
number of steps: set-up times three more steps, and the ranks agree on the
count that fills the window at the slowest rank's pace.

The check follows those first three steps with the family's reference
(f32, TF32 off), from the same weights, global batches and noise, and
takes the second step again from the weights the program held after its
first, on rank 0 once the ranks have left the process group. Everything
that depends on the model comes from the family (`families/`).
"""

from __future__ import annotations

import dataclasses
import math
import time
from types import ModuleType
from typing import Dict, List

import torch

from benchmark import check, families, scenes, weights
from benchmark.manifest import Cell

Tensor = torch.Tensor
WARM_STEPS = 3
PACE_STEPS = 3


def _host(tensors: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Float32 copies on the host (a copy also where the tensors are there
    already: the window goes on updating them)."""
    return {k: v.detach().to("cpu", torch.float32, copy=True) for k, v in tensors.items()}


def exact_matmuls() -> None:
    """TF32 off: float32 products in float32, as the reference runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class Setup:
    family: ModuleType                # the configuration's (`families/`)
    conf: dict                        # the configuration file's fields
    state_dict: Dict[str, Tensor]     # the seeded weights (on the host once made)
    batches: List[Dict[str, Tensor]]  # the global ring, on the device
    noises: List[Dict[int, Tensor]]   # the global batches' noise
    pieces: List[Dict[str, Tensor]]   # this rank's items of each batch
    step: object = None
    state: object = None


def inputs(cell: Cell, seed: int, device, ranks: int = 1) -> Setup:
    """The seeded weights and the ring of global batches (`ranks` times the
    configuration's batch) and their noise."""
    conf, traffic = cell.config, cell.traffic
    if traffic["ring"] < WARM_STEPS:
        raise ValueError(f"a train ring holds at least {WARM_STEPS} batches")
    family = families.load(cell.family)
    sd = weights.seeded_state_dict(family, conf, scenes.generator(seed, 0, device), device)
    batches, noises = family.inputs(conf, traffic, seed, conf["batch"] * ranks, device)
    return Setup(family, conf, sd, batches, noises, batches)


def make(cell: Cell, seed: int, device, mesh=None) -> Setup:
    """`inputs` and the program's train step with its model and Adam state
    (on `mesh`, this rank's, with its items of each batch)."""
    s = inputs(cell, seed, device, 1 if mesh is None else mesh.size)
    if mesh is not None:
        from monodepth_tpu_torch.parallel.mesh import shard_batch
        s.pieces = [shard_batch(mesh, b) for b in s.batches]
    s.state, s.step = s.family.port(s.conf, s.state_dict, device, mesh,
                                    cell.traffic["steps_per_epoch"])
    s.state_dict = {k: v.to("cpu", copy=True) for k, v in s.state_dict.items()}
    return s


def first_steps(s: Setup) -> check.Steps:
    """The first WARM_STEPS calls, through the window's own call; what the
    check reads of them. The first call's finest disparity is read by a
    hook on the family's `disparity_module`, removed before the second
    call captures."""
    model = s.state.model
    finest = min(s.conf["scales"])
    beta1 = s.family.reference.ADAM[0]
    disp1 = []
    hook = s.family.disparity_module(model).register_forward_hook(
        lambda module, args, out: disp1.append(out[finest].detach().float().clone()))
    losses, firsts = [], []
    for k in range(WARM_STEPS):
        losses.append(s.step(s.state, s.pieces[k], s.noises[k])["loss"])
        if k == 0:
            hook.remove()
            params1 = _host(dict(model.named_parameters()))
        if k < 2:
            # Adam's first moment; a step that never reached Adam has none
            moments = s.state.optimizer.state
            firsts.append(_host({n: moments[p]["exp_avg"] if p in moments
                                 else torch.zeros_like(p) for n, p in model.named_parameters()}))
    # after step k it is beta1·(after step k - 1) + (1 - beta1)·gradient k
    m1, m2 = firsts
    return check.Steps(
        losses=[float(v) for v in losses],
        grad1={n: m / (1 - beta1) for n, m in m1.items()},
        grad2={n: (m2[n].double() - beta1 * m.double()) / (1 - beta1) for n, m in m1.items()},
        params=_host(dict(model.named_parameters())),
        stats=_host({n: b for n, b in model.named_buffers()
                     if n.endswith(("running_mean", "running_var"))}),
        disp1=disp1[0].cpu(),
        params1=params1)


def reference_steps(s: Setup, numerics, device,
                    items: slice = slice(None), ring=range(WARM_STEPS), rates=None):
    """The reference's first WARM_STEPS steps (its `Trajectory`) in the
    arithmetic `numerics`, from the same weights on the same global
    batches and noise: those of the ring's `ring`, on `items` of each, at
    the configuration's rate or `rates`, one a step."""
    reference = s.family.reference
    model = reference.build(s.conf, numerics, device)
    model.load_state_dict({k: v.to(device) for k, v in s.state_dict.items()})
    cut = lambda d: {k: v[items] for k, v in d.items()}  # noqa: E731
    return reference.train_steps(
        model, s.conf, [cut(s.batches[i]) for i in ring], [cut(s.noises[i]) for i in ring],
        s.conf["learning_rate"] if rates is None else rates)


def reference_replay(s: Setup, params1: Dict[str, Tensor], device):
    """The reference's second step (f32) from `params1`, the weights after
    a first step: (loss, {leaf: gradient}) on the ring's second global
    batch and its noise."""
    reference = s.family.reference
    model = reference.build(s.conf, reference.F32, device)
    weights = dict(s.state_dict, **params1)
    model.load_state_dict({k: v.to(device) for k, v in weights.items()})
    return reference.loss_and_grads(model, s.conf, s.batches[1], s.noises[1])


def join_mesh(device_type: str):
    """This rank's `{data: n}` mesh over every rank of the run (the
    rendezvous in the environment: `ranks.spawn`)."""
    from monodepth_tpu_torch.parallel.mesh import init_distributed, make_mesh, warm_collectives

    init_distributed(device_type, timeout_s=300.0)
    mesh = make_mesh(0, 1, device_type)
    warm_collectives(mesh)
    return mesh


def _agree(mesh, values, op) -> List[float]:
    import torch.distributed as dist

    t = torch.tensor(values, dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, op=op)
    return t.tolist()


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
        fault=None) -> dict | None:
    """One run: set-up, the window, the traced window with --trace 1, then
    the check. `fault(setup)` breaks the step underneath (the CPU tests).
    On several cards every rank runs this, and rank 0 returns the result;
    the others return None."""
    import torch.distributed as dist

    mesh = join_mesh(torch.device(device).type) if cell.chips > 1 else None
    device = torch.device(device) if mesh is None else mesh.device
    s = make(cell, seed, device, mesh)
    if fault is not None:
        fault(s)
    first = first_steps(s)
    ring = len(s.pieces)
    call = lambda i: s.step(s.state, s.pieces[i % ring], s.noises[i % ring])  # noqa: E731
    done, calls = WARM_STEPS, None
    if mesh is not None:
        sync(device)
        start = time.perf_counter()
        for i in range(PACE_STEPS):
            call(done + i)
        sync(device)
        done += PACE_STEPS
        pace, = _agree(mesh, [(time.perf_counter() - start) / PACE_STEPS],
                       dist.ReduceOp.MAX)
        calls = max(1, math.ceil(seconds / pace))
    sync(device)
    setup_s = time.time() - t0

    start = time.perf_counter()
    n = 0
    while n < calls if calls is not None else time.perf_counter() - start < seconds:
        call(done + n)
        n += 1
    sync(device)
    window_s = time.perf_counter() - start
    B = s.pieces[0]["frames"].shape[0]
    out = {"attempted": n, "window_s": window_s, "setup_s": setup_s,
           "flops_per_call": s.family.train_step_flops(s.conf, B),
           "warp_bytes_per_call": s.family.warp_train_bytes(s.conf, B)}
    if trace:
        from benchmark.trace import capture
        out["trace"] = capture(call, cell.traffic["trace_calls"])
        out["busy_s"] = out["trace"].busy_s
    out["memory_peak_bytes"] = peak_bytes(device)
    del call
    s.step = s.state = None
    free(device)
    if mesh is not None:
        out["window_s"], peak = _agree(
            mesh, [window_s, out["memory_peak_bytes"]], dist.ReduceOp.MAX)
        out["memory_peak_bytes"] = int(peak)
        if trace:
            out["busy_s"] = _agree(mesh, [out["busy_s"]], dist.ReduceOp.SUM)[0] / mesh.size
        # the step's graphs hold NCCL collectives: freed above, before the group
        dist.barrier()
        dist.destroy_process_group()
        if mesh.rank != 0:
            return None
    out["metrics"] = {"train_img_per_s": n * s.batches[0]["frames"].shape[0] / out["window_s"],
                      "setup_s": setup_s}

    exact_matmuls()
    traj = reference_steps(s, s.family.reference.F32, device)
    replay = reference_replay(s, first.params1, device)
    out["checks"] = check.train_numbers(first, traj, s.state_dict, replay)
    return out


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device)


def free(device) -> None:
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
