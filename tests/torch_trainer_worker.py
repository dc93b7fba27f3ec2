"""One rank of the port's Trainer on a process mesh on the CPU (gloo), for
tests/test_torch_trainer_mesh.py. Imports no jax. Run under torchrun:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/torch_trainer_worker.py OUT_DIR [--stop_rank R] [config flags]

Each rank joins the group (`init_distributed`, 60 s collective timeout),
checks that a `--data_parallel` the world does not fit raises, trains
`Trainer(options(config flags), device="cpu")` and writes
OUT_DIR/rank<r>.json: the loss of every train step, how often it wrote a
state (`torch.save`), a module export (`save_npz`), a metrics record and
the curves, the epoch it stopped after and its state's step. With
`--stop_rank R`, rank R sends itself SIGTERM in its first train pass.
With `--graph_body`, each rank first runs 2 train steps of the body that
a captured `{data: n}` step captures (`_train_calls` on `_train_inputs`:
the global batch's noise drawn ahead and cut to the rank's items), run
eagerly, beside 2 eager mesh steps from the same init, and reports both
runs' losses and the largest difference of their states ("graph_body")."""

import argparse
import dataclasses
import json
import os
import signal
import sys

import torch
import torch.distributed as dist

from monodepth_tpu_torch.config import options
from monodepth_tpu_torch.parallel import init_distributed
from monodepth_tpu_torch.training import checkpoint as checkpoint_module
from monodepth_tpu_torch.training.loop import Trainer


def graph_body_run(cfg, world: int) -> dict:
    """`--graph_body` (module docstring). The host Adam takes the
    schedule's float rate, so the body's rate input is None here, as the
    eager step passes it; on a card both write the same value into Adam's
    f32 rate tensor."""
    from monodepth_tpu_torch.data.synthetic import make_planar_scenes
    from monodepth_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from monodepth_tpu_torch.training import step as step_module
    from monodepth_tpu_torch.training.state import build_model, create_state

    mesh = make_mesh(world, 1, "cpu")
    B = cfg.batch
    scenes = make_planar_scenes(2 * B, cfg.height, cfg.width, seed=7)
    batches = [shard_batch(mesh, {k: scenes[k][i * B:(i + 1) * B]
                                  for k in ("frames", "jitter", "K", "inv_K")})
               for i in range(2)]
    eager_state, body_state = (create_state(cfg, build_model(cfg, "cpu"), steps_per_epoch=1)
                               for _ in range(2))
    eager = step_module.make_train_step(eager_state.model, cfg, mesh=mesh, graph=False)
    run = step_module._train_runner(body_state.model, cfg, mesh.device, None, mesh)
    out = {"eager_losses": [], "body_losses": [], "noise_items": []}
    for batch in batches:
        out["eager_losses"].append(float(eager(eager_state, batch)["loss"]))
        inputs = step_module._train_inputs(cfg, body_state, [batch], None, mesh.device, mesh)
        inputs["lr"] = [None]
        out["noise_items"].append([int(v.shape[0]) for v in inputs["noise"][0].values()])
        metrics = step_module._train_calls(run, body_state, inputs)[0]
        out["body_losses"].append(float(metrics["loss"]))
    diffs = [float((a - b).abs().max()) for a, b in zip(
        eager_state.model.state_dict().values(), body_state.model.state_dict().values())]
    ea, eb = (s.optimizer.state_dict()["state"] for s in (eager_state, body_state))
    diffs += [float((ea[i][k] - eb[i][k]).abs().max()) for i in ea for k in ea[i]]
    out["state_max_abs_diff"] = max(diffs)
    out["steps"] = [eager_state.step, body_state.step]
    return out


def main(argv) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("out")
    p.add_argument("--stop_rank", type=int, default=-1)
    p.add_argument("--graph_body", action="store_true")
    args, rest = p.parse_known_args(argv)
    torch.set_num_threads(1)
    init_distributed("cpu", timeout_s=60)
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = options(rest)
    graph_body = graph_body_run(cfg, world) if args.graph_body else None
    try:
        Trainer(dataclasses.replace(cfg, data_parallel=world + 1), device="cpu")
        raise SystemExit("--data_parallel world + 1 did not raise")
    except ValueError as exc:
        misfit = str(exc)

    writes = {"state": 0, "export": 0, "record": 0, "curves": 0}

    def counting(key, fn):
        def wrapper(*a, **kw):
            writes[key] += 1
            return fn(*a, **kw)
        return wrapper

    checkpoint_module.torch.save = counting("state", torch.save)
    checkpoint_module.save_npz = counting("export", checkpoint_module.save_npz)
    trainer = Trainer(cfg, device="cpu")
    trainer._append_jsonl = counting("record", trainer._append_jsonl)
    trainer._save_curves = counting("curves", trainer._save_curves)
    losses, epochs = [], []
    step, epoch = trainer.train_step, trainer._epoch

    def recorded_step(state, batch):
        metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        return metrics

    def signalled_epoch(e, training):
        if training:
            epochs.append(e)
            if rank == args.stop_rank and e == trainer.start_epoch:
                os.kill(os.getpid(), signal.SIGTERM)
        return epoch(e, training)

    trainer.train_step, trainer._epoch = recorded_step, signalled_epoch
    trainer.train()
    report = {"rank": rank, "world": world, "losses": losses, "epochs": epochs,
              "writes": writes, "step": trainer.state.step, "misfit": misfit,
              "local_batch": trainer.train_loader.local_batch, "graph_body": graph_body}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
