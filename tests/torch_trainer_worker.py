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
`--stop_rank R`, rank R sends itself SIGTERM in its first train pass."""

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


def main(argv) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("out")
    p.add_argument("--stop_rank", type=int, default=-1)
    args, rest = p.parse_known_args(argv)
    torch.set_num_threads(1)
    init_distributed("cpu", timeout_s=60)
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = options(rest)
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
              "local_batch": trainer.train_loader.local_batch}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
