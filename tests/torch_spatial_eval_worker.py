"""The port's eval step on a {spatial: 2} mesh of two CPU processes
(gloo), for tests/test_torch_rows_jax.py. Imports no jax.

    python tests/torch_spatial_eval_worker.py INPUTS.pt OUT_DIR

INPUTS.pt holds the config's fields (`cfg`), a model's `state_dict`, a
global `batch` (numpy arrays), its tie-break `noise` ({scale: tensor}),
the state's `step` and the batch's `index`. Each rank runs the eval step
on its rows of the batch and writes its metrics to OUT_DIR/rank<r>.json."""

import json
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.parallel import init_distributed, make_mesh, shard_batch
from monodepth_tpu_torch.parallel.run_steps import spawn
from monodepth_tpu_torch.training.state import build_model, create_state
from monodepth_tpu_torch.training.step import make_eval_step, spatial_fallback


def run(paths) -> None:
    inputs, out_dir = paths
    init_distributed("cpu", timeout_s=60)
    torch.set_num_threads(1)
    mesh = make_mesh(1, 2, "cpu")
    data = torch.load(inputs, weights_only=False)
    cfg = Config(**data["cfg"])
    model = build_model(cfg, device="cpu")
    model.load_state_dict(data["state_dict"])
    state = create_state(cfg, model)
    state.step = data["step"]
    metrics = make_eval_step(model, cfg, mesh=mesh)(
        state, shard_batch(mesh, data["batch"]), data["index"], noise=data["noise"])
    report = {k: float(v) for k, v in metrics.items()}
    report["fallbacks"] = spatial_fallback.calls
    (Path(out_dir) / f"rank{mesh.rank}.json").write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    codes = spawn(run, 2, (sys.argv[1], sys.argv[2]), deadline_s=600)
    sys.exit(0 if codes == [0, 0] else 1)
